"""Checkpoint / resume for the fitting loop: one atomic ``.npz``.

Twin: ``unity_raytracer_tpu/utils/checkpoint.py:20-60``. The twin pickles
JAX tree definitions beside the leaves, which is no format for this
package; here the file holds plain arrays by name and no pickle:

* ``step``: the step count;
* ``param/<name>``: each parameter;
* ``adam/count``, ``adam/exp_avg/<name>``, ``adam/exp_avg_sq/<name>``:
  the ``torch.optim.Adam`` state (one step count, as optax keeps it), when
  an optimizer was given.

It is written to ``<path stem>.tmp.npz`` and then renamed over ``path``,
so a reader sees the old file or the new one, never half of one.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def save_checkpoint(path, step: int, params: Dict[str, torch.Tensor],
                    optimizer: Optional[torch.optim.Adam] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"step": np.asarray(step)}
    for k, v in params.items():
        payload[f"param/{k}"] = v.detach().cpu().numpy()
    if optimizer is not None:
        for k, v in params.items():
            st = optimizer.state.get(v)
            if not st:
                continue
            payload["adam/count"] = np.asarray(int(st["step"]))
            payload[f"adam/exp_avg/{k}"] = st["exp_avg"].cpu().numpy()
            payload[f"adam/exp_avg_sq/{k}"] = st["exp_avg_sq"].cpu().numpy()
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **payload)
    tmp.replace(path)  # atomic publish


def load_checkpoint(path) -> Tuple[int, Dict[str, np.ndarray],
                                   Optional[Tuple[int, dict, dict]]]:
    """Returns ``(step, params, adam)`` with ``params`` {name: array} and
    ``adam`` = ``(count, exp_avg, exp_avg_sq)`` by name, or None when the
    file holds no optimizer state (``models/convert.py`` turns both into
    tensors and an Adam state)."""
    with np.load(Path(path), allow_pickle=False) as z:
        step = int(z["step"])
        params = {k[len("param/"):]: z[k] for k in z.files
                  if k.startswith("param/")}
        adam = None
        if "adam/count" in z.files:
            adam = (int(z["adam/count"]),
                    {k: z[f"adam/exp_avg/{k}"] for k in params},
                    {k: z[f"adam/exp_avg_sq/{k}"] for k in params})
    return step, params, adam
