"""Structured metrics logging (JSONL).

Twin: ``unity_raytracer_tpu/utils/logging.py`` (``MetricsLogger``,
``read_jsonl``), copied: it is pure Python. Every loop can emit
machine-readable records: one JSON object per line, append-only, safe to
tail.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Optional


class MetricsLogger:
    """Append-only JSONL metrics; optionally mirrors to stderr."""

    def __init__(self, path: Optional[str] = None, mirror: bool = False):
        self._path = Path(path) if path else None
        self._mirror = mirror
        if self._path:
            self._path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields: Any) -> dict:
        rec = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(rec, default=float)
        if self._path:
            with self._path.open("a") as f:
                f.write(line + "\n")
        if self._mirror:
            print(line, file=sys.stderr)
        return rec


def read_jsonl(path) -> list:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
