"""CLI entry point: the ``render`` subcommand.

Twin: ``unity_raytracer_tpu/__main__.py:20-53`` (``cmd_render``). Usage::

    python -m unity_raytracer_tpu_torch render --preset mesh100k --out f.png

Renders on the first CUDA card when there is one (``--device`` picks
another device, ``cpu`` runs the plain PyTorch versions). The other
subcommands of the twin (``bench``, ``fit``, ``dryrun``) are ROADMAP
Queue A #14.
"""

from __future__ import annotations

import argparse
import sys
import time


def cmd_render(args):
    import torch

    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.render import (
        check_supported, render, resolve_mode)
    from unity_raytracer_tpu_torch.utils import image as imgutil

    device = torch.device(args.device or
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    kw = {}
    if args.width:
        kw["width"] = args.width
    if args.height:
        kw["height"] = args.height
    scene, cam, cfg = get_preset(args.preset, device=device, **kw)
    if args.depth is not None:
        cfg = cfg.with_(max_bounces=args.depth)
    if args.bvh:
        cfg = cfg.with_(use_bvh=True)
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg, device)
    t0 = time.perf_counter()
    img = render(scene, cam, cfg, bvh=bvh).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"rendered {cam.width}x{cam.height} depth={cfg.max_bounces} "
          f"on {device} in {dt:.2f}s (incl. kernel build)", file=sys.stderr)
    out = args.out or f"{args.preset}.png"
    if out.endswith(".npy"):
        imgutil.write_npy(out, img)
    else:
        imgutil.write_png(out, img)
    print(out)


def main():
    ap = argparse.ArgumentParser(prog="unity_raytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a preset to PNG/NPY")
    r.add_argument("--preset", default="mesh100k")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--bvh", action="store_true")
    r.add_argument("--device", default=None,
                   help="torch device (default: cuda if available, else "
                        "cpu)")
    r.add_argument("--out", default=None)
    r.set_defaults(fn=cmd_render)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
