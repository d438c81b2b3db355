"""CLI entry points: the ``render`` and ``fit`` subcommands.

Twin: ``unity_raytracer_tpu/__main__.py`` — ``cmd_render`` (``:20-53``) and
``cmd_fit`` (``:63-134``, arguments ``:171-185``). Usage::

    python -m unity_raytracer_tpu_torch render --preset mesh100k --out f.png
    python -m unity_raytracer_tpu_torch fit --preset mesh10k --replay \\
        --size 64 --steps 50 --out-dir fit/

Runs on the CUDA card (``--device`` picks another device; ``cpu`` runs the
plain PyTorch versions). Without a card the command stops and says so; it
never falls back to the CPU by itself. ``fit`` runs the record-replay
path only (``--replay`` on ``mesh10k`` / ``mesh100k``); the composed
gradient path and the ``three_spheres`` toy are ROADMAP Queue A #10. The
twin's ``bench`` and ``dryrun`` subcommands are Queue A #14.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _device(args):
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{args.cmd}: no CUDA card found; pass --device cpu to run "
                 f"the plain PyTorch versions on the CPU")
    return device


def cmd_render(args):
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.render import (
        check_supported, render, resolve_mode)
    from unity_raytracer_tpu_torch.utils import image as imgutil

    device = _device(args)
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
    bvh = bvhmod.prepare_bvh(scene, cfg)
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


def run_fit(preset: str, width: int, height: int, steps: int, lr: float,
            seed: int, device, ckpt_every: int = 0, out_dir=None):
    """``fit --replay`` on ``preset`` at width x height (the CLI passes
    --size for both): build the scene, its BVH and the target image
    rendered at the true parameters, perturb the sphere centers and
    diffuse colours from ``seed`` (the twin's cmd_fit), fit, and return
    ``(result, true_params, (scene, cam, cfg, bvh, target))``."""
    import numpy as np
    import torch

    from unity_raytracer_tpu_torch.fit import FitConfig, fit, get_params
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.render import render, resolve_mode

    scene, cam, cfg = get_preset(preset, width=width, height=height,
                                 device=device)
    cfg = resolve_mode(scene, cfg.with_(use_bvh=True))
    bvh = bvhmod.prepare_bvh(scene, cfg.with_(kernel="mega"))
    target = render(scene, cam, cfg, bvh=bvh)
    names = ("sphere_centers", "sphere_diffuse")
    true_p = get_params(scene, names)
    n_sph = true_p["sphere_centers"].shape[0]
    rng = np.random.default_rng(seed)
    noise = lambda lo, hi: torch.as_tensor(
        rng.uniform(lo, hi, (n_sph, 3)), dtype=torch.float32, device=device)
    init = {"sphere_centers": true_p["sphere_centers"] + noise(-0.4, 0.4),
            "sphere_diffuse": torch.clamp(
                true_p["sphere_diffuse"] + noise(-0.2, 0.2), 0.0, 1.0)}
    fcfg = FitConfig(param_names=names, learning_rate=lr, steps=steps,
                     soft_shadow_temp=1.0, soft_hit_temp=0.1,
                     log_every=max(steps // 10, 1),
                     checkpoint_every=ckpt_every,
                     checkpoint_path=(f"{out_dir}/fit.npz" if out_dir
                                      else None),
                     use_replay=True)
    res = fit(scene, cam, cfg, target, fcfg, init_params=init, bvh=bvh)
    return res, true_p, (scene, cam, cfg, bvh, target)


def cmd_fit(args):
    from unity_raytracer_tpu_torch.ops.render import render
    from unity_raytracer_tpu_torch.utils import image as imgutil

    if args.preset == "three_spheres" or not args.replay:
        raise NotImplementedError(
            "not ported to unity_raytracer_tpu_torch yet: the composed "
            "gradient path (fit without --replay, and the three_spheres "
            "toy) is #10 in ROADMAP.md Queue A; use --replay on mesh10k or "
            "mesh100k")
    device = _device(args)
    res, true_p, (_, cam, cfg, bvh, target) = run_fit(
        args.preset, args.size, args.size, args.steps, args.lr, args.seed,
        device, args.ckpt_every, args.out_dir)
    err = (res.params["sphere_centers"]
           - true_p["sphere_centers"]).abs().max()
    print(json.dumps({"final_loss": float(res.losses[-1]),
                      "loss_ratio": float(res.losses[-1] / res.losses[0]),
                      "center_err": float(err)}))
    if args.out_dir:
        final = render(res.scene, cam, cfg, bvh=bvh).cpu().numpy()
        imgutil.write_png(f"{args.out_dir}/recovered.png", final)
        imgutil.write_png(f"{args.out_dir}/target.png",
                          target.cpu().numpy())


def main():
    ap = argparse.ArgumentParser(prog="unity_raytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dev_help = ("torch device (default: cuda; cpu runs the plain PyTorch "
                "versions)")
    r = sub.add_parser("render", help="render a preset to PNG/NPY")
    r.add_argument("--preset", default="mesh100k")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--bvh", action="store_true")
    r.add_argument("--device", default="cuda", help=dev_help)
    r.add_argument("--out", default=None)
    r.set_defaults(fn=cmd_render)

    f = sub.add_parser("fit", help="inverse-rendering demo (config 4)")
    f.add_argument("--preset", default="three_spheres",
                   help="scene preset; mesh10k / mesh100k with --replay")
    f.add_argument("--size", type=int, default=48)
    f.add_argument("--steps", type=int, default=300)
    f.add_argument("--lr", type=float, default=0.02)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--ckpt-every", type=int, default=0)
    f.add_argument("--out-dir", default=None)
    f.add_argument("--replay", action="store_true",
                   help="soft record-replay gradient step (fused kernel "
                        "records + differentiable replay); the only "
                        "ported path")
    f.add_argument("--device", default="cuda", help=dev_help)
    f.set_defaults(fn=cmd_fit)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
