"""CLI: the ``render``, ``bench``, ``fit`` and ``dryrun`` subcommands.

Twin: ``unity_raytracer_tpu/__main__.py`` — ``cmd_render`` (``:20-53``),
``cmd_bench`` (``:56-60``, arguments ``:166-169``), ``cmd_fit``
(``:63-134``, arguments ``:171-185``) and ``cmd_dryrun`` (``:137-147``,
``:187-190``). Usage::

    python -m unity_raytracer_tpu_torch render --preset mesh100k --out f.png
    python -m unity_raytracer_tpu_torch render --preset mesh100k \
        --kernel mega --out f.png
    python -m unity_raytracer_tpu_torch render --preset cornell_box \
        --kernel mega --out c.png
    python -m unity_raytracer_tpu_torch fit --preset mesh10k --replay \\
        --size 64 --steps 50 --out-dir fit/

    python -m unity_raytracer_tpu_torch fit --size 48 --steps 300
    python -m unity_raytracer_tpu_torch fit --preset mesh10k \
        --params mesh_positions --size 64 --steps 50 --lr 0.005
    python -m unity_raytracer_tpu_torch dryrun
    python -m unity_raytracer_tpu_torch dryrun --device cpu --devices 4
    python -m unity_raytracer_tpu_torch bench --preset mesh100k
    python -m unity_raytracer_tpu_torch bench --preset mesh10k \
        --width 16 --height 16 --device cpu

Runs on the CUDA card (``--device`` picks another device; ``cpu`` runs the
plain PyTorch versions). Without a card the command stops and says so; it
never falls back to the CPU by itself. ``render`` takes every preset;
``--bvh`` builds the BVH the configured kernel walks, as the twin does.
A preset renders on the composed path (``kernel='auto'``, as in the twin:
the mirror chain, or the dielectric tree for ``cornell_box``);
``--kernel mega`` picks the fused segment kernel for a BVH preset and the
fused fork kernel for the tree. ``fit`` runs, as in the twin, the
``three_spheres`` toy on the composed path by default; another preset fits
on the composed path at depth 1 with chunked, rematerialized gradients
(``cornell_box`` through the composed tree), or with ``--replay`` on the
record-replay path, which needs the mirror chain: on a tree scene it
fails with the twin's ``ValueError``. ``--params mesh_positions`` (a mesh
preset, the composed path) fits the mesh's shared vertices instead of the
spheres, from a seeded start that moves every vertex along its normal by
up to a quarter of its mesh's mean edge; each step refits the BVH to the
step's mesh on the device (``ops/bvh.refit``). ``dryrun`` (the twin's ``:137-147``)
runs the multi-device dry run (``parallel/dryrun.py``): one NCCL process
per visible card, or ``--devices N`` gloo processes with ``--device
cpu``. ``bench`` runs the port's harness (``bench.py`` in this package,
the twin of the repo-root ``bench.py``), with the twin's ``--preset`` and
``--all`` and the rest of that harness's arguments; it prints one JSON
line.
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
    if args.kernel:
        cfg = cfg.with_(kernel=args.kernel)
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    # the BVH the configured kernel walks (ops/bvh.prepare_bvh)
    bvh = bvhmod.prepare_bvh(scene, cfg) if cfg.use_bvh else None
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


def fit_setup(preset: str, width: int, height: int, replay: bool, device):
    """The twin's ``cmd_fit`` set-up (``:73-104``, where width = height =
    ``--size``): ``(scene, cam, cfg, bvh, target, replay)``.
    ``three_spheres`` is the toy: brute force, depth 0, a close-up FOV
    camera, the composed path (``replay`` is ignored). Another preset with
    ``replay`` gets the fused kernel's BVH at full depth; without it,
    depth 1 with chunked (pixels / 4 rays) and rematerialized composed
    gradients. The target is the render at the true parameters (the
    replay's with the fused kernel it records with, the composed one
    chunked, as in the twin)."""
    from unity_raytracer_tpu_torch.models.camera import Camera
    from unity_raytracer_tpu_torch.models.presets import (
        get_preset, three_spheres)
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.render import render, resolve_mode

    if preset == "three_spheres":
        if replay:
            print("fit: --replay is ignored for the three_spheres toy "
                  "config (brute force, no fused-kernel BVH) — using the "
                  "composed gradient path", file=sys.stderr)
        scene, _, cfg = three_spheres(width=width, height=height,
                                      device=device)
        cfg = resolve_mode(scene, cfg.with_(max_bounces=0))
        cam = Camera.from_fov(position=(0, 5, 6), look_at=(0, 2.5, 26),
                              fov_y_deg=40.0, width=width, height=height,
                              device=device)
        return scene, cam, cfg, None, render(scene, cam, cfg), False
    scene, cam, cfg = get_preset(preset, width=width, height=height,
                                 device=device)
    if replay:
        cfg = resolve_mode(scene, cfg.with_(use_bvh=True, kernel="mega"))
        bvh = bvhmod.prepare_bvh(scene, cfg)
        return scene, cam, cfg, bvh, render(scene, cam, cfg, bvh=bvh), True
    cfg = resolve_mode(scene, cfg.with_(
        max_bounces=min(cfg.max_bounces, 1),
        ray_chunk=width * height // 4 or None, remat=True))
    bvh = bvhmod.prepare_bvh(scene, cfg) if cfg.use_bvh else None
    return scene, cam, cfg, bvh, render(scene, cam, cfg, bvh=bvh), False


def mesh_start(scene, seed: int, share: float = 0.25):
    """The shared vertices of ``scene``'s meshes, each moved along its
    vertex normal (the normalised sum of its faces' stored normals) by a
    draw uniform in +-``share`` of its mesh's mean edge, from ``seed``."""
    import numpy as np
    import torch

    m = scene.meshes
    pos = m.positions.detach().cpu().numpy().astype(np.float64)
    faces = m.faces.cpu().numpy()
    valid = m.valid.cpu().numpy()
    f = faces[valid]
    nrm = np.zeros_like(pos)
    np.add.at(nrm, f.reshape(-1), np.repeat(
        m.normals.cpu().numpy()[valid], 3, axis=0))
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    edge = np.linalg.norm(pos[f] - pos[np.roll(f, 1, axis=1)], axis=-1)
    mid = m.mesh_id.cpu().numpy()[valid]
    mean = np.array([edge[mid == k].mean() if (mid == k).any() else 0.0
                     for k in range(int(mid.max(initial=0)) + 1)])
    vmesh = np.zeros(len(pos), np.int64)
    vmesh[f.reshape(-1)] = np.repeat(mid, 3)
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, len(pos))
    used = np.zeros(len(pos), bool)
    used[f.reshape(-1)] = True
    step = np.where(used, share * mean[vmesh] * u, 0.0)
    return torch.as_tensor(pos + step[:, None] * nrm, dtype=torch.float32,
                           device=m.positions.device)


def run_fit(preset: str, width: int, height: int, steps: int, lr: float,
            seed: int, device, ckpt_every: int = 0, out_dir=None,
            replay: bool = True, params: str = "spheres"):
    """``fit`` on ``preset``: ``fit_setup``, the sphere centers and
    diffuse colours perturbed from ``seed`` (the twin's ``cmd_fit``), or
    with ``params='mesh_positions'`` the mesh's shared vertices
    (``mesh_start``), then the fit. Returns ``(result, true_params,
    (scene, cam, cfg, bvh, target))``."""
    import numpy as np
    import torch

    from unity_raytracer_tpu_torch.fit import FitConfig, fit, get_params

    scene, cam, cfg, bvh, target, replay = fit_setup(preset, width, height,
                                                     replay, device)
    if params == "mesh_positions":
        if bvh is None or replay:
            raise SystemExit("fit: --params mesh_positions needs a mesh "
                             "preset on the composed path (no --replay)")
        names = ("mesh_positions",)
        true_p = get_params(scene, names)
        init = {"mesh_positions": mesh_start(scene, seed)}
    else:
        names = ("sphere_centers", "sphere_diffuse")
        true_p = get_params(scene, names)
        n_sph = true_p["sphere_centers"].shape[0]
        rng = np.random.default_rng(seed)
        noise = lambda lo, hi: torch.as_tensor(
            rng.uniform(lo, hi, (n_sph, 3)), dtype=torch.float32,
            device=device)
        init = {"sphere_centers": true_p["sphere_centers"]
                + noise(-0.4, 0.4),
                "sphere_diffuse": torch.clamp(
                    true_p["sphere_diffuse"] + noise(-0.2, 0.2), 0.0, 1.0)}
    fcfg = FitConfig(param_names=names, learning_rate=lr, steps=steps,
                     soft_shadow_temp=1.0, soft_hit_temp=0.1,
                     log_every=max(steps // 10, 1),
                     checkpoint_every=ckpt_every,
                     checkpoint_path=(f"{out_dir}/fit.npz" if out_dir
                                      else None),
                     use_replay=replay)
    res = fit(scene, cam, cfg, target, fcfg, init_params=init, bvh=bvh)
    return res, true_p, (scene, cam, cfg, bvh, target)


def cmd_fit(args):
    from unity_raytracer_tpu_torch.ops.render import render
    from unity_raytracer_tpu_torch.utils import image as imgutil

    device = _device(args)
    res, true_p, (_, cam, cfg, bvh, target) = run_fit(
        args.preset, args.size, args.size, args.steps, args.lr, args.seed,
        device, args.ckpt_every, args.out_dir, replay=args.replay,
        params=args.params)
    key = ("vertex_err" if args.params == "mesh_positions"
           else "center_err")
    name = "mesh_positions" if key == "vertex_err" else "sphere_centers"
    err = (res.params[name] - true_p[name]).abs().max()
    print(json.dumps({"final_loss": float(res.losses[-1]),
                      "loss_ratio": float(res.losses[-1] / res.losses[0]),
                      key: float(err)}))
    if args.out_dir:
        if args.params == "mesh_positions":
            from unity_raytracer_tpu_torch.ops.bvh import refit
            bvh, _ = refit(bvh, res.scene)
        final = render(res.scene, cam, cfg, bvh=bvh).cpu().numpy()
        imgutil.write_png(f"{args.out_dir}/recovered.png", final)
        imgutil.write_png(f"{args.out_dir}/target.png",
                          target.cpu().numpy())


def cmd_bench(args):
    """The port's benchmark harness (``bench.run``); ``--virtual`` runs on
    the CPU."""
    import torch

    from unity_raytracer_tpu_torch import bench

    bench.run(args, torch.device("cpu") if args.virtual else _device(args))


def cmd_dryrun(args):
    """The multi-device dry run (``parallel/dryrun.py``): one NCCL process
    per card, or ``--devices`` gloo processes with ``--device cpu``."""
    import torch

    from unity_raytracer_tpu_torch.parallel.dryrun import dryrun

    device = _device(args)
    n = args.devices or (torch.cuda.device_count() if device.type == "cuda"
                         else 8)
    dryrun(n, device.type)


def main():
    from unity_raytracer_tpu_torch.ops.render import KERNELS

    ap = argparse.ArgumentParser(prog="unity_raytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dev_help = ("torch device (default: cuda; cpu runs the plain PyTorch "
                "versions)")
    r = sub.add_parser("render", help="render a preset to PNG/NPY")
    r.add_argument("--preset", default="cornell_box")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--bvh", action="store_true")
    r.add_argument("--kernel", default=None, choices=KERNELS,
                   help="route (default: the preset's, 'auto': the "
                        "composed path); 'mega' renders a BVH preset on "
                        "the fused segment kernel, a tree preset on the "
                        "fused fork kernel")
    r.add_argument("--device", default="cuda", help=dev_help)
    r.add_argument("--out", default=None)
    r.set_defaults(fn=cmd_render)

    from unity_raytracer_tpu_torch.bench import add_arguments
    b = sub.add_parser("bench", help="run the benchmark harness")
    add_arguments(b)
    b.set_defaults(fn=cmd_bench)

    f = sub.add_parser("fit", help="inverse-rendering demo (config 4)")
    f.add_argument("--preset", default="three_spheres",
                   help="scene preset; non-toy presets fit with BVH + "
                        "chunked/remat gradients at depth 1")
    f.add_argument("--size", type=int, default=48)
    f.add_argument("--steps", type=int, default=300)
    f.add_argument("--lr", type=float, default=0.02)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--ckpt-every", type=int, default=0)
    f.add_argument("--out-dir", default=None)
    f.add_argument("--replay", action="store_true",
                   help="soft record-replay gradient step (fused kernel "
                        "records + differentiable replay) at full depth")
    f.add_argument("--params", default="spheres",
                   choices=("spheres", "mesh_positions"),
                   help="what the fit recovers: the sphere centres and "
                        "diffuse colours, or the mesh's shared vertices "
                        "(a mesh preset on the composed path; each step "
                        "refits the BVH to the step's mesh)")
    f.add_argument("--device", default="cuda", help=dev_help)
    f.set_defaults(fn=cmd_fit)

    d = sub.add_parser("dryrun", help="multi-device dry run of the "
                       "distributed step on tiny shapes")
    d.add_argument("--devices", type=int, default=None,
                   help="ranks (default: every visible card; 8 on the CPU)")
    d.add_argument("--device", default="cuda",
                   help="cuda: one NCCL process per card; cpu: gloo "
                        "processes")
    d.set_defaults(fn=cmd_dryrun)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
