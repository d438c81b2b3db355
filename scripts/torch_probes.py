#!/usr/bin/env python3
"""The dispatch-cost and FP32-rate probes on a CUDA card, as JSONL.

    python3 scripts/torch_probes.py [out.jsonl]

The counterpart of the Pallas steps of ``scripts/tpu_probe2.py``
(``pallas_repblocks_tile*``, ``pallas_noblocks_tile*``,
``pallas_repblocks_tile1024_arbitrary``) and of
``scripts/tpu_r2_session.py``'s ``vpu_fma`` step, under the same step
names, on the kernels of ``csrc/probes.cu`` (``utils/probes.py``): the
dead kernels over 1920 x 1080 float32 padded to each tile, with and
without the flagship's node and triangle tables, the persistent grid in
place of the ``arbitrary`` one, and the chain of 1024 fused multiply-adds
per element over [131072, 1024] float32. The inputs are the twin's: ones,
tables of zeros. Beside each tile, ``torch_mul_tile*`` times one PyTorch
call computing ``dead_nob``'s function, ``torch.mul(x, 2.0)``, on the
same ring: the library yardstick (its ``grid`` and ``threads`` are
PyTorch's own, not recorded).

Each step is timed as the twin's ``timed(reps=6)`` was, with
``profiling.call_times``: a first launch (``compile_s``, host clock, the
library load included), warm-up launches, then 6 back-to-back launches
between two CUDA events. The host takes longer to enqueue a launch than
the card takes to run a dead kernel, so the stream is first held by a
spin kernel (``torch.cuda._sleep``, ~2.5 ms) and the 6 launches queue up
behind it: ``time_s`` is then device seconds per launch (the kernel and
the card's gap between two queued launches), and ``host_s`` the host
wall time per launch of the enqueue loop (the wrapper's checks,
allocation and ctypes call): the floor of the port's per-launch host
cost. The launches take their inputs in turn from a ring of ``RING``
copies and every output is held to the end of the loop, so each launch
reads and writes HBM: the dead kernels' ring (2 x 8 x 16.6 MB) is well
beyond the 50 MB L2, where the same ``x`` and ``o`` launched again would
be served from the L2. ``grid`` and ``threads`` are the launch's blocks
and threads per block. ``bound_s`` is the least time the card could
take (``profiling.HBM_BPS`` and ``FP32_OPS``: bytes over 3.35 TB/s for
the dead kernels, FP32 operations over 67 TFLOP/s for the chain). Each
record carries the card's name and power limit. The persistent step
also records its tiles per block (``tiles_per_block``, the most and the
fewest) and float4 words per thread (``words_per_thread``, the most).
Appends to
``out.jsonl`` (default ``build/torch_probes.jsonl``) and prints each
record. No JAX.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

REPS = 6                        # tpu_probe2.py's timed(reps=6)
RING = 8                        # input copies per step (module docstring)
HOLD_CYCLES = 5_000_000         # the spin kernel: ~2.5 ms at 1.98 GHz


def time_launches(fn, ring, reps=REPS):
    """(compile_s, device s per launch, host s per launch) of ``fn`` over
    ``ring`` (argument tuples, one per launch in turn): ``max(len(ring),
    reps)`` warm-up launches, then ``reps`` launches queued behind a spin
    kernel."""
    from unity_raytracer_tpu_torch.utils.profiling import call_times
    t = call_times(fn, reps, warmup=max(len(ring), reps), inputs=ring,
                   hold_cycles=HOLD_CYCLES)
    return t.first_s, t.mean_s, t.host_s


def dead_ring(x, tile):
    """``RING`` copies of ``x`` padded to ``tile``, as 1-tuples."""
    from unity_raytracer_tpu_torch.utils import probes
    xp = probes.padded(x, tile)
    return [(xp.clone(),) for _ in range(RING)]


def run_probes(device, emit):
    """Every step on ``device``; ``emit(record)`` per step. Returns the
    records."""
    import torch

    from unity_raytracer_tpu_torch.utils import probes
    from unity_raytracer_tpu_torch.utils.profiling import (
        FP32_OPS, HBM_BPS, nvidia_smi)

    card = nvidia_smi("name,power.limit")
    nodes, tris = (torch.zeros(s, dtype=torch.float32, device=device)
                   for s in probes.TABLE_SHAPES)
    x1 = torch.ones(probes.PROBE_N, dtype=torch.float32, device=device)
    recs = []

    def step(name, fn, ring, nbytes, ops, grid, threads, **extra):
        c, t, h = time_launches(fn, ring)
        rec = dict(step=name, compile_s=c, time_s=t, host_s=h,
                   bound_s=max(nbytes / HBM_BPS, ops / FP32_OPS), grid=grid,
                   threads=threads, ring=len(ring), card=card, **extra)
        if ops:
            rec["tflops"] = ops / t / 1e12
        recs.append(rec)
        emit(rec)

    for tile in probes.TILES:
        ring = dead_ring(x1, tile)
        n = ring[0][0].shape[0]
        threads = probes.block_threads(tile)
        step(f"pallas_repblocks_tile{tile}",
             lambda x: probes.dead_tables(x, nodes, tris, tile), ring,
             2 * 4 * n + 8, 0, n // tile, threads)
        step(f"pallas_noblocks_tile{tile}",
             lambda x: probes.dead_nob(x, tile), ring, 2 * 4 * n, 0,
             n // tile, threads)
        step(f"torch_mul_tile{tile}", lambda x: torch.mul(x, 2.0), ring,
             2 * 4 * n, 0, None, None)
    ring = dead_ring(x1, probes.PERSISTENT_TILE)
    n = ring[0][0].shape[0]
    blocks = probes.persistent_blocks(device)
    tiles = probes.persistent_tiles(n // probes.PERSISTENT_TILE, blocks)
    threads = probes.PERSISTENT_THREADS
    step("pallas_repblocks_tile1024_arbitrary",
         lambda x: probes.dead_persistent(x, nodes, tris), ring,
         2 * 4 * n + 8, 0, blocks, threads,
         tiles=n // probes.PERSISTENT_TILE,
         tiles_per_block=[max(tiles), min(tiles)],
         words_per_thread=-(-max(tiles) * probes.PERSISTENT_TILE
                            // 4 // threads))
    del ring
    xf = torch.ones(probes.FMA_SHAPE, dtype=torch.float32, device=device)
    step("vpu_fma", probes.fma_chain, [(xf,)], 2 * 4 * xf.numel(),
         probes.fma_ops(xf), -(-xf.numel() // probes.THREADS),
         probes.THREADS)
    return recs


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_probes: no CUDA card")
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                       else root / "build" / "torch_probes.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(rec):
        rec = dict(rec, ts=time.time())
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    run_probes(torch.device("cuda"), emit)


if __name__ == "__main__":
    main()
