"""Dispatch-cost and FP32-rate probes: plain versions and kernel wrappers.

Twins: the four ``pallas_call`` sites outside the JAX package, which
measured the TPU rather than render anything —

* ``scripts/tpu_probe2.py:151``: ``dead_kernel`` (``:134-135``),
  ``o = x + nodes[0, 0] + tris[0, 0]`` over x of ``PROBE_N`` float32
  padded to whole tiles of 1024, 8192 or 65536, the two tables (the
  flagship's node and triangle tables, ``TABLE_SHAPES``) replicated into
  every grid step -> ``dead_tables``;
* ``:161``: ``dead_kernel_nob`` (``:137-138``), ``o = 2x`` on the same
  tiles -> ``dead_nob``;
* ``:181``: ``dead_kernel`` at tile 1024 under
  ``dimension_semantics=("arbitrary",)`` (grid steps in order on one
  core). CUDA has no such hint; ``dead_persistent`` runs the same body
  as a persistent grid, one block per SM, each taking the tiles in order;
* ``scripts/tpu_r2_session.py:80``: ``fma_kernel`` (``:66-72``), per
  element ``acc = v`` then ``FMA_STEPS`` times ``acc = acc * FMA_SCALE +
  v``, on a ``FMA_SHAPE`` float32 array -> ``fma_chain``.

The kernels are ``csrc/probes.cu`` (``_lib.probes_lib``): the three dead
kernels share one body, each thread moving 16-byte float4 words, so
``x`` and the output must be 16-byte aligned (a misaligned ``x`` raises
``ValueError``); ``dead_tables`` and ``dead_nob`` run
``block_threads(tile)`` threads a block, ``dead_persistent``
``persistent_blocks`` blocks of ``PERSISTENT_THREADS``; ``fma_chain``
runs ``THREADS`` threads a block on scalars. Each wrapper
launches its kernel for a CUDA tensor and runs its plain version
(``*_plain``) for a CPU tensor, nothing else; it adds one to
``launches`` where it launches. The plain FMA chain takes each step in
float64 (the product is exact) and rounds to float32 after it, which
differs from the kernel's single fused rounding only where the float64
sum lands on a float32 tie.

``measure_fp32_rate`` times ``fma_chain`` at the twin's shape and returns
FP32 operations per second, 2 per FMA: the card's own counterpart of the
TPU rate the repo-root ``bench.py`` divides by, which the port does not
carry.
"""

from __future__ import annotations

import torch

from unity_raytracer_tpu_torch.ops.kernels import _lib

KERNELS = ("dead_tables", "dead_nob", "dead_persistent", "fma_chain")
# kernel launches since the counts were last reset (set them to 0 to start
# a count); only the wrappers' CUDA branches add to them
launches = dict.fromkeys(KERNELS, 0)
THREADS = 256                  # tile granularity; threads per block of
                               # fma_chain
PERSISTENT_THREADS = 512       # threads per block of dead_persistent
                               # (csrc/probes.cu kPersistThreads)
# dead_tables / dead_nob: clamp(tile / 32, MIN_THREADS, MAX_THREADS)
MIN_THREADS, MAX_THREADS = 64, 1024
TILES = (1024, 8192, 65536)    # elements per block (tpu_probe2.py:140)
PERSISTENT_TILE = 1024         # tpu_probe2.py:168
PROBE_N = 2073600              # 1920 x 1080 (tpu_probe2.py:56)
TABLE_SHAPES = ((20803, 16), (10402, 128))   # nodes, tris (:132-133)
FMA_STEPS = 1024               # tpu_r2_session.py:64
FMA_SCALE = 1.000000119        # rounds to 1 + 2^-23 in float32
FMA_SHAPE = (512 * 256, 1024)  # ROWS * GRID, COLS (:74-75)


def padded(x: torch.Tensor, tile: int) -> torch.Tensor:
    """``x`` (1-D) padded with zeros to a whole number of tiles, as the
    twin pads it (``tpu_probe2.py:141-142``)."""
    pad = (-x.shape[0]) % tile
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def dead_tables_plain(x: torch.Tensor, nodes: torch.Tensor,
                      tris: torch.Tensor) -> torch.Tensor:
    return x + nodes[0, 0] + tris[0, 0]


def dead_nob_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def fma_chain_plain(x: torch.Tensor) -> torch.Tensor:
    c = torch.tensor(FMA_SCALE, dtype=torch.float32).double().item()
    v = x.double()
    acc = x
    for _ in range(FMA_STEPS):
        acc = (acc.double() * c + v).float()
    return acc


def block_threads(tile: int) -> int:
    """Threads per block of ``dead_tables`` and ``dead_nob`` at ``tile``
    (``csrc/probes.cu``): up to 8 float4 words each, 64 to 1024 of
    them."""
    return min(max(tile // 32, MIN_THREADS), MAX_THREADS)


def _check(name: str, x: torch.Tensor, tile: int | None = None,
           tables=(), aligned: bool = False) -> None:
    for t in (x, *tables):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.numel() == 0:
            raise ValueError(f"{name}: inputs must be non-empty contiguous "
                             f"float32 tensors on {x.device}")
    if tile is not None and (x.dim() != 1 or tile <= 0 or tile % THREADS
                             or x.shape[0] % tile):
        raise ValueError(f"{name}: x must be 1-D and a whole number of "
                         f"tiles; tile a multiple of {THREADS} (got "
                         f"{tuple(x.shape)}, tile {tile})")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned (the kernel "
                         f"moves float4 words); got a view at offset "
                         f"{x.data_ptr() % 16} bytes")


def _raise_if(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"urt_{name} launch failed: CUDA error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _aligned_out(x: torch.Tensor) -> torch.Tensor:
    o = torch.empty_like(x)
    if o.data_ptr() % 16:
        raise ValueError("the output of a float4 kernel must be 16-byte "
                         "aligned")
    return o


def dead_tables(x: torch.Tensor, nodes: torch.Tensor, tris: torch.Tensor,
                tile: int) -> torch.Tensor:
    """``x + nodes[0, 0] + tris[0, 0]``, one block per ``tile`` elements
    of ``x`` (1-D, a whole number of tiles, 16-byte aligned on a card),
    ``block_threads(tile)`` threads a block."""
    if x.device.type == "cpu":
        return dead_tables_plain(x, nodes, tris)
    _check("dead_tables", x, tile, (nodes, tris), aligned=True)
    o = _aligned_out(x)
    _raise_if(_lib.probes_lib().urt_dead_tables(
        x.data_ptr(), nodes.data_ptr(), tris.data_ptr(), o.data_ptr(),
        x.shape[0], tile, _stream(x)), "dead_tables")
    launches["dead_tables"] += 1
    return o


def dead_nob(x: torch.Tensor, tile: int) -> torch.Tensor:
    """``2x``, one block per ``tile`` elements (as ``dead_tables``)."""
    if x.device.type == "cpu":
        return dead_nob_plain(x)
    _check("dead_nob", x, tile, aligned=True)
    o = _aligned_out(x)
    _raise_if(_lib.probes_lib().urt_dead_nob(
        x.data_ptr(), o.data_ptr(), x.shape[0], tile, _stream(x)),
        "dead_nob")
    launches["dead_nob"] += 1
    return o


def persistent_blocks(device) -> int:
    """The persistent grid of ``dead_persistent``: one block per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def persistent_tiles(n_tiles: int, blocks: int) -> list:
    """Tiles each block of ``dead_persistent``'s grid takes: block b the
    tiles b, b + blocks, ... below ``n_tiles``."""
    return [len(range(b, n_tiles, blocks)) for b in range(blocks)]


def dead_persistent(x: torch.Tensor, nodes: torch.Tensor,
                    tris: torch.Tensor) -> torch.Tensor:
    """``dead_tables`` at ``PERSISTENT_TILE`` on a persistent grid:
    ``persistent_blocks`` blocks of ``PERSISTENT_THREADS`` taking the
    tiles in order; ``x`` 16-byte aligned on a card."""
    if x.device.type == "cpu":
        return dead_tables_plain(x, nodes, tris)
    _check("dead_persistent", x, PERSISTENT_TILE, (nodes, tris),
           aligned=True)
    o = _aligned_out(x)
    _raise_if(_lib.probes_lib().urt_dead_persistent(
        x.data_ptr(), nodes.data_ptr(), tris.data_ptr(), o.data_ptr(),
        x.shape[0], PERSISTENT_TILE, persistent_blocks(x.device),
        _stream(x)),
        "dead_persistent")
    launches["dead_persistent"] += 1
    return o


def fma_chain(x: torch.Tensor) -> torch.Tensor:
    """Per element ``acc = v`` then ``FMA_STEPS`` fused ``acc = acc *
    FMA_SCALE + v``; any shape."""
    if x.device.type == "cpu":
        return fma_chain_plain(x)
    _check("fma_chain", x)
    o = torch.empty_like(x)
    _raise_if(_lib.probes_lib().urt_fma_chain(
        x.data_ptr(), o.data_ptr(), x.numel(), _stream(x)), "fma_chain")
    launches["fma_chain"] += 1
    return o


def fma_ops(x: torch.Tensor) -> int:
    """FP32 operations of ``fma_chain(x)``: 2 per FMA."""
    return 2 * FMA_STEPS * x.numel()


def measure_fp32_rate(device, repeats: int = 5) -> float:
    """FP32 operations/s of ``fma_chain`` on the twin's ``FMA_SHAPE`` of
    ones (``tpu_r2_session.py:76``) on a CUDA ``device``: one warm-up,
    then the mean of ``repeats`` back-to-back launches between CUDA
    events."""
    from unity_raytracer_tpu_torch.utils.profiling import events_mean_s
    if torch.device(device).type != "cuda":
        raise ValueError(f"measure_fp32_rate needs a CUDA device, got "
                         f"{device}")
    x = torch.ones(FMA_SHAPE, dtype=torch.float32, device=device)
    return fma_ops(x) / events_mean_s(lambda: fma_chain(x), repeats)
