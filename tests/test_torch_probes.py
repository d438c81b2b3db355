"""The port's dispatch-cost and FP32-rate probes (``utils/probes.py``)
against the twin's Pallas bodies.

The twin's kernels are defined inside ``main()`` of
``scripts/tpu_probe2.py`` (``dead_kernel`` and ``dead_kernel_nob``,
``:134-138``, launched at ``:151``, ``:161`` and ``:181``) and of
``scripts/tpu_r2_session.py`` (``fma_kernel``, ``:66-72``, launched at
``:80``), so their bodies are copied here, with the twin's grids and
block specs, and run with the Pallas interpreter on the CPU at small
shapes: x of 4,096 float32 padded to each tile, the FMA chain on [16, 128]
at the twin's 1024 steps. The plain versions must equal the dead kernels
bit for bit and the FMA chain at rtol 1e-6 (the plain chain rounds each
step once from float64, the interpreter's fused multiply-add once: they
differ only on a double-rounding tie). On the CPU each wrapper runs its
plain version and counts no launch; on a card (``gpu``) it launches its
kernel, which must agree with the plain version the same way, and a
misaligned ``x`` raises (JAX is imported only where the twin runs, so the
card's cases run without it).
"""

import numpy as np
import pytest
import torch

from torch_parity import cuda  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch.utils import probes

N = 4096
FMA_ROWS, FMA_COLS, FMA_GRID = 8, 128, 2


# ---- the twin's bodies (scripts/tpu_probe2.py:134-138) ---------------------
def dead_kernel(x_ref, nodes_ref, tris_ref, o_ref):
    o_ref[:] = x_ref[:] + nodes_ref[0, 0] + tris_ref[0, 0]


def dead_kernel_nob(x_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0


# ---- scripts/tpu_r2_session.py:66-72 ---------------------------------------
def fma_kernel(x_ref, o_ref):
    v = x_ref[:]
    acc = v
    for _ in range(probes.FMA_STEPS):
        acc = acc * 1.000000119 + v
    o_ref[:] = acc


def _inputs(seed=0):
    """x (N), the flagship-shaped tables, seeded, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N).astype(np.float32)
    nodes, tris = (rng.standard_normal(s).astype(np.float32)
                   for s in probes.TABLE_SHAPES)
    return x, nodes, tris


def _twin_dead(x, tile, tables=None, arbitrary=False):
    """The twin's pallas_call (tpu_probe2.py:141-181) in the interpreter."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    total = x.shape[0]
    tspec = pl.BlockSpec((tile,), lambda i: (i,))
    rep = lambda *shape: pl.BlockSpec(
        shape, (lambda i: tuple(0 for _ in shape)))
    kw = {}
    if arbitrary:
        kw["compiler_params"] = pltpu.CompilerParams(
            dimension_semantics=("arbitrary",))
    out_shape = jax.ShapeDtypeStruct((total,), jnp.float32)
    if tables is None:
        f = pl.pallas_call(dead_kernel_nob, grid=(total // tile,),
                           in_specs=[tspec], out_specs=tspec,
                           out_shape=out_shape, interpret=True)
        return np.asarray(f(x))
    nodes, tris = tables
    f = pl.pallas_call(dead_kernel, grid=(total // tile,),
                       in_specs=[tspec, rep(*nodes.shape), rep(*tris.shape)],
                       out_specs=tspec, out_shape=out_shape, interpret=True,
                       **kw)
    return np.asarray(f(x, nodes, tris))


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a).view(np.int32),
                          np.asarray(b).view(np.int32))


@pytest.mark.parametrize("tile", probes.TILES)
def test_padded_as_the_twin_pads(tile):
    x = torch.from_numpy(_inputs()[0])
    got = probes.padded(x, tile)
    npad = (-N) % tile
    want = np.concatenate([x.numpy(), np.zeros((npad,), np.float32)])
    assert got.shape[0] % tile == 0 and _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", probes.TILES)
def test_dead_tables_plain_equals_twin(tile):
    x, nodes, tris = _inputs(tile)
    xp = probes.padded(torch.from_numpy(x), tile)
    want = _twin_dead(xp.numpy(), tile, (nodes, tris))
    tn, tt = torch.from_numpy(nodes), torch.from_numpy(tris)
    assert _bits_equal(probes.dead_tables_plain(xp, tn, tt), want)
    before = dict(probes.launches)
    assert _bits_equal(probes.dead_tables(xp, tn, tt, tile), want)
    assert probes.launches == before


@pytest.mark.parametrize("tile", probes.TILES)
def test_dead_nob_plain_equals_twin(tile):
    xp = probes.padded(torch.from_numpy(_inputs(tile)[0]), tile)
    want = _twin_dead(xp.numpy(), tile)
    assert _bits_equal(probes.dead_nob_plain(xp), want)
    before = dict(probes.launches)
    assert _bits_equal(probes.dead_nob(xp, tile), want)
    assert probes.launches == before


def test_dead_persistent_plain_equals_twin_arbitrary():
    """tpu_probe2.py:181: dead_kernel at tile 1024 in grid order."""
    tile = probes.PERSISTENT_TILE
    x, nodes, tris = _inputs(7)
    xp = probes.padded(torch.from_numpy(x), tile)
    want = _twin_dead(xp.numpy(), tile, (nodes, tris), arbitrary=True)
    got = probes.dead_persistent(xp, torch.from_numpy(nodes),
                                 torch.from_numpy(tris))
    assert _bits_equal(got, want)


def test_fma_chain_plain_equals_twin():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 1.5, (FMA_ROWS * FMA_GRID, FMA_COLS)).astype(
        np.float32)
    spec = pl.BlockSpec((FMA_ROWS, FMA_COLS), lambda i: (i, 0))
    want = np.asarray(pl.pallas_call(
        fma_kernel, grid=(FMA_GRID,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x))
    before = dict(probes.launches)
    got = probes.fma_chain(torch.from_numpy(x)).numpy()
    assert probes.launches == before
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the value grows to ~1025 v: a chain that rounded the product apart
    # from the sum would drift by ~1e-5 here
    assert np.all(got > 1000 * x)


def test_fma_chain_plain_rounds_once_per_step():
    """Separately rounded products would miss the fused chain: the plain
    version must not be that."""
    x = torch.tensor([1.0, 1.25, 0.7, 1.4999], dtype=torch.float32)
    c = torch.tensor(probes.FMA_SCALE, dtype=torch.float32)
    unfused = x.clone()
    for _ in range(probes.FMA_STEPS):
        unfused = unfused * c + x
    fused = probes.fma_chain_plain(x)
    assert not torch.equal(fused, unfused)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-4)


def test_counts_and_shapes():
    x = torch.ones(probes.FMA_SHAPE, dtype=torch.float32, device="meta")
    assert probes.fma_ops(x) == 274877906944   # tpu_r2_session.py:91
    assert probes.FMA_SHAPE == (131072, 1024)
    assert torch.tensor(probes.FMA_SCALE, dtype=torch.float32).item() \
        == 1.0 + 2.0 ** -23
    grids = [-(-probes.PROBE_N // t) for t in probes.TILES]
    assert grids == [2025, 254, 32]


def test_block_shapes():
    """``dead_tables`` and ``dead_nob`` run clamp(tile / 32, 64, 1024)
    threads a block on the twin's grid: 4, 8 and 16 float4 words a
    thread, and one word a thread on the smallest tile."""
    threads = [probes.block_threads(t) for t in probes.TILES]
    assert threads == [64, 256, 1024]
    assert [t // 4 // b for t, b in zip(probes.TILES, threads)] == [4, 8, 16]
    assert probes.block_threads(probes.THREADS) == 64


def test_persistent_block_shape():
    """``dead_persistent`` on the H100's 132 SMs: the 2025 tiles of 1024
    split 16 / 15 over 45 / 87 blocks, taken in order, and with
    ``PERSISTENT_THREADS`` threads a block every thread loads its whole
    share (at most 8 float4 words: csrc/probes.cu kBatch) before its
    first store."""
    tiles = probes.persistent_tiles(2025, 132)
    assert sum(tiles) == 2025
    assert (tiles.count(16), tiles.count(15)) == (45, 87)
    assert tiles == sorted(tiles, reverse=True)
    t = probes.PERSISTENT_THREADS
    assert t % 32 == 0 and probes.MIN_THREADS <= t <= probes.MAX_THREADS
    words = probes.PERSISTENT_TILE // 4
    assert -(-max(tiles) * words // t) <= 8
    assert probes.persistent_tiles(5, 132)[:6] == [1, 1, 1, 1, 1, 0]


@pytest.mark.parametrize("call", ["dead_tables", "dead_nob",
                                  "dead_persistent", "fma_chain"])
def test_wrappers_raise_off_the_cpu_and_card(call):
    """A tensor that is neither on the CPU nor on a card is refused, as
    are ragged tiles, before any launch."""
    meta = lambda n: torch.empty(n, dtype=torch.float32, device="meta")
    nodes, tris = (meta(s) for s in probes.TABLE_SHAPES)
    args = {"dead_tables": (meta(1000), nodes, tris, 1024),
            "dead_nob": (meta(2048), 1000),
            "dead_persistent": (meta(2048), nodes, tris),
            "fma_chain": (meta((4, 4)),)}[call]
    with pytest.raises(ValueError):
        getattr(probes, call)(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", probes.TILES)
def test_dead_kernels_equal_plain_on_card(cuda, tile):
    x, nodes, tris = (torch.from_numpy(a).to(cuda) for a in _inputs(tile))
    xp = probes.padded(x, tile)
    for name, got, want in (
            ("dead_tables", lambda: probes.dead_tables(xp, nodes, tris, tile),
             probes.dead_tables_plain(xp, nodes, tris)),
            ("dead_nob", lambda: probes.dead_nob(xp, tile),
             probes.dead_nob_plain(xp))):
        before = probes.launches[name]
        out = got()
        assert probes.launches[name] == before + 1
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["dead_tables", "dead_nob",
                                  "dead_persistent"])
def test_misaligned_view_raises_on_card(cuda, call):
    """The float4 kernels take a 16-byte aligned ``x`` only: a view 4
    bytes into its storage raises ``ValueError`` before any launch."""
    x = torch.zeros(2 * 1024 + 1, device=cuda)[1:]
    assert x.data_ptr() % 16 == 4
    nodes, tris = (torch.zeros(s, device=cuda) for s in probes.TABLE_SHAPES)
    args = {"dead_tables": (x, nodes, tris, 1024), "dead_nob": (x, 1024),
            "dead_persistent": (x, nodes, tris)}[call]
    before = dict(probes.launches)
    with pytest.raises(ValueError, match="aligned"):
        getattr(probes, call)(*args)
    assert probes.launches == before


@pytest.mark.gpu
def test_dead_persistent_equals_plain_on_card(cuda):
    x, nodes, tris = (torch.from_numpy(a).to(cuda) for a in _inputs(5))
    xp = probes.padded(x, probes.PERSISTENT_TILE)
    before = probes.launches["dead_persistent"]
    got = probes.dead_persistent(xp, nodes, tris)
    assert probes.launches["dead_persistent"] == before + 1
    want = probes.dead_tables_plain(xp, nodes, tris)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tiles", [5, 140, 2025])
def test_dead_persistent_shapes_equal_plain_on_card(cuda, n_tiles):
    """Grids with fewer tiles than blocks (blocks of one tile and of
    none: warps past the block's words skip the table shuffle), with a
    partial second round, and at the probe's 2025."""
    rng = np.random.default_rng(n_tiles)
    x = torch.from_numpy(rng.standard_normal(
        n_tiles * probes.PERSISTENT_TILE).astype(np.float32)).to(cuda)
    nodes, tris = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda) for s in probes.TABLE_SHAPES)
    got = probes.dead_persistent(x, nodes, tris)
    want = probes.dead_tables_plain(x, nodes, tris)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_fma_chain_equals_plain_on_card(cuda):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (256, 1024)).astype(
        np.float32)).to(cuda)
    before = probes.launches["fma_chain"]
    got = probes.fma_chain(x)
    assert probes.launches["fma_chain"] == before + 1
    torch.testing.assert_close(got, probes.fma_chain_plain(x), rtol=1e-6,
                               atol=0)
    rate = probes.measure_fp32_rate(cuda, repeats=2)
    assert 1e12 < rate < 1e14
