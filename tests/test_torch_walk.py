"""PyTorch port: the host pieces the redesigned walks rest on.

The fused segment kernel (``csrc/mega_segment.cu``) and the ordered
binary walk (``csrc/traverse.cu`` MK4) size their stacks from the tree's
worst push depth and skip a leaf-slot group whose box the ray does not
enter; both come from the host (``ops/kernels/traverse_mk3``). Held here
against the port's plain code on seeded numpy inputs:

* each group box holds all 9 coordinates of each of its live slots, is
  widened outward by GROUP_MARGIN of its largest coordinate and one ulp,
  and dead slots do not widen it;
* the walk rows (ROADMAP Queue C #14): every leaf-slot hit of such rays
  passes the kernels' slab test at its own t on every binary node and wide
  child box of its path (``nodes_walk``, ``wide_walk``) and on the fused
  kernel's scene box, and the plain walk ``ops/bvh.traverse`` misses no
  hit of the brute force on 16,000 of them; the walk rows differ from the
  twin's ``nodes`` and ``wide`` in their (wider) boxes alone;
* culling drops no hit: every leaf-slot hit (Möller–Trumbore on ``tris``,
  Baldwin–Weber on ``tris_bw``) of seeded rays, half of them aimed near
  triangle corners and edges, lies in a group whose box passes the plain
  ``mega._slab`` at the hit's own t;
* the stored depths equal a recursive walk of the rows (19 BVH4 and 12
  binary entries on ``mesh100k``);
* ``check_stack`` raises for a tree deeper than a kernel's stack;
* the threaded and wide walks' warp-cooperative leaf phase
  (``csrc/traverse.cu`` ``leaf_phase``), modelled op for op in its scan,
  owner search, queue and pass order, keeps the winner of the sequential
  ``traverse_plain`` order on seeded leaves with exact ties, leaves
  shorter than their rows and live-looking slots past the count;
* the wide walk's leaf stack code decodes to every leaf child's first
  row and triangle count.

The ``gpu`` cases run the kernels on the card: a too-deep tree raises
before any launch, and launches that share one overflow counter give the
bits of launches alone.
"""

import numpy as np
import pytest
import torch

from torch_parity import cuda, small_scene  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as t_mk3
from unity_raytracer_tpu_torch.ops.kernels import traverse_wide
from unity_raytracer_tpu_torch.utils import boxes
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", tri_isect="bw")
# (scene, leaf size, arity)
TREES = {"small-14": ("small", 14, 4), "small-28-bvh8": ("small", 28, 8),
         "mesh10k-98": ("mesh10k", 98, 4)}


def _scene(name):
    if name == "small":
        return small_scene(t_scene, t_meshgen, device="cpu")
    return get_preset(name, width=8, height=8, device="cpu")[0]


def _tree(name, leaf, arity, scene=None):
    scene = _scene(name) if scene is None else scene
    return t_bvh.prepare_bvh(scene, CFG.with_(bvh_leaf=leaf,
                                              bvh_arity=arity), "cpu")


@pytest.fixture(scope="module", params=list(TREES))
def tree(request):
    """(scene, its packed BVH) of a TREES entry."""
    name, leaf, arity = TREES[request.param]
    scene = _scene(name)
    return scene, _tree(name, leaf, arity, scene)


@pytest.fixture(scope="module")
def packed(tree):
    return tree[1]


def _groups(packed):
    """(vertices [R,2,7,9], live [R,2,7], boxes [R,2,8]) per tris row."""
    rows = packed.tris.shape[0]
    v = packed.tris.numpy()[:, :9 * t_mk3.PALLAS_LEAF].reshape(
        rows, 2, t_mk3.GROUP, 9)
    live = (packed.leaf_prim.numpy() >= 0).reshape(rows, 2, t_mk3.GROUP)
    return v, live, packed.leafbox.numpy().reshape(rows, 2, 8)


def test_group_boxes_hold_live_slots_rounded_outward(packed):
    v, live, box = _groups(packed)
    pts = v.reshape(*v.shape[:3], 3, 3)
    lo, hi = box[..., None, None, 0:3], box[..., None, None, 3:6]
    inside = (pts >= lo) & (pts <= hi)
    assert inside.all(axis=(-1, -2))[live].all()
    # the extreme live coordinates, widened by the margin and one ulp
    inf = np.float32(np.inf)
    want_lo = np.where(live[..., None, None], pts, inf).min(axis=(2, 3))
    want_hi = np.where(live[..., None, None], pts, -inf).max(axis=(2, 3))
    used = live.any(axis=2)
    lo, hi = want_lo[used], want_hi[used]
    pad = np.float32(boxes.GROUP_MARGIN) * np.maximum(
        np.abs(lo), np.abs(hi)).max(axis=-1, keepdims=True)
    np.testing.assert_array_equal(box[..., 0:3][used],
                                  np.nextafter(lo - pad, -inf))
    np.testing.assert_array_equal(box[..., 3:6][used],
                                  np.nextafter(hi + pad, inf))
    assert (box[~used] == 0).all() and (box[..., 6:] == 0).all()
    assert (box[..., 0:3][used] < want_lo[used]).all()
    assert (box[..., 3:6][used] > want_hi[used]).all()


def test_dead_slots_do_not_widen_a_box():
    rng = np.random.default_rng(5)
    tris = np.zeros((3, 128), np.float32)
    tris[:, :126] = rng.normal(size=(3, 126)).astype(np.float32)
    leaf_prim = np.full((3, t_mk3.PALLAS_LEAF), -1, np.int32)
    leaf_prim[0, :10] = np.arange(10)      # group 0 full, group 1 3 live
    leaf_prim[1, :4] = np.arange(4)        # group 1 empty
    far = tris.copy()
    for r in range(3):                     # far-off garbage in dead slots
        for k in np.nonzero(leaf_prim[r] < 0)[0]:
            far[r, 9 * k:9 * k + 9] = 1e6
    got = t_mk3.group_boxes(far, leaf_prim)
    np.testing.assert_array_equal(got, t_mk3.group_boxes(tris, leaf_prim))
    assert (got[1, 8:] == 0).all() and (got[2] == 0).all()
    v = tris[0, 63:90].reshape(3, 9)  # group 1's live slots
    pad = np.float32(boxes.GROUP_MARGIN) * np.abs(v).max()
    assert got[0, 8] == np.nextafter(v[:, 0::3].min() - pad, -np.inf)
    assert got[0, 11] == np.nextafter(v[:, 0::3].max() + pad, np.inf)


def _rays(packed, n, seed):
    """Seeded rays from points around the tree's box: half toward random
    points of the box, half toward points of random live triangles near
    their corners and edges (Dirichlet weights), whose hits lie at the
    faces of their group's box."""
    rng = np.random.default_rng(seed)
    nodes = packed.nodes.numpy()
    lo, hi = nodes[0, 0:3], nodes[0, 3:6]
    span = hi - lo
    o = lo - 0.5 * span + rng.random((n, 3)) * 2.0 * span
    tgt = lo + rng.random((n, 3)) * span
    live = packed.leaf_prim.numpy().reshape(-1) >= 0
    tri = packed.tris.numpy()[:, :9 * t_mk3.PALLAS_LEAF].reshape(-1, 3, 3)[
        live]
    pick = rng.integers(0, tri.shape[0], n // 2)
    w = rng.dirichlet([0.05] * 3, n // 2)
    tgt[:n // 2] = (w[:, :, None] * tri[pick]).sum(axis=1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("isect", ["mt", "bw"])
def test_culling_drops_no_hit(packed, isect, seed):
    """Every slot hit, at its own t as the bound (raised by GROUP_MARGIN,
    as the kernels raise it), lies in a group whose box the plain slab
    test passes: the kernels' group culling keeps every hit a walk bounded
    at or above that t can take."""
    o, d = _rays(packed, 2048, seed=seed)
    o3, d3 = o.unbind(-1), d.unbind(-1)
    inv3 = tuple(1.0 / mega._fix(c) for c in d3)
    rows = packed.tris.shape[0]
    slot = np.arange(rows * t_mk3.PALLAS_LEAF)
    live = packed.leaf_prim.numpy().reshape(-1) >= 0
    slot = slot[live]
    if isect == "mt":
        rec = packed.tris[:, :9 * t_mk3.PALLAS_LEAF].reshape(-1, 9)[
            torch.from_numpy(slot)]
    else:
        rpl, bw_rpl = packed.rows_per_leaf, packed.bw_rows_per_leaf
        per_leaf = rpl * t_mk3.PALLAS_LEAF
        leaf, j = slot // per_leaf, slot % per_leaf
        bw = packed.tris_bw.reshape(-1, bw_rpl, 128)[:, :, :120].reshape(
            -1, bw_rpl * t_mk3.BW_PER_ROW, 12)
        rec = bw[torch.from_numpy(leaf), torch.from_numpy(j)]
    box = packed.leafbox.reshape(rows * 2, 8)[
        torch.from_numpy(slot // t_mk3.GROUP)]
    hits = 0
    for s0, ok, t in mega._slot_chunks(o3, d3, rec):
        b = box[s0:s0 + ok.shape[1]].T[:, None, :]
        bound = t + t.abs() * boxes.GROUP_MARGIN
        passes = mega._slab(tuple(c[:, None] for c in o3),
                            tuple(c[:, None] for c in inv3), b, bound)
        assert bool((passes | ~ok).all())
        hits += int(ok.sum())
    assert hits > 100


def _slot_hits(packed, o, d, isect):
    """Every leaf-slot hit of rays ``o, d`` (Möller–Trumbore on ``tris``,
    Baldwin–Weber on ``tris_bw``): (ray [H], global slot [H], t [H])."""
    rows = packed.tris.shape[0]
    slot = np.arange(rows * t_mk3.PALLAS_LEAF)
    slot = slot[packed.leaf_prim.numpy().reshape(-1) >= 0]
    if isect == "mt":
        rec = packed.tris[:, :9 * t_mk3.PALLAS_LEAF].reshape(-1, 9)[
            torch.from_numpy(slot)]
    else:
        rpl, bw_rpl = packed.rows_per_leaf, packed.bw_rows_per_leaf
        per_leaf = rpl * t_mk3.PALLAS_LEAF
        bw = packed.tris_bw.reshape(-1, bw_rpl, 128)[:, :, :120].reshape(
            -1, bw_rpl * t_mk3.BW_PER_ROW, 12)
        rec = bw[torch.from_numpy(slot // per_leaf),
                 torch.from_numpy(slot % per_leaf)]
    out = []
    for s0, ok, t in mega._slot_chunks(o.unbind(-1), d.unbind(-1), rec):
        ray, k = torch.nonzero(ok, as_tuple=True)
        out.append((ray, torch.from_numpy(slot)[s0 + k], t[ray, k]))
    return tuple(torch.cat(x) for x in zip(*out))


def _binary_paths(nodes):
    """Per tris row, the binary nodes on the path from the root to its
    leaf, as a [rows, depth] index array padded with -1."""
    parent = np.full(nodes.shape[0], -1, np.int64)
    for i in np.nonzero(nodes[:, 7] <= 0)[0]:
        parent[i + 1] = parent[int(nodes[i, 9])] = i
    leaves = np.nonzero(nodes[:, 7] > 0)[0]
    rows = int(nodes[leaves, 6].max()) + 1
    paths = [[] for _ in range(rows)]
    for leaf in leaves:
        path, i = [], leaf
        while i >= 0:
            path.append(i)
            i = parent[i]
        paths[int(nodes[leaf, 6])] = path
    return paths


def _wide_paths(wide):
    """Per tris row, the (wide row, child slot) boxes the wide walk tests
    from row 0 (the root's children) down to its leaf child."""
    cnt, meta = wide[:, 7::8], wide[:, 6::8].astype(np.int64)
    up = {}
    for r, c in zip(*np.nonzero(cnt == 0)):
        up[int(meta[r, c])] = (int(r), int(c))
    paths = {}
    for r, c in zip(*np.nonzero(cnt > 0)):
        path, node = [(int(r), int(c))], int(r)
        while node in up:
            path.append(up[node])
            node = up[node][0]
        paths[int(meta[r, c])] = path
    return paths


def _boxes_pass(o, d, ray, boxes, bound):
    """The kernels' slab test (``mega._slab``, over [0, bound]) of rays
    ``ray`` against ``boxes [H, 6]``."""
    inv = 1.0 / mega._fix(d[ray])
    return mega._slab(o[ray].unbind(-1), inv.unbind(-1), boxes.T, bound)


@pytest.mark.parametrize("isect", ["mt", "bw"])
def test_walk_boxes_keep_every_hit(tree, isect):
    """ROADMAP Queue C #14: every slot hit of seeded rays, half of them
    aimed at triangle corners and edges, passes the kernels' slab test
    at its own t as the bound (a walk's bound never falls below the hit
    it ends with) on every box a walk tests on its way to that hit: the
    binary nodes of its path (``nodes_walk``), the wide rows' child boxes
    of its path (``wide_walk``) and the fused kernel's scene box (aux row
    0, bound _BIG). The margins live in the boxes (``pad_box``); the walk
    rows differ from the twin's ``nodes`` and ``wide`` in the boxes
    alone, each strictly wider."""
    scene, packed = tree
    o, d = _rays(packed, 4096, seed=21)
    ray, slot, t = _slot_hits(packed, o, d, isect)
    assert ray.numel() > 1000
    rpl = packed.rows_per_leaf
    leaf_row = (slot // t_mk3.PALLAS_LEAF).numpy() // rpl * rpl
    bpaths = _binary_paths(packed.nodes.numpy())
    wpaths = _wide_paths(packed.wide.numpy())
    culled = {}
    for name, walk, exact, paths in (
            ("binary", packed.nodes_walk, packed.nodes,
             [[(n, 0) for n in bpaths[r]] for r in leaf_row]),
            ("wide", packed.wide_walk, packed.wide,
             [wpaths[int(r)] for r in leaf_row])):
        hit = torch.from_numpy(np.repeat(np.arange(len(paths)),
                                         [len(p) for p in paths]))
        box = torch.from_numpy(np.array([e for p in paths for e in p]))
        assert max(len(p) for p in paths) > 1
        for tab in (walk, exact):
            boxes = tab.reshape(tab.shape[0], -1, 8)[box[:, 0], box[:, 1],
                                                      0:6]
            ok = _boxes_pass(o, d, ray[hit], boxes, t[hit])
            if tab is walk:
                assert bool(ok.all()), (name, int((~ok).sum()))
            else:
                culled[name] = int((~ok).sum())
    aux = mega.build_aux(scene, CFG.background)
    ok = _boxes_pass(o, d, ray, aux[0, :6].expand(ray.numel(), 6),
                     torch.full_like(t, mega._BIG))
    assert bool(ok.all()), int((~ok).sum())
    nw, n = packed.nodes_walk, packed.nodes
    np.testing.assert_array_equal(nw[:, 6:], n[:, 6:])
    assert bool((nw[:, 0:3] < n[:, 0:3]).all())
    assert bool((nw[:, 3:6] > n[:, 3:6]).all())
    ww, w = (x.reshape(x.shape[0], -1, 8) for x in (packed.wide_walk,
                                                    packed.wide))
    live = w[..., 7] >= 0
    np.testing.assert_array_equal(ww[..., 6:], w[..., 6:])
    np.testing.assert_array_equal(ww[~live], w[~live])
    assert bool((ww[..., 0:3][live] < w[..., 0:3][live]).all())
    assert bool((ww[..., 3:6][live] > w[..., 3:6][live]).all())
    print(f"the exact boxes would cull {culled} of {ray.numel()} hits")


# (scene, leaf size): the trees of ROADMAP Queue C #14's count
PLAIN_TREES = [("small", 4), ("small", 14), ("mesh10k", 4),
               ("mesh10k", 14)]


@pytest.mark.parametrize("name,leaf", PLAIN_TREES)
def test_plain_walk_misses_no_hit(name, leaf, monkeypatch):
    """ROADMAP Queue C #14: ``ops/bvh.traverse`` (the plain threaded walk
    on ``MeshBVH``, its node boxes widened by ``pad_box``) finds on 16,000
    seeded rays, half aimed at triangle corners and edges, every hit the
    brute force over all triangles (the walk's own ``_mt_one``) finds: no
    lane's t above the brute force's by more than 1e-4 relative. With the
    twin's exact boxes (``pad_box`` replaced by the identity) the same
    walk misses 9 / 2 / 1 / 0 of these lanes (printed with ``-s``)."""
    packed = _tree(name, leaf, 4)
    bvh = packed.bvh
    o, d = _rays(packed, 16000, seed=14)
    t_walk = t_bvh.traverse(bvh, o, d)[0]
    tv = bvh.tri_verts
    want = torch.full((o.shape[0],), torch.inf)
    step = max(1, (1 << 21) // tv.shape[0])
    for r0 in range(0, o.shape[0], step):
        t = t_bvh._mt_one(o[r0:r0 + step, None], d[r0:r0 + step, None],
                          tv[None, :, 0], tv[None, :, 1], tv[None, :, 2])
        want[r0:r0 + step] = t.amin(dim=1)
    hits = torch.isfinite(want)
    missed = hits & ~(t_walk <= want * (1.0 + 1e-4))
    assert int(hits.sum()) > 4000
    assert int(missed.sum()) == 0, torch.nonzero(missed).squeeze(1)
    assert bool((t_walk[~hits] == torch.inf).all())
    monkeypatch.setattr(t_bvh, "pad_box", lambda lo, hi: (lo, hi))
    t_exact = t_bvh.traverse(bvh, o, d)[0]
    exact = int((hits & ~(t_exact <= want * (1.0 + 1e-4))).sum())
    print(f"{name} leaf {leaf}: the exact boxes miss {exact} of "
          f"{int(hits.sum())} hits")


def _binary_worst(nodes, i=0):
    """Interior levels on the longest path from node i: the ordered walk
    holds at most one pending far child per level of its path, and any
    child can be the near one for some ray."""
    if nodes[i, 7] > 0:
        return 0
    return 1 + max(_binary_worst(nodes, i + 1),
                   _binary_worst(nodes, int(nodes[i, 9])))


def _wide_worst(wide, row=0, below=0):
    """The wide walk's most entries from expanding ``row`` with ``below``
    entries under it: its present children, and for each interior child
    (any may be the nearest, popped first) the rest of them below that
    child's own expansion."""
    cnt, meta = wide[row, 7::8], wide[row, 6::8]
    kids = int((cnt >= 0).sum())
    return max([below + kids] + [
        _wide_worst(wide, int(meta[c]), below + kids - 1)
        for c in range(cnt.shape[0]) if cnt[c] == 0])


def test_stored_depths_equal_a_walk_of_the_rows(packed):
    assert packed.stack_binary == _binary_worst(packed.nodes.numpy())
    assert packed.stack_wide == _wide_worst(packed.wide.numpy())
    assert 0 < packed.stack_binary <= t_mk3.STACK_BINARY
    assert 0 < packed.stack_wide <= traverse_wide.STACK


def test_flagship_depths():
    """mesh100k with its preset's 98-triangle leaves: 19 BVH4 entries
    and 12 binary ones, far below the 256 and 96 of the twin's stacks."""
    scene, _, cfg = get_preset("mesh100k", width=8, height=8, device="cpu")
    packed = t_bvh.prepare_bvh(scene, cfg, "cpu")
    assert (packed.stack_wide, packed.stack_binary) == (19, 12)
    assert packed.stack_wide == _wide_worst(packed.wide.numpy())
    assert packed.stack_binary == _binary_worst(packed.nodes.numpy())


def _chain(n):
    """A left-leaning chain of n interior nodes, one leaf on each side:
    the ordered walk's worst push depth is n."""
    nodes = np.zeros((2 * n + 1, 16), np.float32)
    nodes[:, 6] = -1.0
    for i in range(n):
        nodes[2 * i, 9] = 2 * i + 2
        nodes[2 * i + 1, 7] = 1.0
        nodes[2 * i + 1, 6] = float(i)
    nodes[2 * n, 7] = 1.0
    return nodes


@pytest.mark.parametrize("n", [1, 12, t_mk3.STACK_BINARY])
def test_check_stack_passes_up_to_the_capacity(n):
    depth = t_mk3.binary_stack_depth(_chain(n))
    assert depth == n
    t_mk3.check_stack(depth, t_mk3.STACK_BINARY)


@pytest.mark.parametrize("depth,capacity", [
    (t_mk3.STACK_BINARY + 1, t_mk3.STACK_BINARY),
    (traverse_wide.STACK + 1, traverse_wide.STACK), (-1, 96)])
def test_check_stack_raises(depth, capacity):
    with pytest.raises(ValueError, match="stack"):
        t_mk3.check_stack(depth, capacity, "walk")


def test_deep_chain_raises_before_any_launch():
    """A binary tree deeper than the ordered walk's stack: its stored
    depth is above the capacity, so the wrappers' check refuses it."""
    nodes = _chain(t_mk3.STACK_BINARY + 8)
    assert t_mk3.binary_stack_depth(nodes) == t_mk3.STACK_BINARY + 8
    with pytest.raises(ValueError, match="more than the kernel's capacity"):
        t_mk3.check_stack(t_mk3.binary_stack_depth(nodes),
                          t_mk3.STACK_BINARY, "walk_raw mk4")


# ---------------------------------------------------------------------------
# the warp-cooperative leaf phase of the MK3 and WIDE walks
# ---------------------------------------------------------------------------

WARP, PASS_GROUPS, NO_KEY = 32, 4, (1 << 64) - 1


def _leaf_phase_model(tris, leafbox, o, d, pend, any_hit):
    """csrc/traverse.cu ``leaf_phase`` for one warp, in its loop and
    reduction order: ``pend[lane]`` is None or (first tris row, count,
    bound at leaf entry) of the lane's pending leaf. The owners' groups
    are numbered by an inclusive scan; each chunk of 32 (owner, group)
    pairs finds a pair's owner by the kernel's binary search over the
    scan and slab-tests the group box against the owner's bound (raised
    by GROUP_MARGIN); the kept groups join a queue in lane order; each
    pass takes 4 queued groups, lane l testing slot l % 7 of group l // 7
    below the owner's count and bound and folding a hit into the owner's
    key, (t bits << 32 | slot) or the slot alone in any-hit mode, by a
    64-bit minimum. Returns per lane None or (t, slot, leaf row)."""
    inv = 1.0 / mega._fix(d)
    groups = [0 if p is None else (p[1] + t_mk3.GROUP - 1) // t_mk3.GROUP
              for p in pend]
    incl = np.cumsum(groups)
    excl = incl - np.asarray(groups)
    total = int(incl[-1])
    key = [NO_KEY] * WARP
    row = torch.tensor([0 if p is None else p[0] for p in pend])
    count = [0 if p is None else p[1] for p in pend]
    bound = torch.tensor([0.0 if p is None else p[2] for p in pend],
                         dtype=torch.float32)

    def slot_pass(entries):
        lane = torch.arange(t_mk3.GROUP * len(entries))
        e = torch.tensor(entries)[lane // t_mk3.GROUP]
        own = e & 31
        j = (e >> 5) * t_mk3.GROUP + lane % t_mk3.GROUP
        live = j < torch.tensor(count)[own]
        r = row[own] + j // t_mk3.PALLAS_LEAF
        k = j % t_mk3.PALLAS_LEAF
        v = tris[r, :9 * t_mk3.PALLAS_LEAF].reshape(-1, t_mk3.PALLAS_LEAF,
                                                    9)[lane, k]
        ok, t = mega._mt(o[own].unbind(-1), d[own].unbind(-1), v.T)
        hit = live & ok & (t < bound[own])
        bits = t.numpy().view(np.uint32)
        for lane_ in torch.nonzero(hit).squeeze(1).tolist():
            jj = int(j[lane_])
            cand = jj if any_hit else (int(bits[lane_]) << 32) | jj
            key[int(own[lane_])] = min(key[int(own[lane_])], cand)

    queue = []
    for p0 in range(0, total, WARP):
        p = p0 + np.arange(WARP)
        own = np.zeros(WARP, np.int64)
        for step in (16, 8, 4, 2, 1):
            own += np.where(incl[own + step - 1] <= p, step, 0)
        g = p - excl[own & 31]
        valid = p < total
        o_ = torch.from_numpy(own & 31)
        j0 = torch.from_numpy(g) * t_mk3.GROUP
        boxrow = row[o_] + j0 // t_mk3.PALLAS_LEAF
        half = (j0 % t_mk3.PALLAS_LEAF) // t_mk3.GROUP
        box = leafbox.reshape(-1, 2, 8)[boxrow.clamp(0, leafbox.shape[0]
                                                     - 1), half].T
        b = bound[o_]
        keep = mega._slab(o[o_].unbind(-1), inv[o_].unbind(-1), box,
                          b + b.abs() * boxes.GROUP_MARGIN)
        queue += [(int(g[lane]) << 5) | int(own[lane]) for lane in range(WARP)
                  if valid[lane] and bool(keep[lane])]
        h = 0
        while h + PASS_GROUPS <= len(queue):
            slot_pass(queue[h:h + PASS_GROUPS])
            h += PASS_GROUPS
        queue = queue[h:]
    if queue:
        slot_pass(queue)
    out = []
    for lane in range(WARP):
        if pend[lane] is None or key[lane] == NO_KEY:
            out.append(None)
            continue
        j = key[lane] & 0xFFFFFFFF
        t = -1.0 if any_hit else float(np.array(key[lane] >> 32, np.uint32)
                                       .view(np.float32))
        out.append((t, j % t_mk3.PALLAS_LEAF,
                    pend[lane][0] + j // t_mk3.PALLAS_LEAF))
    return out


def _leaves(seed, n_leaves=24, rpl=7):
    """Seeded leaves of ``rpl`` tris rows: random triangles in the unit
    cube, counts from 1 to rpl * 14 (most leaves shorter than their rows),
    a sixth of the live slots copies of an earlier slot of the same leaf
    (exact t ties), and in every slot past the count a live triangle
    grown 3x about its centroid, which a test that ignores the count
    would hit first on some rays. Returns (tris, leafbox, counts)."""
    rng = np.random.default_rng(seed)
    slots = rpl * t_mk3.PALLAS_LEAF
    tris = np.zeros((n_leaves * rpl, 128), np.float32)
    leaf_prim = np.full((n_leaves * rpl, t_mk3.PALLAS_LEAF), -1, np.int32)
    counts = rng.integers(1, slots + 1, n_leaves)
    counts[:3] = (slots, 1, t_mk3.GROUP + 1)
    for f, c in enumerate(counts):
        v = (rng.random((slots, 3, 3)) * 0.2
             + rng.random((1, 1, 3))).astype(np.float32).reshape(slots, 9)
        for j in range(1, c):
            if rng.random() < 1 / 6:
                v[j] = v[rng.integers(0, j)]
        big = v[rng.integers(0, c, slots - c)].reshape(-1, 3, 3)
        mid = big.mean(axis=1, keepdims=True)
        v[c:] = (mid + 3.0 * (big - mid)).reshape(-1, 9)
        for j in range(slots):
            r, k = divmod(j, t_mk3.PALLAS_LEAF)
            tris[f * rpl + r, 9 * k:9 * k + 9] = v[j]
            if j < c:
                leaf_prim[f * rpl + r, k] = j
    return (torch.from_numpy(tris),
            torch.from_numpy(t_mk3.group_boxes(tris, leaf_prim)), counts)


def _sequential(tris, rpl, o, d, leaf, count, bound, any_hit):
    """traverse_plain on the leaf's own slots below its count: nearest
    mode the first slot in (row, slot) order at the smallest t < bound,
    any-hit mode the first slot with t < bound."""
    from types import SimpleNamespace
    sub = tris[leaf * rpl:(leaf + 1) * rpl].clone()
    flat = sub[:, :9 * t_mk3.PALLAS_LEAF].reshape(-1, 9)
    flat[count:] = 0.0
    sub[:, :9 * t_mk3.PALLAS_LEAF] = flat.reshape(rpl, -1)
    t, slot, r = t_mk3.traverse_plain(
        SimpleNamespace(tris=sub), o[None], d[None],
        torch.tensor([bound], dtype=torch.float32), any_hit)
    if int(slot[0]) < 0:
        return None
    return float(t[0]), int(slot[0]), leaf * rpl + int(r[0])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cooperative_leaf_phase_keeps_the_sequential_winner(seed, any_hit):
    """The cooperative leaf phase picks, for every owner of a warp, the
    (t, slot, leaf row) of the sequential order: seeded rays aimed at
    random live slots of random leaves (several owners on one leaf, lanes
    with no pending leaf), bounds of BIG, a random distance, or exactly
    the t of one of the leaf's hits (strict <), duplicated triangles that
    tie exactly, and slots past the count that must not be tested."""
    rpl = 7
    tris, leafbox, counts = _leaves(seed, rpl=rpl)
    rng = np.random.default_rng(100 + seed)
    checked = ties = wins = past_count = 0
    for _ in range(6):
        leaf = rng.integers(0, counts.shape[0], WARP)
        leaf[:6] = leaf[0]                       # owners sharing a leaf
        o = torch.from_numpy(rng.normal(size=(WARP, 3)).astype(np.float32))
        tgt = torch.empty(WARP, 3)
        for lane in range(WARP):
            j = int(rng.integers(0, counts[leaf[lane]]))
            r, k = divmod(j, t_mk3.PALLAS_LEAF)
            v = tris[leaf[lane] * rpl + r, 9 * k:9 * k + 9].reshape(3, 3)
            w = torch.from_numpy(rng.dirichlet([1.0] * 3).astype(np.float32))
            tgt[lane] = (w[:, None] * v).sum(0)
        d = tgt - o
        d = d / d.norm(dim=1, keepdim=True)
        pend = []
        for lane in range(WARP):
            c = int(counts[leaf[lane]])
            kind = lane % 4
            if kind == 3 and lane > 8:
                pend.append(None)                # no pending leaf
                continue
            bound = 3.0e38 if kind == 0 else float(rng.random() * 3.0)
            if kind == 2:                        # exactly a hit's t
                first = _sequential(tris, rpl, o[lane], d[lane],
                                    int(leaf[lane]), c, 3.0e38, False)
                bound = first[0] if first else bound
            pend.append((int(leaf[lane]) * rpl, c, bound))
        got = _leaf_phase_model(tris, leafbox, o, d, pend, any_hit)
        for lane in range(WARP):
            if pend[lane] is None:
                assert got[lane] is None
                continue
            want = _sequential(tris, rpl, o[lane], d[lane],
                               int(leaf[lane]), pend[lane][1],
                               pend[lane][2], any_hit)
            assert got[lane] == want, (lane, pend[lane], got[lane], want)
            past_count += want != _sequential(
                tris, rpl, o[lane], d[lane], int(leaf[lane]),
                rpl * t_mk3.PALLAS_LEAF, pend[lane][2], any_hit)
            checked += 1
            wins += want is not None
            if want is not None and not any_hit:
                r = want[2] - int(leaf[lane]) * rpl
                j = r * t_mk3.PALLAS_LEAF + want[1]
                v = tris[int(leaf[lane]) * rpl:(int(leaf[lane]) + 1) * rpl,
                         :9 * t_mk3.PALLAS_LEAF].reshape(-1, 9)
                ties += int((v[j + 1:pend[lane][1]] == v[j]).all(1).any())
    assert checked > 150 and wins > 50 and past_count > 0, (
        checked, wins, ties, past_count)
    if not any_hit:
        assert ties > 0, (checked, wins, ties)  # a later duplicate lost


def test_wide_stack_code_carries_the_leaf_count(packed):
    """What the wide walk's stack code for a leaf child (csrc/traverse.cu
    ``WideStack``: -(2 + the slot index of the leaf's last triangle))
    relies on to decode to the row's lane +6 (first tris row) and lane +7
    (triangle count): every leaf child of ``PackedBVH.wide`` starts at a
    multiple of ``rows_per_leaf``, holds a whole count in 1 ..
    rows_per_leaf * 14, and its code fits an int32 below -1 (-1 means "pop
    next"). The decoding itself is held on the card (test_torch_traverse.py,
    ``test_cooperative_leaf_walks_match_plain_on_card``)."""
    w = packed.wide.numpy()
    meta = w[:, 6::8]
    cnt = w[:, 7::8]
    leaf = cnt > 0
    assert leaf.any()
    rpl = packed.rows_per_leaf
    meta, cnt = meta[leaf], cnt[leaf]
    assert (meta == np.round(meta)).all() and (cnt == np.round(cnt)).all()
    meta, cnt = meta.astype(np.int64), cnt.astype(np.int64)
    assert (meta >= 0).all() and (meta % rpl == 0).all()
    assert (cnt <= rpl * t_mk3.PALLAS_LEAF).all()
    assert (meta * t_mk3.PALLAS_LEAF + cnt + 1 < 2**31).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _deep_packed(device):
    """The small scene's tree with its depths set past the kernels'
    stacks (as a pathological tree would carry them)."""
    pk = _tree("small", 14, 4).to(device)
    return pk.replace(stack_binary=t_mk3.STACK_BINARY + 1,
                      stack_wide=traverse_wide.STACK + 1)


@pytest.mark.gpu
def test_too_deep_tree_raises_before_launch_on_card(cuda):
    pk = _deep_packed(cuda)
    o = torch.zeros((64, 3), device=cuda)
    d = torch.ones((64, 3), device=cuda)
    tm = torch.full((64,), 3e38, device=cuda)
    before = dict(t_mk3.launches)
    with pytest.raises(ValueError, match="capacity"):
        t_mk3.walk_raw("mk4", pk, o, d, tm)
    assert t_mk3.launches == before
    scene = small_scene(t_scene, t_meshgen, device="cpu").to(cuda)
    aux = mega.build_aux(scene, CFG.background)
    kw = dict(n_lights=2, n_spheres=1, n_tris=2, max_bounces=2)
    seg = dict(mega.launches)
    with pytest.raises(ValueError, match="capacity"):
        mega.trace_segment(pk, aux, 0, o, d, torch.ones_like(o), tm, **kw)
    assert mega.launches == seg


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["bw/wide4", "mt/binary"])
def test_shared_overflow_counter_on_card(cuda, route):
    """Several launches on one overflow counter (as a frame's chain shares
    it): no push dropped, and the bits of a launch with its own."""
    isect, arity = ("bw", 4) if route == "bw/wide4" else ("mt", 0)
    pk = _tree("small", 14, arity).to(cuda)
    scene = small_scene(t_scene, t_meshgen, device="cpu").to(cuda)
    aux = mega.build_aux(scene, CFG.background)
    o, d = (x.to(cuda) for x in _rays(pk.to("cpu"), 5000, seed=3))
    thr = torch.ones_like(o)
    tm = torch.full((5000,), 3e38, device=cuda)
    tm[::5] = -1.0
    kw = dict(n_lights=2, n_spheres=1, n_tris=2, max_bounces=2,
              tri_isect=isect, use_wide=arity != 0)
    ovf = torch.zeros(1, dtype=torch.int32, device=cuda)
    shared = [mega.trace_segment(pk, aux, 0, o, d, thr, tm, overflow=ovf,
                                 **kw) for _ in range(3)]
    walks = [t_mk3.walk_raw("mk4", pk, o, d, tm, overflow=ovf)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert int(ovf.item()) == 0
    alone = mega.trace_segment(pk, aux, 0, o, d, thr, tm, **kw)
    for got in shared:
        for a, b in zip(got, alone):
            assert torch.equal(a, b)
    want = t_mk3.walk_raw("mk4", pk, o, d, tm)
    for got in walks:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
