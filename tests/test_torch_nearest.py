"""PyTorch port: the culled brute-force nearest-triangle kernel.

``csrc/nearest_tri.cu`` tests each block of ``BLOCK`` consecutive rays
only against the triangles that the block's bundle (an apex ball and a
cone of directions) can reach, each triangle's ball grown by a margin
that covers the rounding of the exact Möller–Trumbore test. Its plain
model (``intersect_mk.nearest_triangle_survivors_plain``) is held here to
what the cull must guarantee, on rays built to break it: aimed at
vertices and edge midpoints, grazing and parallel to faces, with zero
direction components, starting inside the soup and on triangle planes,
against an icosphere soup with duplicated triangles (exact t ties), axis-
aligned squares and a valid mask:

(a) every pair the exact test accepts is kept by its block;
(b) the fold over each block's survivors equals ``nearest_triangle_plain``
    bit for bit, there and on coherent ``mesh10k`` primary rays;
(c) with the margin set to 0 the same rays lose hits, so the margin is
    what keeps (a);
(d) on the card (``gpu``): the kernel equals the plain version bit for
    bit on coherent, shuffled and adversarial rays, split over blocks
    (small launches) and not (one chunk of triangles), and its counting
    instance keeps per block what the plain model keeps.

``nearest_triangle_plain`` itself is held to the JAX kernel in
tests/test_torch_traverse.py.
"""

import numpy as np
import pytest
import torch

from torch_parity import cuda  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch.models import meshgen
from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk

torch.set_num_threads(1)

B = imk.BLOCK
F32 = np.float32


RADIUS = 6.0


def soup():
    """An icosphere (320 triangles of ~2 units, radius 6), every 7th
    triangle again (exact t ties, the first must win), three axis-aligned
    squares; every 5th triangle invalid."""
    v, f = meshgen.icosphere(subdivisions=2, radius=RADIUS,
                             center=(1.5, -1.0, 25.0))
    tris = v[f].astype(F32)
    sq = []
    for axis, at in ((2, 40.0), (0, -15.0), (1, -12.0)):
        corners = np.array([[-9, -9], [9, -9], [9, 9], [-9, 9]], F32)
        q = np.insert(corners, axis, at, axis=1)
        sq += [q[[0, 1, 2]], q[[0, 2, 3]]]
    tris = np.concatenate([tris, tris[::7], np.stack(sq)]).astype(F32)
    valid = np.arange(tris.shape[0]) % 5 != 3
    return tris, valid


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _ulps(rng, x, k=2):
    """x moved by up to k ulps per component."""
    x = x.astype(F32)
    for _ in range(k):
        step = rng.integers(-1, 2, size=x.shape)
        x = np.where(step > 0, np.nextafter(x, F32(np.inf)),
                     np.where(step < 0, np.nextafter(x, F32(-np.inf)), x))
    return x.astype(F32)


def _near(tris, j, k):
    """Indices of the k triangles whose centroids are nearest to j's."""
    c = tris.mean(1)
    return np.argsort(np.linalg.norm(c - c[j], axis=1))[:k]


def _beside(rng, tris, valid, n_cand=200_000):
    """Rays that graze a valid icosphere triangle from 30-90 units, which
    the exact test accepts although they pass outside the triangle's
    bounding ball (found by a seeded search; ~0.1% of the candidates),
    and whose nearest hit is that triangle: (o, d, j) float32 rows."""
    ico = tris[:320].astype(np.float64)
    j = rng.integers(320, size=n_cand)
    j = j[valid[j]]
    v = ico[j]
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    nrm = _unit(np.cross(e1, e2))
    x = (v[:, 0] + rng.uniform(-0.6, 1.3, (j.size, 1)) * e1
         + rng.uniform(-0.6, 1.3, (j.size, 1)) * e2)
    along = _unit(np.cross(nrm, rng.normal(size=(j.size, 3))))
    elev = 10.0 ** rng.uniform(-6.2, -4.5, j.size)
    d = (along + nrm * (elev * rng.choice([-1, 1], j.size))[:, None])
    o = (x - rng.uniform(30, 90, (j.size, 1)) * d).astype(F32)
    d = d.astype(F32)
    rows = torch.from_numpy(tris[j].reshape(-1, 9).T.copy())[:, :, None]
    miss, _ = imk._pairs(imk._columns(torch.from_numpy(o)),
                         imk._columns(torch.from_numpy(d)), rows)
    cen = v.mean(1)
    rad = np.sqrt(((v - cen[:, None]) ** 2).sum(-1).max(1))
    dn = _unit(d.astype(np.float64))
    w = cen - o
    perp = np.linalg.norm(w - (w * dn).sum(1, keepdims=True) * dn, axis=1)
    pick = np.flatnonzero(~miss[:, 0].numpy() & (perp > 1.05 * rad))
    _, first = imk.nearest_triangle_plain(
        torch.from_numpy(o[pick]), torch.from_numpy(d[pick]),
        torch.from_numpy(tris), torch.from_numpy(valid))
    pick = pick[first.numpy() == j[pick]]
    return o[pick], d[pick], j[pick]


def adversarial(rng, tris, valid):
    """{group: (o, d)} — each group a few blocks of B rays that share an
    origin (or nearly), so that the cull is active."""
    ico = tris[:320].astype(np.float64)
    groups = {}

    def shared(targets, origin, jitter=True):
        d = (targets - origin).astype(F32)
        if jitter:
            d = _ulps(rng, d)
        o = np.broadcast_to(origin, d.shape).astype(F32)
        return o, d

    def blocks(make, n_blocks=4):
        os_, ds = zip(*(make(k) for k in range(n_blocks)))
        return np.concatenate(os_), np.concatenate(ds)

    def vertices(_):
        j = rng.integers(320)
        pts = ico[_near(ico, j, 24)].reshape(-1, 3)
        return shared(pts[rng.choice(pts.shape[0], B)],
                      ico[j].mean(0) + _unit(rng.normal(size=3)) * 40.0)

    def midpoints(_):
        j = rng.integers(320)
        t = ico[_near(ico, j, 24)]
        a, b = rng.integers(3, size=(2, B))
        k = np.arange(B) % t.shape[0]
        pts = (t[k, a] + t[k, (a + 1 + b % 2) % 3]) / 2
        return shared(pts, ico[j].mean(0) + _unit(rng.normal(size=3)) * 30.0)

    beside = _beside(rng, tris, valid)

    def grazing(k):
        # one ray beside its triangle, and the same ray an ulp or two off
        o = np.repeat(beside[0][k:k + 1], B, 0)
        d = np.repeat(beside[1][k:k + 1], B, 0)
        d[B // 2:] = _ulps(rng, d[B // 2:], 1)
        return o, d

    def parallel(_):
        j = rng.integers(320)
        v0, v1, v2 = ico[j]
        e = np.stack([v1 - v0, v2 - v0, v2 - v1])[rng.integers(3)]
        o = (v0 + rng.uniform(-0.5, 1.5, (B, 1)) * (v1 - v0)
             + rng.uniform(-0.5, 1.5, (B, 1)) * (v2 - v0)
             - 3.0 * e).astype(F32)
        return o, _ulps(rng, np.broadcast_to(e, (B, 3)), 1)

    def zero_components(_):
        sq = tris[-6:].astype(np.float64)
        axis = rng.integers(3)
        face = sq[2 * [2, 0, 1].index(axis):][:2].reshape(-1, 3)
        pts = face[rng.integers(face.shape[0], size=B)]
        pts = pts + rng.integers(-2, 3, size=(B, 3)) * 1e-5
        d = np.zeros((B, 3), F32)
        d[:, axis] = rng.choice([1.0, 2.5], B)
        o = pts.copy()
        o[:, axis] -= 20.0
        o[B // 2:, axis] = pts[B // 2:, axis]  # on the square's plane
        return o.astype(F32), d

    def on_planes(k):
        j = rng.integers(320)
        idx = _near(ico, j, 16)
        t = ico[idx[np.arange(B) % idx.shape[0]]]
        bary = rng.dirichlet([1, 1, 1], B)
        bary[: B // 4] = np.eye(3)[rng.integers(3, size=B // 4)]
        o = np.einsum("nk,nkc->nc", bary, t)
        n = _unit(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]))
        d = n[0] * (1 if k % 2 else -1) + rng.normal(size=(B, 3)) * 0.05
        return o.astype(F32), d.astype(F32)

    for name, make in dict(vertices=vertices, midpoints=midpoints,
                           grazing=grazing, parallel=parallel,
                           zero_components=zero_components,
                           on_planes=on_planes).items():
        groups[name] = blocks(make, 8 if name == "grazing" else 4)
    return groups


GROUPS = ("vertices", "midpoints", "grazing", "parallel", "zero_components",
          "on_planes")


@pytest.fixture(scope="module")
def adv():
    tris, valid = soup()
    return tris, valid, adversarial(np.random.default_rng(7), tris, valid)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.mark.parametrize("group", GROUPS)
def test_cull_keeps_every_accepted_pair(adv, group):
    """(a) What the exact test accepts for some ray of a block, the block
    keeps; the cull is active (it drops triangles) on these blocks."""
    tris, valid, groups = adv
    o, d, tt, vv = _t(*groups[group], tris, valid)
    keep = imk.nearest_triangle_survivors_plain(o, d, tt, vv)
    acc = imk.nearest_triangle_accepts_plain(o, d, tt, vv)
    per_block = acc.reshape(-1, B, acc.shape[1]).any(1)
    assert per_block.any()
    assert not (per_block & ~keep).any()
    assert (~keep & torch.from_numpy(valid)[None]).any()


@pytest.mark.parametrize("group", GROUPS)
def test_culled_fold_equals_plain(adv, group):
    """(b) The fold over each block's survivors is the plain fold, bit for
    bit: t, and the index of the first of equal t."""
    tris, valid, groups = adv
    o, d, tt, vv = _t(*groups[group], tris, valid)
    want = imk.nearest_triangle_plain(o, d, tt, vv)
    got = imk.nearest_triangle_culled_plain(o, d, tt, vv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] >= 0).any() or group == "parallel"


def test_ties_go_to_the_first_triangle(adv):
    """The duplicated triangles give exact t ties; where both copies are
    valid the fold keeps the first, as the plain fold does."""
    tris, valid, groups = adv
    dup = np.arange(320)[::7]
    both = dup[valid[dup] & valid[320 + np.arange(dup.size)]]
    hits = []
    for group in ("vertices", "midpoints", "on_planes"):
        o, d, tt, vv = _t(*groups[group], tris, valid)
        hits.append(imk.nearest_triangle_culled_plain(o, d, tt, vv)[1])
    hit = torch.cat(hits).numpy()
    assert np.isin(hit, both).any()
    assert not np.isin(hit, 320 + both // 7).any()


def _mesh10k_blocks(n_blocks, seed):
    """Coherent primary rays of the 1024x1024 mesh10k frame: whole blocks
    of B lanes, half of them where the spheres are."""
    scene, cam, cfg = get_preset("mesh10k", device="cpu")
    o, d = generate_rays_blocks(cam, cfg.block_size)
    hit = imk.nearest_triangle_survivors_plain(
        o[: 1 << 20 : 64], d[: 1 << 20 : 64], scene.meshes.verts,
        scene.meshes.valid, block=B // 64).any(1)
    rng = np.random.default_rng(seed)
    on = np.flatnonzero(hit.numpy())
    pick = np.concatenate([rng.choice(on, n_blocks // 2, replace=False),
                           rng.choice(hit.shape[0], n_blocks // 2,
                                      replace=False)])
    lanes = (pick[:, None] * B + np.arange(B)).reshape(-1)
    return o[lanes], d[lanes], scene.meshes.verts, scene.meshes.valid


def test_culled_fold_equals_plain_on_mesh10k():
    """(b) on coherent primary rays of the mesh10k frame, where the cull
    keeps a few dozen of the 10,240 triangles per block."""
    o, d, verts, valid = _mesh10k_blocks(8, 0)
    keep = imk.nearest_triangle_survivors_plain(o, d, verts, valid)
    assert keep.sum(1).float().mean() < 0.05 * verts.shape[0]
    want = imk.nearest_triangle_plain(o, d, verts, valid)
    got = imk.nearest_triangle_culled_plain(o, d, verts, valid)
    assert (want[1] >= 0).sum() > B
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_margin_zero_loses_hits(adv):
    """(c) Without the margin the cull drops triangles that rays hit: the
    grazing rays, which the exact test accepts beside the triangle."""
    tris, valid, groups = adv
    o, d, tt, vv = _t(*groups["grazing"], tris, valid)
    acc = imk.nearest_triangle_accepts_plain(o, d, tt, vv)
    per_block = acc.reshape(-1, B, acc.shape[1]).any(1)
    keep0 = imk.nearest_triangle_survivors_plain(o, d, tt, vv,
                                                 margin_scale=0.0)
    assert (per_block & ~keep0).any()
    want = imk.nearest_triangle_plain(o, d, tt, vv)
    got = imk.nearest_triangle_culled_plain(o, d, tt, vv, margin_scale=0.0)
    assert not torch.equal(got[1], want[1])


def test_bundle_holds_its_rays(adv):
    """Every taking-part ray's origin lies within r_o of the apex and its
    direction within the cone (cos >= cos_lo, sin <= sin_hi), in float64."""
    _, _, groups = adv
    for o, d in groups.values():
        b = imk.block_bundles(*_t(o, d))
        o64 = o.astype(np.float64).reshape(-1, B, 3)
        dn = _unit(d.astype(np.float64)).reshape(-1, B, 3)
        cone = b["cone"].numpy()
        apex = b["apex"].numpy().astype(np.float64)[:, None]
        axis = _unit(b["axis"].numpy().astype(np.float64))[:, None]
        part = b["part"].numpy()
        dist = np.linalg.norm(o64 - apex, axis=-1)
        cos = (dn * axis).sum(-1)
        sin = np.linalg.norm(np.cross(dn, axis), axis=-1)
        ok = ((dist <= b["r_o"].numpy()[:, None])
              & (cos >= b["cos_lo"].numpy()[:, None])
              & (sin <= b["sin_hi"].numpy()[:, None]))
        assert (ok | ~part | ~cone[:, None]).all()


def test_blocks_that_cannot_hit_and_wild_blocks(adv):
    """A block whose rays are all non-finite or have d = 0 keeps nothing;
    one with a direction whose length overflows keeps every valid
    triangle; both still fold to the plain answer."""
    tris, valid, groups = adv
    o, d = (x.copy() for x in groups["vertices"])
    o[:B, 0] = np.nan
    d[B:2 * B] = 0.0
    d[2 * B + 5] = F32(3e38)
    o, d, tt, vv = _t(o, d, tris, valid)
    keep = imk.nearest_triangle_survivors_plain(o, d, tt, vv)
    assert not keep[:2].any()
    assert torch.equal(keep[2], torch.from_numpy(valid))
    want = imk.nearest_triangle_plain(o, d, tt, vv)
    got = imk.nearest_triangle_culled_plain(o, d, tt, vv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- on the card ----------------------------------------------------------

def _card_cases(cuda):
    tris, valid = soup()
    groups = adversarial(np.random.default_rng(7), tris, valid)
    cases = {g: (*_t(*groups[g]), *_t(tris, valid)) for g in GROUPS}
    # one chunk of triangles: the launch is not split over blocks
    cases["one chunk"] = (*_t(*groups["vertices"]), *_t(tris[:250],
                                                        valid[:250]))
    o, d, verts, ok = _mesh10k_blocks(16, 1)
    cases["mesh10k coherent"] = (o, d, verts, ok)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(o.shape[0]))
    cases["mesh10k shuffled"] = (o[perm], d[perm], verts, ok)
    return {k: tuple(x.to(cuda) for x in v) for k, v in cases.items()}


@pytest.mark.gpu
def test_kernel_equals_plain_on_card(cuda):
    """(d) The kernel's (t, index) equal the plain version's bit for bit on
    every case; each wrapper call counts one launch."""
    for name, (o, d, verts, valid) in _card_cases(cuda).items():
        before = imk.launches["nearest_triangle"]
        got = imk.nearest_triangle_pallas(o, d, verts, valid)
        assert imk.launches["nearest_triangle"] == before + 1
        want = imk.nearest_triangle_plain(o.cpu(), d.cpu(), verts.cpu(),
                                          valid.cpu())
        assert torch.equal(got[0].cpu(), want[0]), name
        assert torch.equal(got[1].cpu(), want[1]), name


@pytest.mark.gpu
def test_counting_instance_keeps_what_the_model_keeps(cuda):
    """(d) Per block, the counting instance keeps as many triangles as the
    plain model, and computes the same bits as the timed instance."""
    for name, (o, d, verts, valid) in _card_cases(cuda).items():
        t, i, kept = imk.nearest_triangle_survivors(o, d, verts, valid)
        model = imk.nearest_triangle_survivors_plain(
            o.cpu(), d.cpu(), verts.cpu(), valid.cpu())
        assert torch.equal(kept.cpu(), model.sum(1).to(torch.int32)), name
        ref = imk.nearest_triangle_pallas(o, d, verts, valid)
        assert torch.equal(t, ref[0]) and torch.equal(i, ref[1]), name
