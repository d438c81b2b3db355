"""Frozen config dataclasses — a copy of ``unity_raytracer_tpu/utils/config.py``.

The fields are the JAX package's, unchanged, so one config object drives
both packages in the parity tests. The PyTorch port reads only what its
slice runs (``ops/render.py`` checks the rest and raises on what it does
not support); the TPU walk knobs (``tile_r``, ``walk_unroll``,
``occ_mode``, ``near_mode``, ``stale_prune``, ``shadow_batch``,
``fuse_shadows``, ``dbg``) are accepted and ignored, because they change
only how the TPU kernel walks, never what it computes.

The reference's "config system" is serialized Unity scene YAML + inspector
fields (Demo-RayTracing/RayTracing.unity:346-364, RayTracingSetup.cs:21-36).
Here configs are code: frozen dataclasses, overridable from the CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class DiffConfig:
    """Differentiability knobs.

    ``soft_shadow_temp > 0`` relaxes the hard shadow test
    (hitDist^2 < lightDist^2, reference RayTracingSetup.cs:337-345) into a
    sigmoid so silhouette gradients exist. With ``straight_through=True`` the
    forward value stays exactly hard (parity preserved) while the backward
    pass sees the soft function — see ops/shade.py (_soft_or_hard_vis) and
    ops/render.py (_local_radiance).
    """

    soft_shadow_temp: float = 0.0
    soft_hit_temp: float = 0.0
    straight_through: bool = True


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    ``max_bounces`` caps mirror/refraction recursion depth like
    ``MaxReflectionBounces`` (RayTracingSetup.cs:23,358): a ray segment at
    depth == max_bounces shades locally but spawns no children.
    ``background`` is on the display 0-1 scale (Unity Color), multiplied by
    255 onto the radiance scale internally (Rgb.cs:17).
    """

    max_bounces: int = 0
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    mode: str = "auto"          # 'scan' | 'tree' | 'auto'
    ray_chunk: Optional[int] = None  # rays per chunk (None = all at once)
    use_bvh: bool = False
    kernel: str = "auto"             # 'auto' | 'xla' | 'pallas' traversal
    block_size: int = 32        # pixel-block lane order (utils/swizzle.py,
    #                             camera.generate_rays_blocks); <=1 keeps
    #                             row-major lane order
    tile_r: int = 1024          # packet-kernel tile (rays per shared
    #                             traversal cursor); pair with block_size
    #                             so a tile covers whole pixel blocks
    bvh_arity: int = 4          # wide-node collapse width for the pallas
    #                             BVH (ops/pallas/traverse_wide); 4 or 8;
    #                             0 = binary walks (mk4 layout)
    bvh_leaf: int = 14          # pallas leaf capacity (tris per leaf
    #                             row; 14 -> 128-lane rows, 28 -> 256).
    #                             Bigger leaves shrink the interior tree
    #                             (fewer walk steps) at more tests per
    #                             leaf visit
    bvh_bins: int = 16          # binned-SAH builder bin count (finer
    #                             candidate splits at build-time cost;
    #                             16 is the shipped default)
    bvh_presplit: float = 0.0   # SBVH-style spatial presplitting budget
    #                             as a fraction of the mesh's triangle
    #                             count (0.3 = up to 30% duplicated
    #                             refs with clipped boxes). Routes the
    #                             build through the numpy ref-based
    #                             path (ops/bvh.presplit_refs); 0 =
    #                             plain binned SAH (native builder)
    bvh_pad: float = 0.0        # inflate every BVH node box by this
    #                             margin: the tree stays conservative
    #                             (traversal exact) for mesh vertices
    #                             moved up to the pad from their build
    #                             positions — set to the expected max
    #                             deformation for mesh-vertex fitting
    #                             (fit.PARAM_PATHS 'mesh_verts')
    fuse_shadows: bool = True   # megakernel: one fused occlusion walk for
    #                             all lights (wide layout only)
    shadow_batch: bool = False  # megakernel: advance the per-light
    #                             shadow walks in ONE while_loop with
    #                             independent cursors/stacks — pays the
    #                             per-iteration loop overhead max(steps)
    #                             times instead of sum(steps), without
    #                             the fused walk's union-leaf blowup.
    #                             Ignored when fuse_shadows=True
    dbg: str = ""               # megakernel step-overhead decomposition
    #                             switches (comma-separated; see
    #                             ops/pallas/mega._kernel) — NOT
    #                             semantics-preserving; measurement only
    walk_unroll: int = 1        # megakernel wide walks: stack entries
    #                             processed per while_loop iteration —
    #                             amortizes per-iteration loop/branch
    #                             overhead (the measured cost driver)
    tri_isect: str = "mt"       # megakernel leaf triangle test: 'mt'
    #                             (Möller–Trumbore from raw verts) or
    #                             'bw' (Baldwin–Weber precomputed plane
    #                             + affine barycentric rows — ~2x fewer
    #                             vector ops per test, stored shading
    #                             normal; same hit set to fp rounding).
    #                             'bw' needs the wide walks (arity >= 2).
    light_cull: float = 0.0     # per-light attenuation culling: skip a
    #                             light's shadow query AND contribution
    #                             for lanes whose conservative bound
    #                             (max(kd)+max(ks)) * max(I) / d^2 falls
    #                             below this threshold (0-255 radiance
    #                             units; 1.0 = one 8-bit display step).
    #                             Bounded error <= threshold per light
    #                             per segment; 0 = exact. Applied
    #                             identically in the megakernel, the
    #                             composed path, and the replay.
    stale_prune: bool = True    # wide walks (nearest + per-light
    #                             occlusion): drop stack entries whose
    #                             recorded entry distance exceeds the
    #                             running max best_t before popping.
    #                             Pruning saves visits but costs an
    #                             inner pop loop PLUS a cross-lane max
    #                             reduction per step to maintain the
    #                             bound; r5 decomposition measured the
    #                             machinery costlier than the visits it
    #                             saves on the flagship (dbg_noprune
    #                             80.1ms vs 85.0ms). False skips both.
    #                             Exact either way (boxes still cull
    #                             against per-lane best_t).
    occ_mode: str = "sort"      # occlusion-walk push discipline:
    #                             'sort' (near-first + prune), 'keys'
    #                             (prune, no sort network), 'none',
    #                             'pack' ('none' with per-child hit
    #                             tests packed into 2 int32 sum
    #                             reductions instead of 4 mins — the
    #                             r5 measured win, exact)
    near_mode: str = "sort"     # nearest-walk push discipline: 'sort'
    #                             (near-first ordered descent) or
    #                             'pack' (unordered, packed hit
    #                             reductions). Both exact — ordering
    #                             tightens best_t sooner (fewer leaf
    #                             visits) but costs per-child key
    #                             reductions + the sort network
    tree_cap: int = 4           # tree mode (refraction): max live-lane
    #                             capacity as a multiple of the primary
    #                             ray count. Each level's (reflect,
    #                             refract) fork doubles the lane arrays;
    #                             compaction then drops exactly-dead
    #                             lanes (weight 0 / miss / TIR child)
    #                             so deep scenes stop paying 2^depth.
    #                             If live lanes ever exceed the cap the
    #                             weakest-throughput lanes are dropped
    #                             (bounded, throughput-culling-style
    #                             error). 0 = uncapped exact 2^depth.
    remat: bool = False         # jax.checkpoint the scan bounce body:
    #                             backward recomputes each segment instead
    #                             of storing its residuals — the composed
    #                             differentiable path's memory fix (the
    #                             1080p residuals otherwise OOM a v5e)
    diff: DiffConfig = field(default_factory=DiffConfig)

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
