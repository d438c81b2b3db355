"""Entry points of one step: the single-device forward step and the
multi-device dry run.

Twin: the repo-root ``__graft_entry__.py``. ``entry`` builds the
flagship forward step as the twin's ``entry()`` (``:11-25``) does, step
for step: the ``mesh_scene(100, width=64, height=64)`` preset,
``resolve_mode``, the SAH BVH built on the host from the mesh's vertices
and validity (``ops.bvh.build``), the camera's row-major rays, and ``fn``
= the composed ``trace_radiance`` on them. One step differs: the twin
hands ``fn`` its bare ``MeshBVH``, which both packages walk with the
plain per-lane walk (the twin's ``ops/bvh.traverse_any:745``, the port's
``ops/bvh.traverse_any``). The port packs that same tree's rows
(``traverse_mk3.pack_rows``: no rebuild, ``bvh.bvh`` is the tree), so
that ``kernel='auto'`` walks it on the card with the ordered binary
kernel (``csrc/traverse.cu`` mk4, ``traverse_mk4.traverse_packet4``),
and on the CPU with the plain walk over the same tree.
``dryrun_multichip`` is ``parallel/dryrun.dryrun``.

    fn, args = entry()          # on the card; entry("cpu") on the CPU
    radiance = fn(*args)        # [64 * 64, 3], 0-255 scale
"""

from __future__ import annotations

from unity_raytracer_tpu_torch.parallel.dryrun import (  # noqa: F401
    dryrun as dryrun_multichip)


def entry(device="cuda"):
    """``(fn, (scene, o, d, bvh))``: the flagship forward step — the
    composed bounce chain, BVH traversal and multi-light shadowed
    Blinn-Phong — on ``device``; ``bvh`` is a ``PackedBVH`` whose ``bvh``
    is the twin's ``MeshBVH``."""
    from unity_raytracer_tpu_torch.models.camera import generate_rays
    from unity_raytracer_tpu_torch.models.presets import mesh_scene
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import pack_rows
    from unity_raytracer_tpu_torch.ops.render import (
        resolve_mode, trace_radiance)

    scene, cam, cfg = mesh_scene(100, width=64, height=64, device=device)
    cfg = resolve_mode(scene, cfg)
    tree = bvhmod.build(scene.meshes.verts.cpu().numpy(),
                        scene.meshes.valid.cpu().numpy())
    bvh = pack_rows(tree).to(device)
    o, d = generate_rays(cam)

    def fn(scene, o, d, bvh):
        return trace_radiance(scene, o, d, cfg, bvh=bvh)

    return fn, (scene, o, d, bvh)
