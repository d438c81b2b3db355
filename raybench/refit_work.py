"""The least bytes of a BVH refit, for its share of the roofline.

A refit (the port's ``ops/bvh.refit``) turns the scene's current mesh
corners into every row a packed tree holds. However it is implemented,
it must read the corners once and write each of those rows once; nothing
smaller does the job. So its least time is these bytes at the card's HBM
rate (``yardstick.HBM_BPS``), and ``bvh_refit_roofline`` is that over the
device time of the refit's launches. The rows are counted from the
tree's own arrays (float32 each): the binary node rows and their walk
copy, the wide rows and theirs, the leaf rows, their group boxes and
Baldwin–Weber records, the epilogue's triangle table and node boxes, and
the scene's four boxes and the per-mesh boxes.
"""

from __future__ import annotations

ROWS = ("nodes", "nodes_walk", "wide", "wide_walk", "tris", "leafbox",
        "tris_bw")
INNER = ("tri_verts", "node_min", "node_max")


def refit_bytes(mesh_rows: int, packed, n_meshes: int = 1) -> int:
    """Bytes a refit of ``packed`` must move: ``mesh_rows`` triangles'
    corners read (9 floats each), every array of ``ROWS`` and ``INNER``
    the tree has written, plus the scene's exact and gate boxes (12
    floats) and ``n_meshes`` mesh boxes (6 floats each)."""
    size = lambda t: 0 if t is None else int(t.numel())
    floats = 9 * int(mesh_rows) + 12 + 6 * int(n_meshes)
    floats += sum(size(getattr(packed, k, None)) for k in ROWS)
    floats += sum(size(getattr(packed.bvh, k, None)) for k in INNER)
    return 4 * floats
