"""The least bytes of the dielectric tree's fork launches, for their roofline.

A fork launch of the fused segment kernel (the port's
``mega.trace_segment(fork=True)``, kernel #1 in mode (c)) reads each lane
it is handed, live or dead: its origin, direction and throughput and its
``tmax`` (40 bytes), and writes each lane's radiance delta and both
children's origins, directions, weights and ``tmax`` (92 bytes). It also
reads, at least once, the tables it walks and shades from: the walk rows
of its layout, the leaf rows of its leaf test, the leaves' group boxes and
material ids, and the aux block (128 floats a row: the gate row, then a
row per light, sphere, loose triangle and material). However the kernel
is written, it moves no fewer bytes; so its least time is these bytes at
the card's HBM rate (``yardstick.HBM_BPS``), and ``tree_fork_roofline`` is
that over the device time of the fork launches. Every array is float32.
"""

from __future__ import annotations

LANE_IN = 40
LANE_OUT = 92
AUX_COLS = 128


def table_bytes(packed, tri_isect: str, arity: int, aux_rows: int) -> int:
    """Bytes of the tables one fork launch reads: the aux block's
    ``aux_rows`` rows and, with a packed BVH (``packed``; None for a
    scene without mesh triangles), its walk rows (``nodes_walk`` for the
    binary layout, ``arity`` 0, else ``wide_walk``), its leaf rows
    (``tris_bw`` for the Baldwin–Weber test, else ``tris``), ``leafbox``
    and ``leafmeta``."""
    floats = int(aux_rows) * AUX_COLS
    if packed is not None:
        walk = packed.nodes_walk if int(arity) == 0 else packed.wide_walk
        leaf = packed.tris_bw if tri_isect == "bw" else packed.tris
        floats += sum(int(t.numel()) for t in (walk, leaf, packed.leafbox,
                                               packed.leafmeta))
    return 4 * floats


def fork_bytes(lanes: float, launches: float, tables: int) -> float:
    """Least bytes of ``launches`` fork launches over ``lanes`` lanes in
    all, each launch reading ``tables`` bytes of tables
    (``table_bytes``)."""
    return (LANE_IN + LANE_OUT) * float(lanes) + float(launches) * tables
