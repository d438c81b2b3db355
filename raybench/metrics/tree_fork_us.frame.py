"""Device microseconds a frame of the launches made inside the program's
``tree.fork`` spans: each level's fork launch of the dielectric tree
(kernel #1 in mode (c)), on a replayed frame its graph replayed inside the
span (``ops/graphs``), over the frames recorded after the traced stretch
(``drivers/frames_ext``). Nothing to read where no launch was made inside
such a span."""


def read(ctx):
    t = (ctx["trace"] or {}).get("tree")
    if not t or t["fork_us_per_frame"] <= 0:
        return None
    return t["fork_us_per_frame"]
