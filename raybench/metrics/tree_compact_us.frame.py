"""Device microseconds a frame of the launches made inside the program's
``tree.compact`` spans: the dielectric tree's compactions between levels
(``ops/render._compact``: the sort by throughput and the gather), on a
replayed frame each one's graph replayed inside the span, over the frames
recorded after the traced stretch (``drivers/frames_ext``). Nothing to
read where no launch was made inside such a span."""


def read(ctx):
    t = (ctx["trace"] or {}).get("tree")
    if not t or t["compact_us_per_frame"] <= 0:
        return None
    return t["compact_us_per_frame"]
