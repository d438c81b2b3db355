"""Device microseconds per fit step of the launches made inside the
program's ``bvh.refit`` spans (``ops/bvh.refit`` and its ``leaves``,
``nodes`` and ``gates`` stages) over the traced steps of a mesh-geometry
fit (``drivers/fit_mesh``). Nothing to read where no launch was made
inside such a span."""


def read(ctx):
    r = (ctx["trace"] or {}).get("refit")
    if not r or r["device_us_per_step"] <= 0:
        return None
    return r["device_us_per_step"]
