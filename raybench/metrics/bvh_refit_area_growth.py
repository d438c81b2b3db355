"""How far the refit tree's boxes have grown: the summed surface area of
the interior node boxes of the program's refit (``ops/bvh.refit``) at
the vertices of the traced run's last recorded step, over the same sum
for the tree the program's ``prepare_bvh`` builds afresh from those
vertices; both taken after the window (``drivers/fit_mesh``). 1 where
refitting costs the walk nothing; above 1 as the fixed topology's boxes
swell and overlap. Nothing to read where the program made no refit."""


def read(ctx):
    r = (ctx["trace"] or {}).get("refit")
    if not r or r["area"] is None or not r["fresh_area"]:
        return None
    return r["area"] / r["fresh_area"]
