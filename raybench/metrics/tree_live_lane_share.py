"""Live lanes over launched lanes of the dielectric tree's fork launches,
over the frames recorded after the traced stretch (``drivers/frames_ext``;
``spans.tree_live_lane_share``: each frame's ``tree.live`` counts paired
in order with its ``tree.lanes``). Lower means more dead lanes launched.
Nothing to read where a frame's launches do not each have their live
count."""


def read(ctx):
    t = (ctx["trace"] or {}).get("tree")
    if not t:
        return None
    return t["live_share"]
