"""The frame's share of its roofline, in percent: the least time of a frame
on the card (``yardstick.least_frame_s``: its bytes at the HBM rate or its
FP32 operations at the FP32 rate, whichever is longer) over the device's
busy time per frame in the traced stretch. The operations are the
configuration's frozen ``yardstick.frame_fp32_ops``; a configuration
without one has nothing to read."""

from raybench import yardstick


def read(ctx):
    t, conf = ctx["trace"], ctx["config"]
    ops = conf.get("yardstick", {}).get("frame_fp32_ops")
    if ops is None or not t or not t["units"] or t["busy_s"] <= 0:
        return None
    nbytes = yardstick.frame_bytes(ctx["arrays"], conf["width"],
                                   conf["height"])
    least = yardstick.least_frame_s(ops, nbytes)
    return 100.0 * least / (t["busy_s"] / t["units"])
