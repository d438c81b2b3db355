"""The fork launches' share of their roofline, in percent: their least
time, the bytes they must move a frame (``raybench/tree_work``: 40 bytes
in and 92 out per launched lane, and the tables once a launch) at the HBM
rate (``yardstick.HBM_BPS``), over the device time a frame of the
launches inside the program's ``tree.fork`` spans (``tree_fork_us.frame``).
Nothing to read where no launch was made inside such a span."""

from raybench import yardstick


def read(ctx):
    t = (ctx["trace"] or {}).get("tree")
    if not t or t["fork_us_per_frame"] <= 0:
        return None
    least_s = t["fork_bytes_per_frame"] / yardstick.HBM_BPS
    return 100.0 * least_s / (t["fork_us_per_frame"] / 1e6)
