"""The refit's share of its roofline, in percent: its least time, the
bytes it must move (``raybench/refit_work.refit_bytes``: the corners read
and every row written) at the HBM rate (``yardstick.HBM_BPS``), over the
device time per step of the launches inside the program's ``bvh.refit``
spans. Nothing to read where no launch was made inside such a span."""

from raybench import yardstick


def read(ctx):
    r = (ctx["trace"] or {}).get("refit")
    if not r or r["device_us_per_step"] <= 0:
        return None
    least_s = r["bytes"] / yardstick.HBM_BPS
    return 100.0 * least_s / (r["device_us_per_step"] / 1e6)
