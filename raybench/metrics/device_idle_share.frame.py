"""Share of the traced stretch of a frame cell in which no kernel, copy or
set ran on the device: one minus the union of device activity over the
stretch (``raybench/trace.idle_share``)."""

from raybench.trace import idle_share as read  # noqa: F401
