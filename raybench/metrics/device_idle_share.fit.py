"""Share of the traced steps of a fit cell in which no kernel, copy or set
ran on the device (``raybench/trace.idle_share``)."""

from raybench.trace import idle_share as read  # noqa: F401
