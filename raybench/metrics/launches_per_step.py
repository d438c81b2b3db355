"""Device activities (kernel launches, copies, sets) per fit step in the
traced steps: the host drivers of a step (``fit``, ``ops/render``'s
composed chain under autograd, ``ops/replay``;
``raybench/trace.ops_per_unit``)."""

from raybench.trace import ops_per_unit as read  # noqa: F401
