"""Device activities (kernel launches, copies, sets) per frame in the
traced stretch: the host drivers' launch count (``ops/render``
``_trace_chain_mega``, ``_trace_tree_mega``; ``raybench/trace.ops_per_unit``)."""

from raybench.trace import ops_per_unit as read  # noqa: F401
