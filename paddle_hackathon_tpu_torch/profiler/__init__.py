"""paddle.profiler in the port: so far only the cross-rank trace merge
(``cross_stack.merge_traces``) that the serving fleet's traces need; the
rest of the JAX package's ``profiler/`` waits for ROADMAP Queue 1 item
13."""

from .cross_stack import merge_traces

__all__ = ["merge_traces"]
