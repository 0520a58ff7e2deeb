"""On-device analytics pushdown (the port of the reference package's
``analytics``).

Aggregate queries -- count / count_by / top_k / sum / histogram /
time_bucket over requested fields -- run as three CUDA kernels after the
parse (``analytics.device``: ``agg_lanes``, ``agg_reduce``, ``agg_group``)
and bring back per-batch partial aggregates a few KB wide instead of the
packed columns.  The host referee (``analytics.state``) grows the same
aggregations over parsed rows; device partials merge to bit-identical
results, with every row the device cannot finish exactly (escaped
quotes, Long overflow, years outside 1902-2037, ...) folded back through
the row parser.
"""
from .spec import AggOp, AggregateSpec
from .state import AggregateOutcome, AggregateState

__all__ = ["AggregateSpec", "AggOp", "AggregateState", "AggregateOutcome"]
