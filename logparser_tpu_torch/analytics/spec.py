"""Aggregation spec: the grammar of the analytics pushdown (the port's own
copy of the reference package's ``analytics/spec.py``).

A spec is an ordered list of operations over the parser's requested
fields (docs/ANALYTICS.md):

- ``{"op": "count"}``                                 valid-line count
- ``{"op": "count_by", "field": F}``                  distinct-value counts
- ``{"op": "top_k",    "field": F, "k": N}``          count_by, top-N view
- ``{"op": "sum",      "field": F}``                  numeric total
- ``{"op": "histogram","field": F, "edges": [...]}``  bin counts (edges
  strictly increasing; bin b holds values with exactly b edges <= v,
  i.e. ``bisect_right`` semantics)
- ``{"op": "time_bucket", "field": F, "width_s": W}`` counts per
  ``value_millis // (W * 1000)`` bucket (whole-second widths only — the
  invariant that lets the device bucket on epoch SECONDS and still match
  the millisecond referee exactly)

Validation is two-phase: :meth:`AggregateSpec.parse` checks shape and
bounds with no parser in hand;
:meth:`AggregateSpec.validate_for` checks field existence and merge-group
compatibility against a built parser.  The canonical JSON key
(:meth:`canonical_key`) keys the per-parser aggregate-executor cache, so
two calls with the same spec share one executor and two with different
specs never collide.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field as dataclass_field
from typing import Any, List, Optional, Sequence, Tuple

LONG_MAX = (1 << 63) - 1
LONG_MIN = -(1 << 63)

MAX_OPS = 16
MAX_EDGES = 64
MAX_TOP_K = 1000

_OPS = ("count", "count_by", "top_k", "sum", "histogram", "time_bucket")


@dataclass(frozen=True)
class AggOp:
    """One aggregation operation (validated)."""

    op: str
    field: str = ""
    k: int = 0
    edges: Tuple[int, ...] = ()
    width_s: int = 0

    def as_dict(self) -> dict:
        d: dict = {"op": self.op}
        if self.field:
            d["field"] = self.field
        if self.op == "top_k":
            d["k"] = self.k
        if self.op == "histogram":
            d["edges"] = list(self.edges)
        if self.op == "time_bucket":
            d["width_s"] = self.width_s
        return d


@dataclass(frozen=True)
class AggregateSpec:
    """An ordered, validated list of :class:`AggOp`."""

    ops: Tuple[AggOp, ...] = dataclass_field(default_factory=tuple)

    @classmethod
    def parse(cls, obj: Any) -> "AggregateSpec":
        """Shape-validate an ``aggregate:`` payload (list of op dicts).
        Raises ``ValueError`` with a caller-safe message on any problem."""
        if not isinstance(obj, (list, tuple)) or not obj:
            raise ValueError("aggregate: need a non-empty list of op objects")
        if len(obj) > MAX_OPS:
            raise ValueError(f"aggregate: at most {MAX_OPS} ops per spec")
        ops: List[AggOp] = []
        for i, raw in enumerate(obj):
            if not isinstance(raw, dict):
                raise ValueError(f"aggregate[{i}]: need an object")
            op = raw.get("op")
            if op not in _OPS:
                raise ValueError(
                    f"aggregate[{i}]: unknown op {op!r} (one of {_OPS})"
                )
            extra = set(raw) - {"op", "field", "k", "edges", "width_s"}
            if extra:
                raise ValueError(
                    f"aggregate[{i}]: unknown keys {sorted(extra)}"
                )
            field = raw.get("field", "")
            if op == "count":
                if field:
                    raise ValueError("aggregate: count takes no field")
                ops.append(AggOp("count"))
                continue
            if not isinstance(field, str) or not field:
                raise ValueError(f"aggregate[{i}]: {op} needs a field")
            if field.endswith(".*"):
                raise ValueError(
                    f"aggregate[{i}]: wildcard fields cannot be aggregated"
                )
            if op == "top_k":
                k = raw.get("k")
                if not isinstance(k, int) or isinstance(k, bool) \
                        or not 1 <= k <= MAX_TOP_K:
                    raise ValueError(
                        f"aggregate[{i}]: top_k needs 1 <= k <= {MAX_TOP_K}"
                    )
                ops.append(AggOp("top_k", field, k=k))
            elif op == "histogram":
                edges = raw.get("edges")
                if (
                    not isinstance(edges, (list, tuple)) or not edges
                    or len(edges) > MAX_EDGES
                    or any(
                        not isinstance(e, int) or isinstance(e, bool)
                        or not LONG_MIN <= e <= LONG_MAX
                        for e in edges
                    )
                    or any(b <= a for a, b in zip(edges, edges[1:]))
                ):
                    raise ValueError(
                        f"aggregate[{i}]: histogram needs 1..{MAX_EDGES} "
                        "strictly-increasing int64 edges"
                    )
                ops.append(AggOp("histogram", field, edges=tuple(edges)))
            elif op == "time_bucket":
                w = raw.get("width_s")
                if not isinstance(w, int) or isinstance(w, bool) \
                        or not 1 <= w <= 86400 * 366:
                    raise ValueError(
                        "aggregate: time_bucket needs width_s in "
                        "[1, 86400*366] whole seconds"
                    )
                ops.append(AggOp("time_bucket", field, width_s=w))
            else:  # count_by / sum
                ops.append(AggOp(op, field))
        return cls(tuple(ops))

    def validate_for(self, parser) -> None:
        """Field-level validation against a built TorchBatchParser: every
        named field must be requested, and its merged column group must
        fit the op (string groups for count_by/top_k, numeric groups for
        sum/histogram/time_bucket)."""
        requested = set(parser.requested)
        for i, op in enumerate(self.ops):
            if not op.field:
                continue
            if op.field not in requested:
                raise ValueError(
                    f"aggregate[{i}]: field {op.field!r} is not in the "
                    "parser's requested fields"
                )
            merged = parser.plan_by_id[op.field]
            group = parser._plan_group(merged)
            if op.op in ("count_by", "top_k"):
                if group not in ("span", "host", "obj"):
                    raise ValueError(
                        f"aggregate[{i}]: {op.op} needs a string field, "
                        f"{op.field!r} is {group}"
                    )
            else:
                if group not in ("numeric", "host"):
                    raise ValueError(
                        f"aggregate[{i}]: {op.op} needs a numeric field, "
                        f"{op.field!r} is {group}"
                    )

    def fields(self) -> List[str]:
        """Distinct fields the spec reads, in first-use order."""
        out: List[str] = []
        for op in self.ops:
            if op.field and op.field not in out:
                out.append(op.field)
        return out

    def canonical_key(self) -> str:
        """Deterministic JSON of the normalized spec — the cache key."""
        return json.dumps(
            [op.as_dict() for op in self.ops],
            sort_keys=True, separators=(",", ":"),
        )

    @classmethod
    def from_canonical(cls, key: str) -> "AggregateSpec":
        return cls.parse(json.loads(key))


def parse_aggregate_config(value: Any) -> Optional[AggregateSpec]:
    """The public boundary: None passes through, a JSON string is decoded
    first, anything else must be the op list itself."""
    if value is None:
        return None
    if isinstance(value, AggregateSpec):
        return value
    if isinstance(value, str):
        try:
            value = json.loads(value)
        except Exception as e:
            raise ValueError(f"aggregate: not valid JSON: {e}") from None
    return AggregateSpec.parse(value)


def spec_tuple(spec: Optional[AggregateSpec]) -> Optional[str]:
    """Hashable form for parser-cache keys (None stays None)."""
    return None if spec is None else spec.canonical_key()


__all__ = [
    "AggOp", "AggregateSpec", "parse_aggregate_config", "spec_tuple",
    "LONG_MAX", "LONG_MIN", "MAX_OPS", "MAX_EDGES", "MAX_TOP_K",
]
