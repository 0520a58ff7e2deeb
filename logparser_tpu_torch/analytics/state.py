"""Host-side aggregate state: the exactness referee and the merge unit
(the port's own copy of the reference package's ``analytics/state.py``).

One :class:`AggregateState` holds the partial aggregates of any span of
work — a batch, a stream of batches — and merges associatively:
``merge(a, b)`` then ``merge(_, c)`` equals any other grouping, because
every op's carrier is a sum-monoid (counts, sums, count dicts).  top_k
deliberately carries the FULL count dict and applies the top-N selection
only at :meth:`summary` time — truncating partials would break
associativity (a key locally outside the top k can be globally inside).

The referee contract: :meth:`update_from_result` computes every op from
``BatchResult.to_pylist`` values — the same delivered-value surface the
row path serves — so "device aggregates equal referee aggregates" means
equality against what a row consumer would have aggregated themselves.

Serialization (:meth:`to_arrow` / :meth:`from_arrow`) is a three-column
Arrow table ``(op int32, key binary, value string)`` with rows in a
deterministic order and values as decimal ASCII — sums can exceed int64
once merged across shards, and byte-identical sidecars across
kill/resume and mesh widths are an acceptance gate, so the wire format
must be both unbounded and canonical.
"""
from __future__ import annotations

import io
from bisect import bisect_right
from typing import Any, Dict, List

import numpy as np

from .spec import AggregateSpec


def _canon_key(value: str) -> bytes:
    """Canonical key bytes of a delivered string value (delivered values
    are already ``errors="replace"``-decoded by the row path)."""
    return value.encode("utf-8", errors="replace")


class AggregateState:
    """Partial aggregates for one :class:`AggregateSpec`."""

    def __init__(self, spec: AggregateSpec):
        self.spec = spec
        self.data: List[Any] = []
        for op in spec.ops:
            if op.op == "count":
                self.data.append(0)
            elif op.op == "sum":
                self.data.append(0)
            elif op.op == "histogram":
                self.data.append([0] * (len(op.edges) + 1))
            elif op.op in ("count_by", "top_k"):
                self.data.append({})
            elif op.op == "time_bucket":
                self.data.append({})
            else:  # pragma: no cover - parse() guards the vocabulary
                raise AssertionError(op.op)

    # -- referee ---------------------------------------------------------

    def update_from_result(self, result) -> None:
        """Fold one parsed :class:`BatchResult` in, row by row, from the
        delivered-value surface (``valid`` + ``to_pylist``)."""
        n = result.lines_read
        if n == 0:
            return
        valid = result.valid
        cols: Dict[str, List[Any]] = {
            fid: result.to_pylist(fid) for fid in self.spec.fields()
        }
        for oi, op in enumerate(self.spec.ops):
            if op.op == "count":
                self.data[oi] += int(
                    sum(1 for i in range(n) if valid[i])
                )
                continue
            vals = cols[op.field]
            if op.op in ("count_by", "top_k"):
                acc = self.data[oi]
                for i in range(n):
                    if not valid[i]:
                        continue
                    v = vals[i]
                    if v is None:
                        continue
                    k = _canon_key(v if isinstance(v, str) else str(v))
                    acc[k] = acc.get(k, 0) + 1
            elif op.op == "sum":
                total = 0
                for i in range(n):
                    if valid[i] and vals[i] is not None:
                        total += int(vals[i])
                self.data[oi] += total
            elif op.op == "histogram":
                acc = self.data[oi]
                edges = op.edges
                for i in range(n):
                    if valid[i] and vals[i] is not None:
                        acc[bisect_right(edges, int(vals[i]))] += 1
            else:  # time_bucket
                acc = self.data[oi]
                w = op.width_s * 1000
                for i in range(n):
                    if valid[i] and vals[i] is not None:
                        b = int(vals[i]) // w
                        acc[b] = acc.get(b, 0) + 1

    # -- merge -----------------------------------------------------------

    def merge(self, other: "AggregateState") -> None:
        """Associative in-place merge of another partial over the SAME
        spec (canonical keys must match)."""
        if other.spec.canonical_key() != self.spec.canonical_key():
            raise ValueError("aggregate merge: spec mismatch")
        for oi, op in enumerate(self.spec.ops):
            if op.op in ("count", "sum"):
                self.data[oi] += other.data[oi]
            elif op.op == "histogram":
                mine, theirs = self.data[oi], other.data[oi]
                for b, v in enumerate(theirs):
                    mine[b] += v
            else:
                mine = self.data[oi]
                for k, v in other.data[oi].items():
                    mine[k] = mine.get(k, 0) + v

    # -- display ---------------------------------------------------------

    def summary(self) -> List[dict]:
        """Finalized per-op results (top_k applies its selection here:
        count desc, key asc — deterministic)."""
        out: List[dict] = []
        for oi, op in enumerate(self.spec.ops):
            d = op.as_dict()
            acc = self.data[oi]
            if op.op in ("count", "sum"):
                d["value"] = acc
            elif op.op == "histogram":
                d["bins"] = list(acc)
            elif op.op == "time_bucket":
                d["buckets"] = {
                    str(k): acc[k] for k in sorted(acc)
                }
            else:
                items = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))
                if op.op == "top_k":
                    items = items[: op.k]
                d["values"] = [
                    [k.decode("utf-8", errors="replace"), v]
                    for k, v in items
                ]
            out.append(d)
        return out

    # -- wire ------------------------------------------------------------

    def _rows(self):
        """(op_index, key_bytes, value_str) rows in canonical order."""
        rows = []
        for oi, op in enumerate(self.spec.ops):
            acc = self.data[oi]
            if op.op in ("count", "sum"):
                rows.append((oi, b"", str(acc)))
            elif op.op == "histogram":
                for b, v in enumerate(acc):
                    rows.append((oi, str(b).encode(), str(v)))
            elif op.op == "time_bucket":
                for b in sorted(acc):
                    rows.append((oi, str(b).encode(), str(acc[b])))
            else:
                for k in sorted(acc):
                    rows.append((oi, k, str(acc[k])))
        return rows

    def to_arrow(self):
        """The aggregate frame: (op int32, key binary, value string)."""
        import pyarrow as pa

        rows = self._rows()
        return pa.table(
            {
                "op": pa.array([r[0] for r in rows], type=pa.int32()),
                "key": pa.array([r[1] for r in rows], type=pa.binary()),
                "value": pa.array([r[2] for r in rows], type=pa.string()),
            }
        )

    def to_ipc_bytes(self) -> bytes:
        """The aggregate frame as an Arrow IPC stream."""
        import pyarrow as pa

        table = self.to_arrow()
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.getvalue()

    @classmethod
    def from_arrow(cls, table, spec: AggregateSpec) -> "AggregateState":
        state = cls(spec)
        ops = table.column("op").to_pylist()
        keys = table.column("key").to_pylist()
        values = table.column("value").to_pylist()
        for oi, key, value in zip(ops, keys, values):
            if not 0 <= oi < len(spec.ops):
                raise ValueError(f"aggregate frame: bad op index {oi}")
            op = spec.ops[oi]
            v = int(value)
            if op.op in ("count", "sum"):
                state.data[oi] += v
            elif op.op == "histogram":
                b = int(key)
                if not 0 <= b < len(state.data[oi]):
                    raise ValueError(f"aggregate frame: bad bin {b}")
                state.data[oi][b] += v
            elif op.op == "time_bucket":
                b = int(key)
                state.data[oi][b] = state.data[oi].get(b, 0) + v
            else:
                k = bytes(key)
                state.data[oi][k] = state.data[oi].get(k, 0) + v
        return state

    @classmethod
    def from_ipc_bytes(cls, blob: bytes,
                       spec: AggregateSpec) -> "AggregateState":
        import pyarrow as pa

        with pa.ipc.open_stream(io.BytesIO(blob)) as reader:
            return cls.from_arrow(reader.read_all(), spec)

    # -- equality (tests / drills) ---------------------------------------

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, AggregateState)
            and other.spec.canonical_key() == self.spec.canonical_key()
            and other._rows() == self._rows()
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"AggregateState({self.summary()!r})"


class AggregateOutcome:
    """One batch's aggregate result: the partial state plus the row
    accounting (the reference's good / bad counts, ``oracle_rows`` and the
    ``reject_items`` ledger, mirroring :class:`BatchResult`'s) and the
    pushdown accounting (rows the device finished, bytes fetched).

    ``needs_host`` are the batch rows the host oracle visited (during the
    fold replay); they are counted in ``state`` like every other row.
    ``reject_items`` are ``[(row, reason, raw bytes)]`` sorted by row and
    ``reject_rows`` their rows.  ``fold_rows`` counts the rows replayed
    through ``parse_batch``; ``row_path_d2h_bytes`` is what
    ``parse_batch`` would copy back for the same batch."""

    def __init__(self, state: AggregateState, lines_read: int,
                 good_lines: int, bad_lines: int, needs_host, reject_items,
                 device_rows: int, fold_rows: int, d2h_bytes: int,
                 row_path_d2h_bytes: int, stage_seconds: Dict[str, float]):
        self.state = state
        self.lines_read = lines_read
        self.good_lines = good_lines
        self.bad_lines = bad_lines
        self.needs_host = needs_host
        self.oracle_rows = len(needs_host)
        self.reject_items = reject_items
        self.reject_rows = np.asarray([row for row, _, _ in reject_items], dtype=np.int64)
        self.device_rows = device_rows
        self.fold_rows = fold_rows
        self.d2h_bytes = d2h_bytes
        self.row_path_d2h_bytes = row_path_d2h_bytes
        self.stage_seconds = stage_seconds
        # The fold replay's oracle share (BatchResult's keys).
        self.rescue_reasons: Dict[str, int] = {}
        self.rescue_wall_s = 0.0


def merge_states(spec: AggregateSpec,
                 states) -> AggregateState:
    """Fold an iterable of states (or None entries, skipped) into one."""
    total = AggregateState(spec)
    for s in states:
        if s is not None:
            total.merge(s)
    return total


__all__ = ["AggregateState", "AggregateOutcome", "merge_states"]
