"""Telemetry spine of the port: metrics registry, stage tracing, capped
logging, build info.

The port's copy of the reference package's ``observability.py``, with the
same metric names (``stage_seconds{stage}``, ``device_faults_total{kind}``,
``compile_cache_*``, ``hostpool_*``, ``ipc_bytes_out_total`` ...), so the
serving tiers' dashboards read the same series from either package:

- :class:`CounterRegistry` -- the Hadoop-style "Lines read / Good lines /
  Bad lines" trio (:func:`counters`);
- :class:`MetricsRegistry` -- labeled counters, gauges and bounded-bucket
  histograms with p50 / p99 and a Prometheus text renderer
  (:func:`metrics`); every hot-path stage feeds it through
  :func:`pipeline_stage` / :func:`observe_stage` once per batch, never per
  line;
- :class:`Tracer` -- per-stage wall-time accounting, enabled by
  :func:`enable_tracing` or ``LOGPARSER_TPU_TRACE=1``;
- :class:`CappedLogger` and :func:`log_warning_once` -- capped error
  logging (10 lines, then counted) and once-per-process warnings;
- stage annotations: where a card is present every :func:`pipeline_stage`
  span is an NVTX range ``lp.<stage>`` (``torch.cuda.nvtx.range_push`` /
  ``range_pop``, about a microsecond a batch), so a profiler timeline
  carries host scopes named like the registry's stages; on the CPU it is
  nothing;
- :func:`profile` -- ``torch.profiler.profile`` around a block, its
  trace written to a directory (TensorBoard / Chrome trace readable).
"""
from __future__ import annotations

import bisect
import contextlib
import logging
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

LOG = logging.getLogger(__name__)


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes")


# ---------------------------------------------------------------------------
# stage tracing
# ---------------------------------------------------------------------------


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    last_s: float = 0.0
    items: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "calls": self.calls,
            "total_s": round(self.total_s, 6),
            "last_s": round(self.last_s, 6),
            "items": self.items,
        }


class Tracer:
    """Per-stage wall-clock accounting.  Disabled tracers cost one attribute
    check per stage; timing only happens when enabled."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.stages: Dict[str, StageStats] = {}
        # parse_batch runs on concurrent service threads; stats updates are
        # read-modify-write and must not interleave.
        self._lock = threading.Lock()

    def _record(self, name: str, seconds: float, items: int) -> None:
        with self._lock:
            stats = self.stages.setdefault(name, StageStats())
            stats.calls += 1
            stats.total_s += seconds
            stats.last_s = seconds
            stats.items += items

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._record(name, time.perf_counter() - t0, items)

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        """Manual accounting for spans that don't nest as a with-block."""
        if not self.enabled:
            return
        self._record(name, seconds, items)

    def reset(self) -> None:
        with self._lock:
            self.stages.clear()

    def report(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            snapshot = {name: s.as_dict() for name, s in self.stages.items()}
        return dict(sorted(snapshot.items()))

    def pretty(self) -> str:
        with self._lock:
            stages = {
                name: (s.calls, s.total_s, s.items)
                for name, s in self.stages.items()
            }
        if not stages:
            return "(no stages recorded)"
        width = max(len(n) for n in stages)
        lines = []
        for name, (calls, total_s, items) in sorted(
            stages.items(), key=lambda kv: -kv[1][1]
        ):
            rate = f"  {items / total_s:12.0f} items/s" if items and total_s else ""
            lines.append(
                f"{name:<{width}}  {calls:6d} calls  {total_s * 1000:10.2f} ms{rate}"
            )
        return "\n".join(lines)


_GLOBAL_TRACER = Tracer(enabled=_env_truthy("LOGPARSER_TPU_TRACE"))


def tracer() -> Tracer:
    return _GLOBAL_TRACER


def enable_tracing() -> Tracer:
    _GLOBAL_TRACER.enabled = True
    return _GLOBAL_TRACER


def disable_tracing() -> Tracer:
    _GLOBAL_TRACER.enabled = False
    return _GLOBAL_TRACER


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace around a block -- the card's
    kernels and copies beside the host's calls, the device-side
    complement of the host Tracer -- written as a trace file into
    ``log_dir`` (TensorBoard's profiler plugin and chrome://tracing read
    it).  The card's activity is recorded where CUDA is available."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


# ---------------------------------------------------------------------------
# metrics registry: counters + gauges + bounded-bucket histograms
# ---------------------------------------------------------------------------

# Wall-time buckets (seconds) sized for batch-stage latencies: sub-ms host
# stages up through multi-second tunneled transfers.  +Inf is implicit.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# Row-count buckets for batch-size histograms (the bench/service batch
# spectrum: record-reader micro-batches up to the 64k headline and beyond).
BATCH_ROWS_BUCKETS: Tuple[float, ...] = (
    64, 256, 1024, 4096, 16384, 65536, 262144,
)

# Labels as a canonical sorted tuple — the registry's internal key part.
LabelsT = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, str]]) -> LabelsT:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(labels: LabelsT, extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = list(labels) + list(extra or ())
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _series_name(name: str, labels: LabelsT) -> str:
    return name + _format_labels(labels)


_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize an internal metric name into the Prometheus grammar
    ([a-zA-Z_:][a-zA-Z0-9_:]*): lowercase, runs of other bytes -> '_'."""
    out = _PROM_NAME_RE.sub("_", name.strip().lower())
    if not out or out[0].isdigit():
        out = "_" + out
    return out


class Histogram:
    """Bounded-bucket histogram: fixed upper bounds (+Inf implicit), count,
    sum, observed min/max.  Percentiles interpolate linearly inside the
    bucket that holds the target rank — the min/max tighten the open-ended
    first and last buckets, so p50/p99 stay meaningful even when every
    observation lands in one bucket."""

    __slots__ = ("name", "labels", "buckets", "_counts", "count", "sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, labels: LabelsT = (),
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.labels = labels
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) by in-bucket interpolation;
        0.0 when nothing was observed."""
        with self._lock:
            return _interp_percentile(
                self.buckets, self._counts, self.count,
                self._min, self._max, q,
            )

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            count, total = self.count, self.sum
            mn, mx = self._min, self._max
        p50 = _interp_percentile(self.buckets, counts, count, mn, mx, 0.5)
        p99 = _interp_percentile(self.buckets, counts, count, mn, mx, 0.99)
        return {
            "count": count,
            "sum": round(total, 6),
            "min": round(mn if count else 0.0, 6),
            "max": round(mx if count else 0.0, 6),
            "p50": round(p50, 6),
            "p99": round(p99, 6),
            "buckets": [
                [b, c] for b, c in zip(list(self.buckets) + ["+Inf"], counts)
            ],
        }


def _interp_percentile(buckets: Tuple[float, ...], counts: Sequence[int],
                       count: int, mn: float, mx: float, q: float) -> float:
    """The single percentile implementation, over an already-consistent
    (buckets, counts, count, min, max) view — callers hold or copied the
    histogram state."""
    if count == 0:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = buckets[i - 1] if i > 0 else min(mn, buckets[0])
            hi = buckets[i] if i < len(buckets) else mx
            lo = max(lo, mn)
            hi = min(hi, mx)
            if hi <= lo:
                return hi
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return mx  # unreachable unless counts drifted


class CounterRegistry:
    """Process-wide named counters (the Hadoop Counter analogue); adapters
    keep their own per-reader Counters, this aggregates across them."""

    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def increment(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


class MetricsRegistry:
    """The full metrics registry (CounterRegistry promoted): labeled
    counters, gauges, and bounded-bucket histograms, with a Prometheus text
    renderer and a structured :meth:`snapshot`.

    One instance is the process-wide spine (:func:`metrics`): the batch
    pipeline, the host pool, the Arrow bridge and the sidecar service all
    write into it; a serving tier's ``/metrics`` endpoint and a
    benchmark's delivery breakdown read from it — same metric
    definitions everywhere.  All updates are batch-granularity (hot loops
    never touch it per line) and lock-guarded (service threads are
    concurrent)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelsT], float] = {}
        self._gauges: Dict[Tuple[str, LabelsT], float] = {}
        self._hists: Dict[Tuple[str, LabelsT], Histogram] = {}

    # -- counters (monotonic) -------------------------------------------

    def increment(self, name: str, delta: float = 1,
                  labels: Optional[Dict[str, str]] = None) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + delta

    def get(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get((name, _labels_key(labels)), 0)

    # -- gauges ----------------------------------------------------------

    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[(name, _labels_key(labels))] = float(value)

    def gauge_add(self, name: str, delta: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._gauges[key] = self._gauges.get(key, 0.0) + delta

    def gauge_get(self, name: str,
                  labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._gauges.get((name, _labels_key(labels)), 0.0)

    # -- histograms ------------------------------------------------------

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create: bucket bounds are fixed at first creation."""
        key = (name, _labels_key(labels))
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = Histogram(
                    name, key[1], buckets or DEFAULT_TIME_BUCKETS
                )
        return hist

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Optional[Sequence[float]] = None) -> None:
        self.histogram(name, labels, buckets).observe(value)

    # -- views -----------------------------------------------------------

    def as_dict(self) -> Dict[str, float]:
        """Counters only, formatted names (CounterRegistry-compatible)."""
        with self._lock:
            return {_series_name(n, lb): v for (n, lb), v in self._counters.items()}

    def snapshot(self) -> Dict[str, Any]:
        """Structured registry state: {"counters", "gauges", "histograms"}
        keyed by formatted series name (labels inline)."""
        with self._lock:
            counters = {
                _series_name(n, lb): v for (n, lb), v in self._counters.items()
            }
            gauges = {
                _series_name(n, lb): v for (n, lb), v in self._gauges.items()
            }
            hists = list(self._hists.items())
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": {
                _series_name(n, lb): h.as_dict()
                for (n, lb), h in sorted(hists, key=lambda kv: kv[0])
            },
        }

    def stage_breakdown(self) -> Dict[str, Dict[str, Any]]:
        """Per-pipeline-stage summary from the ``stage_seconds`` histograms
        (+ the ``stage_items_total`` counters): the SINGLE definition the
        /metrics endpoint, a STATS frame and a benchmark's delivery section
        all derive from — same stage names everywhere."""
        with self._lock:
            hists = [
                (lb, h) for (n, lb), h in self._hists.items()
                if n == "stage_seconds"
            ]
            items = {
                lb: v for (n, lb), v in self._counters.items()
                if n == "stage_items_total"
            }
        out: Dict[str, Dict[str, Any]] = {}
        for lb, h in hists:
            stage = dict(lb).get("stage", "?")
            d = h.as_dict()
            entry = {
                "calls": d["count"],
                "total_s": d["sum"],
                "p50_ms": round(d["p50"] * 1000.0, 3),
                "p99_ms": round(d["p99"] * 1000.0, 3),
            }
            n_items = items.get(lb, 0)
            if n_items:
                entry["items"] = int(n_items)
                if d["sum"] > 0:
                    entry["items_per_sec"] = round(n_items / d["sum"], 1)
            out[stage] = entry
        return dict(sorted(out.items()))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- Prometheus text exposition (version 0.0.4) ----------------------

    def prometheus_text(self, prefix: str = "logparser_tpu_") -> str:
        """Render the registry as Prometheus text exposition.  Counter
        names gain a ``_total`` suffix when missing (exposition
        convention); all names are sanitized into the metric-name
        grammar."""
        # Every exposition identifies its producer's build: value-1 info
        # gauge, refreshed per render so it survives reset() and a fleet
        # merge shows each sidecar's version/torch in one scrape.
        self.gauge_set("build_info", 1.0, labels=build_info())
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items(), key=lambda kv: kv[0])
        lines: List[str] = []

        def emit_family(kind: str, series: List[Tuple[Tuple[str, LabelsT], float]],
                        suffix_total: bool) -> None:
            by_base: Dict[str, List[Tuple[LabelsT, float]]] = {}
            for (name, lb), value in series:
                base = prefix + _prom_name(name)
                if suffix_total and not base.endswith("_total"):
                    base += "_total"
                by_base.setdefault(base, []).append((lb, value))
            for base in sorted(by_base):
                lines.append(f"# TYPE {base} {kind}")
                for lb, value in by_base[base]:
                    lines.append(f"{base}{_format_labels(lb)} {_render_num(value)}")

        emit_family("counter", counters, suffix_total=True)
        emit_family("gauge", gauges, suffix_total=False)

        by_base_h: Dict[str, List[Tuple[LabelsT, Histogram]]] = {}
        for (name, lb), h in hists:
            by_base_h.setdefault(prefix + _prom_name(name), []).append((lb, h))
        for base in sorted(by_base_h):
            lines.append(f"# TYPE {base} histogram")
            for lb, h in by_base_h[base]:
                with h._lock:
                    counts = list(h._counts)
                    count, total = h.count, h.sum
                cum = 0
                for bound, c in zip(list(h.buckets) + [float("inf")], counts):
                    cum += c
                    le = "+Inf" if bound == float("inf") else _render_num(bound)
                    lines.append(
                        f"{base}_bucket{_format_labels(lb, [('le', le)])} {cum}"
                    )
                lines.append(f"{base}_sum{_format_labels(lb)} {_render_num(total)}")
                lines.append(f"{base}_count{_format_labels(lb)} {count}")
        return "\n".join(lines) + "\n"


def _render_num(value: float) -> str:
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(float(value)) if isinstance(value, float) else str(value)


_GLOBAL_COUNTERS = CounterRegistry()
_GLOBAL_METRICS = MetricsRegistry()


def counters() -> CounterRegistry:
    """The Hadoop-style job-aggregate counter trio fed by record readers
    (kept separate from :func:`metrics` so its ``as_dict`` stays exactly
    the reference's three-counter surface)."""
    return _GLOBAL_COUNTERS


def metrics() -> MetricsRegistry:
    """The process-wide telemetry registry (see :class:`MetricsRegistry`)."""
    return _GLOBAL_METRICS


def counter_sum(name: str) -> float:
    """Total of one counter family across all label sets — the drills'
    "did this family move" helper (bench/smoke/tests share it so the
    formatted-series key shape has one consumer-side home)."""
    return sum(
        v for k, v in _GLOBAL_METRICS.as_dict().items()
        if k == name or k.startswith(name + "{")
    )


# ---------------------------------------------------------------------------
# pipeline-stage instrumentation: registry (always) + tracer (when enabled)
# + NVTX range (where a card is present)
# ---------------------------------------------------------------------------

# Canonical hot-path stage names: the batch pipeline
# emits exactly these via pipeline_stage/observe_stage; a benchmark's delivery
# breakdown and the NVTX ranges reuse them verbatim.
PIPELINE_STAGES = (
    "encode",            # [B, L] uint8 packing (native framer / per-line)
    "h2d_stage",         # staged async upload enqueue (stream double-buffer)
    "device",            # fused-executor dispatch (kernel time when tracing)
    "fetch",             # packed D2H of the device verdict rows
    "columns",           # packed rows -> typed numpy columns
    "csr_materialize",   # wildcard CSR segment table -> dicts/spans
    "oracle_fallback",   # host per-line engine over routed lines
    "assembly",          # BatchResult -> pyarrow Table (hostpool fan-out)
    "ipc",               # Arrow IPC stream serialization
    "aggregate",         # analytics pushdown: partial fetch + host fold
)

_NVTX: Dict[str, Any] = {}


def _nvtx():
    """torch.cuda.nvtx where a card is present, else None (resolved once
    a process)."""
    if "mod" not in _NVTX:
        mod = None
        try:
            import torch

            if torch.cuda.is_available():
                mod = torch.cuda.nvtx
        except Exception:  # noqa: BLE001 -- annotation is best-effort
            pass
        _NVTX["mod"] = mod
    return _NVTX["mod"]


# A sink for completed stages (a sampled batch scope of the serving tiers'
# tracing installs one): turns completed stages into child
# spans of the live shared-batch span.  A plain module-global read keeps
# the disabled hot path at one load+compare — and observability never
# imports tracing (the dependency points one way).
_STAGE_SPAN_SINK: Optional[Callable[[str, float, int], None]] = None


def set_stage_span_sink(
    sink: Optional[Callable[[str, float, int], None]],
) -> None:
    global _STAGE_SPAN_SINK
    _STAGE_SPAN_SINK = sink


def observe_stage(name: str, seconds: float, items: int = 0) -> None:
    """Record one completed stage span: always into the metrics registry
    (stage_seconds histogram + stage_items_total counter), and into the
    global Tracer when tracing is enabled.  Batch granularity only."""
    _GLOBAL_METRICS.observe("stage_seconds", seconds, labels={"stage": name})
    if items:
        _GLOBAL_METRICS.increment(
            "stage_items_total", items, labels={"stage": name}
        )
    if _GLOBAL_TRACER.enabled:
        _GLOBAL_TRACER._record(name, seconds, items)
    sink = _STAGE_SPAN_SINK
    if sink is not None:
        sink(name, seconds, items)


@contextlib.contextmanager
def pipeline_stage(name: str, items: int = 0) -> Iterator[None]:
    """Instrument one hot-path stage at batch granularity: one
    perf_counter pair + one histogram update per batch (a few us against
    multi-ms batches), plus the NVTX range where a card is present."""
    nvtx = _nvtx()
    if nvtx is not None:
        try:
            nvtx.range_push(f"lp.{name}")
        except Exception:  # noqa: BLE001 -- annotation is best-effort
            nvtx = None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()
        observe_stage(name, time.perf_counter() - t0, items)


def record_batch_shape(rows: int, padded_rows: int, line_len: int,
                       line_bytes: int) -> None:
    """Batch-shape accounting shared by both ingest paths (list encode and
    blob framing): batch-size histogram + pad-waste counters.  Pad waste =
    1 - encoded_line_bytes_total / buffer_cells_total (row padding to the
    bucket AND per-line right-padding to L both count)."""
    reg = _GLOBAL_METRICS
    reg.increment("parse_batches_total")
    reg.increment("parse_lines_total", rows)
    reg.observe("batch_rows", rows, buckets=BATCH_ROWS_BUCKETS)
    if padded_rows > rows:
        reg.increment("pad_rows_total", padded_rows - rows)
    reg.increment("encoded_line_bytes_total", int(line_bytes))
    reg.increment("buffer_cells_total", int(padded_rows) * int(line_len))


# ---------------------------------------------------------------------------
# capped error logging (RecordReader :228-267 caps at 10 lines)
# ---------------------------------------------------------------------------


class CappedLogger:
    """Log at most ``cap`` errors, then one suppression notice, then count
    silently; ``suppressed`` holds the overflow for end-of-run reporting."""

    def __init__(self, logger: logging.Logger, cap: int = 10):
        self._logger = logger
        self.cap = cap
        self.logged = 0
        self.suppressed = 0

    def error(self, msg: str, *args: Any) -> None:
        if self.logged < self.cap:
            self.logged += 1
            self._logger.error(msg, *args)
            if self.logged == self.cap:
                self._logger.error(
                    "Max number of displayed errors (%d) reached; "
                    "further bad lines are counted but not logged.",
                    self.cap,
                )
        else:
            self.suppressed += 1

    def warning(self, msg: str, *args: Any) -> None:
        """The warning-level twin of :meth:`error` (same cap + notice +
        silent count), for repeating non-fatal messages."""
        if self.logged < self.cap:
            self.logged += 1
            self._logger.warning(msg, *args)
            if self.logged == self.cap:
                self._logger.warning(
                    "Max number of displays (%d) of this warning reached; "
                    "further repeats are counted but not logged.",
                    self.cap,
                )
        else:
            self.suppressed += 1


# Per-message cap-1 warning loggers: a message repeated by every parser
# assembly/worker (e.g. the localized-timestamp support warning that spammed
# a log tail once per format compile) prints ONCE per process, then
# only counts.  The counts surface through suppressed_warning_counts(), the
# metrics registry, and a serving tier's periodic stats line.
_WARN_ONCE_LOCK = threading.Lock()
_WARN_ONCE: Dict[str, CappedLogger] = {}


def log_warning_once(logger: logging.Logger, message: str) -> None:
    """Emit ``message`` at WARNING level at most once per process; later
    repeats are counted (suppressed_warning_counts) not printed."""
    with _WARN_ONCE_LOCK:
        capped = _WARN_ONCE.get(message)
        if capped is None:
            capped = _WARN_ONCE[message] = CappedLogger(logger, cap=1)
    capped.warning("%s", message)
    if capped.suppressed:
        _GLOBAL_METRICS.increment("suppressed_warnings_total")


def note_teardown(logger: logging.Logger, counter: str, site: str,
                  detail: str) -> None:
    """Teardown/cleanup failures must never be silent: count them under
    ``counter{site=...}`` and warn once per distinct message.  The
    generic form of the feeder's ``note_teardown_error`` escalation
    idiom, shared by the serving tier
    (``service_teardown_errors_total``): a leaked session thread or a
    join that times out, repeated across restarts, is exactly the drip
    a long-lived host needs to see."""
    _GLOBAL_METRICS.increment(counter, labels={"site": site})
    log_warning_once(logger, f"teardown: {site}: {detail}")


def suppressed_warning_counts() -> Dict[str, int]:
    """{message: suppressed repeat count} for every once-logged warning
    that repeated — the end-of-run summary companion of
    :func:`log_warning_once`."""
    with _WARN_ONCE_LOCK:
        return {
            msg: c.suppressed for msg, c in _WARN_ONCE.items() if c.suppressed
        }


def reset_warning_once(message: Optional[str] = None) -> None:
    """Forget once-logged state (tests; ``None`` clears everything)."""
    with _WARN_ONCE_LOCK:
        if message is None:
            _WARN_ONCE.clear()
        else:
            _WARN_ONCE.pop(message, None)


# ---------------------------------------------------------------------------
# version banner (HttpdLoglineParser.java:54-94)
# ---------------------------------------------------------------------------

_BANNER_LOGGED = False


def build_info() -> Dict[str, str]:
    """The banner's raw facts as exposition labels: package version and
    the torch / CUDA runtime versions IF some other component already
    imported torch (no card is touched here)."""
    import sys

    from . import __version__

    torch_mod = sys.modules.get("torch")
    version = getattr(torch_mod, "__version__", None)
    cuda = getattr(getattr(torch_mod, "version", None), "cuda", None)
    return {
        "version": str(__version__),
        "torch": str(version) if version is not None else "unimported",
        "cuda": str(cuda) if cuda is not None else "none",
    }


def version_banner() -> str:
    info = build_info()
    content = [
        f"logparser_tpu_torch {info['version']} — access log parsing on CUDA",
        "torch not imported yet" if info["torch"] == "unimported"
        else f"torch {info['torch']} (CUDA {info['cuda']})",
    ]
    width = max(len(c) for c in content)
    border = "-" * (width + 2)
    lines = [f"/{border}\\"]
    lines.extend(f"| {c:<{width}} |" for c in content)
    lines.append(f"\\{border}/")
    return "\n".join(lines)


def log_version_banner_once(logger: Optional[logging.Logger] = None) -> None:
    global _BANNER_LOGGED
    if _BANNER_LOGGED:
        return
    log = logger or LOG
    if not log.isEnabledFor(logging.INFO):
        return  # don't build (or mark logged) until someone can see it
    _BANNER_LOGGED = True
    log.info("\n%s", version_banner())
