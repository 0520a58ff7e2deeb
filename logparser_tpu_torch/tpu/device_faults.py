"""The device fault layer's pure machines.

``tpu/batch.py`` composes these around the port's executor.  An
out-of-memory error is recovered on the card (the batch's rows bisected);
every other device fault is counted, scored and raised to the caller,
typed: the parser never moves a batch off the card on its own.

- the typed fault vocabulary (:class:`DeviceOomError` and friends) and
  :func:`classify_device_error`, which maps what the CUDA path raises onto
  it: ``torch.cuda.OutOfMemoryError`` and a launch that returned
  ``cudaErrorMemoryAllocation`` are "oom"; a kernel that fails to build,
  load or bind is "compile"; everything else is "execute";
- :class:`DeviceFaultPolicy` -- the recovery knobs (bisect depth, clamp
  trigger, breaker threshold and cool-off);
- :class:`DeviceBreaker` -- the per-parser circuit breaker that refuses
  every batch (:class:`DeviceUnavailableError`, before any device work)
  after repeated faults until its cool-off, and for good after a build
  failure; a pure machine with an explicit ``now``;
- :func:`as_device_fault` -- which errors are the device's: a typed
  fault, torch's out-of-memory error, a CUDA runtime error torch raised;
  any other exception is the program's own and is never absorbed;
- :func:`run_with_deadline` -- the abandonable worker: a wait on the card
  that outlives its deadline raises :class:`DeviceWedgeError`;
- :func:`resolve_budget` / :func:`resolve_deadline` -- the
  ``LOGPARSER_TPU_DEVICE_BYTES_BUDGET`` / ``LOGPARSER_TPU_DEVICE_DEADLINE_S``
  fallbacks behind the ``TorchBatchParser`` arguments.

**Sticky CUDA errors.**  An illegal address, a misaligned access or a
trap in a kernel leaves the process's CUDA context unusable: every later
launch and copy fails the same way.  Such an error classifies as
"execute", like any transient fault: the batch's parse raises it, and
after ``breaker_threshold`` of them in a row the breaker opens, so later
batches are refused at once instead of retrying a context that cannot
recover.

**The deadline cannot cancel CUDA work.**  :func:`run_with_deadline`
abandons the waiting thread; it does not stop the kernel.  A truly hung
kernel keeps its stream, and work queued behind it on that stream waits
too; the breaker, not the retry, is what keeps later batches from
queueing behind it.

This module imports no torch at module level (it reads ``torch`` from
``sys.modules`` where a caller already imported it), so the chaos hooks
and the serving tiers can classify faults without a device runtime.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

#: Pre-allocation device-memory ceiling (bytes): validated before any
#: H2D copy or device allocation of a batch, answering a structured
#: :class:`DeviceBudgetError` instead of a CUDA out-of-memory error.
#: Unset/0 = disabled.
BUDGET_ENV = "LOGPARSER_TPU_DEVICE_BYTES_BUDGET"

#: Per-execution deadline (seconds) for the blocking side of a device
#: batch (the wait for its kernels and its packed D2H copy).  Unset/0 = disabled (no worker
#: thread on the hot path).
DEADLINE_ENV = "LOGPARSER_TPU_DEVICE_DEADLINE_S"


class DeviceFault(Exception):
    """Base class of every classified device-tier fault."""


class DeviceOomError(DeviceFault):
    """The card ran out of memory (an allocation or a launch)."""


class DeviceCompileError(DeviceFault):
    """A kernel failed to build, load or bind -- deterministic, so the
    parser is demoted for good: every later batch is refused (a warning
    once)."""


class DeviceWedgeError(DeviceFault):
    """A device execution exceeded its deadline (wedged kernel / hung
    transfer); the batch's parse raises it."""


class DeviceExecutionError(DeviceFault):
    """Any other device-side failure (a launch error, a sticky CUDA
    error, a copy that failed) -- transient until the breaker says
    otherwise."""


class DeviceUnavailableError(DeviceFault):
    """The parser's breaker refuses the batch before any device work:
    ``state`` is "open" (repeated faults; the device is tried again after
    the cool-off) or "demoted" (a kernel failed to build; for good)."""

    def __init__(self, state: str, detail: str = ""):
        self.state = state
        super().__init__(
            f"device path {state}: the batch was refused before any device "
            f"work ({detail or 'see device_fault_stats()'})")


class DeviceBudgetError(DeviceFault):
    """Structured pre-allocation reject: the batch's estimated device
    footprint exceeds the configured byte budget.  Raised before any H2D
    copy or device allocation of the batch -- the caller answers it as a
    structured reject instead of letting the card run out of memory."""

    def __init__(self, estimated_bytes: int, budget_bytes: int,
                 lines: int):
        self.estimated_bytes = int(estimated_bytes)
        self.budget_bytes = int(budget_bytes)
        self.lines = int(lines)
        super().__init__(
            f"device byte budget exceeded: batch of {lines} lines needs "
            f"~{self.estimated_bytes} device bytes, budget is "
            f"{self.budget_bytes} ({BUDGET_ENV} / device_bytes_budget)"
        )


#: CUDA runtime error codes the classifier reads from a typed launch
#: error (``kernels.KernelLaunchError.cuda_error``).
CUDA_ERROR_MEMORY_ALLOCATION = 2

# Message markers, lower-cased: the reference's (RESOURCE_EXHAUSTED and
# the allocators' phrasing) and CUDA's ("CUDA out of memory", "out of
# memory" from cudaGetErrorString).
_OOM_MARKERS = (
    "resource_exhausted", "resource exhausted", "out of memory", "oom",
    "failed to allocate",
)
# Deterministic build-side failures: retrying would fail identically, so
# these demote for good instead of scoring the breaker once.  Deliberately narrow:
# a misclassified transient would latch the permanent demotion, while a
# build failure misread as "execute" still demotes through the breaker
# after ``breaker_threshold`` repeats -- the safe direction.
_COMPILE_MARKERS = (
    "unimplemented", "compilation failure", "failed to compile",
    "error during lowering", "nvcc failed",
)


def classify_device_error(e: BaseException) -> str:
    """``"oom"`` | ``"compile"`` | ``"wedge"`` | ``"execute"`` for any
    exception the executor path can raise.  Typed :class:`DeviceFault`
    subclasses (the kernels' typed launch and build errors, and the chaos
    hooks' injected faults) classify by type; ``torch.cuda.OutOfMemoryError``
    and a typed launch error carrying ``cudaErrorMemoryAllocation`` are
    "oom"; other errors by message marker, defaulting to the transient
    "execute" (raised, and scored by the breaker) -- a sticky CUDA error
    such as an illegal address among them."""
    if isinstance(e, DeviceOomError):
        return "oom"
    if isinstance(e, DeviceCompileError):
        return "compile"
    if isinstance(e, DeviceWedgeError):
        return "wedge"
    if getattr(e, "cuda_error", None) == CUDA_ERROR_MEMORY_ALLOCATION:
        return "oom"
    if isinstance(e, DeviceExecutionError):
        return "execute"
    torch = sys.modules.get("torch")
    oom_type = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    if oom_type is not None and isinstance(e, oom_type):
        return "oom"
    msg = f"{type(e).__name__}: {e}".lower()
    if any(m in msg for m in _OOM_MARKERS):
        return "oom"
    if any(m in msg for m in _COMPILE_MARKERS):
        return "compile"
    return "execute"


def as_device_fault(e: BaseException) -> Optional[DeviceFault]:
    """``e`` as a typed :class:`DeviceFault` when it is a device error: a
    typed fault already (the kernels' launch and build errors, the chaos
    hooks', the deadline's), torch's out-of-memory error, or a CUDA
    runtime error torch raised ("CUDA error: ..."), typed by
    :func:`classify_device_error` with ``e`` as its cause.  None for any
    other exception: a shape or dtype check, a bug in the device path --
    the program's own, which the fault layer lets through as it is."""
    if isinstance(e, DeviceFault):
        return e
    torch = sys.modules.get("torch")
    oom_type = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    if not ((oom_type is not None and isinstance(e, oom_type))
            or (isinstance(e, RuntimeError) and "CUDA error" in str(e))):
        return None
    cls = {"oom": DeviceOomError, "compile": DeviceCompileError,
           "wedge": DeviceWedgeError}.get(classify_device_error(e), DeviceExecutionError)
    fault = cls(f"{type(e).__name__}: {e}")
    fault.__cause__ = e
    return fault


def resolve_budget(explicit: Optional[int]) -> Optional[int]:
    """The effective device byte budget: the explicit kwarg wins, else
    the env var; 0/absent/garbage = disabled (None)."""
    if explicit is not None:
        return int(explicit) or None
    raw = os.environ.get(BUDGET_ENV, "").strip()
    if not raw:
        return None
    try:
        return int(raw) or None
    except ValueError:
        return None


def resolve_deadline(explicit: Optional[float]) -> Optional[float]:
    """The effective per-execution deadline (seconds); 0/absent =
    disabled — the hot path then runs with no worker thread at all."""
    if explicit is not None:
        return float(explicit) or None
    raw = os.environ.get(DEADLINE_ENV, "").strip()
    if not raw:
        return None
    try:
        return float(raw) or None
    except ValueError:
        return None


@dataclass
class DeviceFaultPolicy:
    """Recovery tunables (all have safe defaults)."""

    #: Max bisect depth per batch on an out-of-memory error: each level
    #: halves the row range, so 4 levels retry down to B/16 before the
    #: out-of-memory error is raised.
    oom_retries: int = 4
    #: OOM events before the parser PERMANENTLY clamps the rows it
    #: executes at once below the failing size (``device_bucket_clamped``
    #: gauge): the first OOM is forgiven as transient; repetition is
    #: geometry.
    oom_clamp_after: int = 2
    #: Bisect floor — a batch that OOMs at/below this row count cannot
    #: be saved by splitting: the out-of-memory error is raised.
    min_bucket: int = 64
    #: Consecutive non-compile device faults before the breaker opens
    #: (every batch refused until the cool-off).
    breaker_threshold: int = 3
    #: Seconds an open breaker waits before re-admitting device batches
    #: (the half-open trial window).
    breaker_cooloff_s: float = 30.0


class DeviceBreaker:
    """Per-parser circuit breaker over the device path.

    closed -> (``threshold`` consecutive faults) -> open (every batch
    refused) -> after ``cooloff_s`` device batches are
    re-admitted; the first fault re-opens, the first success closes.
    ``record_fault(permanent=True)`` (a build failure) latches open
    forever -- retrying a deterministic build failure is pure waste.

    Thread-safe (one lock; a serving tier shares a parser across
    sessions) and a pure time machine: every method takes an explicit
    ``now`` so tests drive the clock.
    """

    def __init__(self, threshold: int = 3, cooloff_s: float = 30.0):
        self.threshold = max(1, int(threshold))
        self.cooloff_s = float(cooloff_s)
        self.consecutive = 0
        self.opened_at: Optional[float] = None
        self.permanent = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        if self.permanent:
            return "demoted"
        if self.opened_at is None:
            return "closed"
        return "open"

    def allow(self, now: Optional[float] = None) -> bool:
        """May the next batch try the device?  Read-only: open simply
        waits out the cool-off, then batches flow again (half-open by
        time, not by a single claimed trial — several stream batches may
        be in flight, and a still-broken device re-trips immediately)."""
        with self._lock:
            if self.permanent:
                return False
            if self.opened_at is None:
                return True
            now = time.monotonic() if now is None else now
            return (now - self.opened_at) >= self.cooloff_s

    def record_success(self, now: Optional[float] = None) -> None:
        with self._lock:
            if not self.permanent:
                self.consecutive = 0
                self.opened_at = None

    def record_fault(self, now: Optional[float] = None,
                     permanent: bool = False) -> bool:
        """One device fault landed.  Returns True exactly when THIS
        fault transitioned the breaker to open/demoted — the caller's
        cue to warn-once and count the demotion."""
        with self._lock:
            now = time.monotonic() if now is None else now
            if permanent:
                was = self.permanent
                self.permanent = True
                self.opened_at = now
                return not was
            if self.permanent:
                return False
            self.consecutive += 1
            if self.opened_at is not None:
                # Fault during/after the cool-off window: re-open.
                self.opened_at = now
                return False
            if self.consecutive >= self.threshold:
                self.opened_at = now
                return True
            return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_faults": self.consecutive,
            }


def run_with_deadline(work: Callable[[], Any], deadline_s: float,
                      label: str = "execute") -> Any:
    """Run ``work`` on an abandonable daemon worker; raise
    :class:`DeviceWedgeError` when it misses the deadline.  The worker
    keeps running (and logs nothing) after abandonment: a wait on the
    card cannot be cancelled, only walked away from, and the kernel it
    waits for keeps its stream."""
    box: dict = {}
    done = threading.Event()

    def run() -> None:
        try:
            box["value"] = work()
        except BaseException as e:  # noqa: BLE001 — relayed to the waiter
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, name=f"lp-device-{label}",
                         daemon=True)
    t.start()
    if not done.wait(deadline_s):
        raise DeviceWedgeError(
            f"device {label} exceeded its {deadline_s:.3f}s deadline "
            "(wedged execution abandoned; the kernel keeps its stream)"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]
