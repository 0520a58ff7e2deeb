"""The flight recorder: a crash-safe ring of the events that recover
silently.

The port's copy of the flight-recorder half of the reference package's
``tracing.py``: :class:`FlightRecorder` (an always-on bounded ring of
structured events, ``LOGPARSER_TPU_FLIGHT_EVENTS`` long, default 256),
:func:`flight_event` (what the device fault layer calls on every fault it
absorbs), :func:`flightz_payload` (the ``/flightz`` body), and
:func:`dump_flight` (an atomic ``flight-<pid>.json`` under
:func:`flight_dir`, ``$LOGPARSER_TPU_FLIGHT_DIR`` or a directory under
the system temp root).

The other half -- W3C trace contexts, head sampling, the span buffer,
``/tracez`` and the signal handlers that dump on SIGTERM / SIGUSR2 --
belongs to the serving tiers and comes with them (ROADMAP A11).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .observability import metrics

__all__ = [
    "FlightRecorder",
    "flight_recorder",
    "flight_event",
    "flightz_payload",
    "flight_dir",
    "flight_dump_path",
    "dump_flight",
]


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


class FlightRecorder:
    """Always-on bounded ring of recent structured events from sites
    that recover silently.  Recording is a dict build + deque append
    under a lock — cheap enough for fault paths (which are off the
    per-line hot path by construction)."""

    def __init__(self, maxlen: int = 256):
        self.maxlen = int(maxlen)
        self._events: deque = deque(maxlen=self.maxlen)
        self._lock = threading.Lock()
        self.total = 0

    def record(self, kind: str, **fields: Any) -> None:
        event = {"t": time.time(), "kind": str(kind)}
        for k, v in fields.items():
            # "t"/"kind" are reserved envelope keys — a payload field
            # must never overwrite the event's identity.
            if v is not None and k not in ("t", "kind"):
                event[k] = v if isinstance(v, (int, float, bool)) else str(v)
        with self._lock:
            self._events.append(event)
            self.total += 1
        metrics().increment("flight_events_total", labels={"kind": str(kind)})

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.total = 0


_FLIGHT = FlightRecorder(_env_int("LOGPARSER_TPU_FLIGHT_EVENTS", 256))


def flight_recorder() -> FlightRecorder:
    return _FLIGHT


def flight_event(kind: str, **fields: Any) -> None:
    """Record one flight-recorder event (module-level convenience; the
    silent-recovery sites call exactly this)."""
    _FLIGHT.record(kind, **fields)


def flightz_payload(reason: Optional[str] = None) -> Dict[str, Any]:
    payload: Dict[str, Any] = {
        "pid": os.getpid(),
        "argv0": sys.argv[0] if sys.argv else "",
        "events_total": _FLIGHT.total,
        "ring_maxlen": _FLIGHT.maxlen,
        "events": _FLIGHT.snapshot(),
    }
    if reason is not None:
        payload["dump_reason"] = reason
    return payload


def flight_dir() -> str:
    """The dump directory: ``$LOGPARSER_TPU_FLIGHT_DIR``, defaulting to
    a per-machine run directory under the system temp root (never the
    working directory of whatever CLI happened to start)."""
    base = os.environ.get("LOGPARSER_TPU_FLIGHT_DIR", "").strip()
    return base or os.path.join(tempfile.gettempdir(), "logparser_tpu_torch-flight")


def flight_dump_path(pid: Optional[int] = None) -> str:
    """Where a dump for ``pid`` (default: this process) lands:
    :func:`flight_dir` ``/flight-<pid>.json``."""
    return os.path.join(flight_dir(), f"flight-{pid or os.getpid()}.json")


def dump_flight(reason: str) -> Optional[str]:
    """Write the crash-safe dump; returns the path, or ``None`` if the
    write failed (a dying process must not die harder over telemetry).
    Atomic rename so a reader never sees a torn file."""
    path = flight_dump_path()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(flightz_payload(reason), fh, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        return None
