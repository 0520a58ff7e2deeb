"""Fault injection for the port's device fault layer.

A fault plan is a string, ``;``-separated faults, each a name followed by
``:key=value`` parameters, read from ``LOGPARSER_TPU_CHAOS`` or given to
``TorchBatchParser(device_chaos=...)`` / ``arm_device_chaos``::

    LOGPARSER_TPU_CHAOS="oom_batch:count=1;wedge_device:seconds=2"

The device faults (consulted once per device execution; a bisected retry
chunk is an execution too):

- ``oom_batch[:count=M][:min_lines=N][:after=K][:sticky=1]`` -- raise an
  injected :class:`~logparser_tpu_torch.tpu.device_faults.DeviceOomError`
  from executions of >= N lines (default 0 = every execution).  With
  ``min_lines`` set, bisected halves below it succeed (the OOM drill);
  ``sticky=1`` keeps firing (the clamp drill).
- ``wedge_device[:count=M][:seconds=X][:after=K]`` -- the execution
  sleeps X seconds (default 30) before its fetch: with the parser's
  execution deadline armed, the batch expires and goes to the host
  oracle.
- ``fail_compile[:count=M][:after=K]`` -- raise an injected
  :class:`~logparser_tpu_torch.tpu.device_faults.DeviceCompileError`: the
  parser demotes to the host oracle for good (a warning once, a counter),
  never raising out of the parse.

``after=K`` arms a fault only from the K+1-th execution on; ``count``
bounds how often a fault fires (default 1) unless ``sticky=1``.

The grammar is the reference package's, so a plan written for it parses
the same here: the feeder, writer, front and pod faults (``kill_worker``,
``io_error``, ``kill_sidecar``, ``preempt_host`` ...) parse, and are inert
until the tiers that arm them are ported (ROADMAP A11).  Nothing here
touches a card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: The environment variable the fault plan is read from.
CHAOS_ENV = "LOGPARSER_TPU_CHAOS"

_KNOWN = {
    "kill_worker", "poison_shard", "corrupt_descriptor",
    "slot_overflow", "drop_done", "delay_put",
    "io_error", "enospc",
    "kill_sidecar", "wedge_sidecar", "flap_sidecar",
    "oom_batch", "wedge_device", "fail_compile",
    "preempt_host",
}

#: Consumer-side fault kinds: armed by the durable-job writer.
IO_FAULTS = {"io_error", "enospc"}

#: Front-tier fault kinds: armed by the front tier's fleet supervision.
FRONT_FAULTS = {"kill_sidecar", "wedge_sidecar", "flap_sidecar"}

#: Device-tier fault kinds: armed by TorchBatchParser's fault layer.
DEVICE_FAULTS = {"oom_batch", "wedge_device", "fail_compile"}

#: Pod-tier fault kinds: armed by the pod runner's subprocess mode.
POD_FAULTS = {"preempt_host"}


@dataclass
class Fault:
    kind: str
    params: Dict[str, Any] = field(default_factory=dict)
    sticky: bool = False

    def param(self, key: str, default: Any = None) -> Any:
        return self.params.get(key, default)


@dataclass
class ChaosSpec:
    """A parsed fault plan (picklable — it rides Process args)."""

    faults: List[Fault] = field(default_factory=list)

    @classmethod
    def parse(cls, text: str) -> "ChaosSpec":
        faults: List[Fault] = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            name, *kvs = part.split(":")
            name = name.strip()
            if name not in _KNOWN:
                raise ValueError(
                    f"unknown chaos fault {name!r} (known: {sorted(_KNOWN)})"
                )
            params: Dict[str, Any] = {}
            for kv in kvs:
                k, _, v = kv.partition("=")
                k = k.strip()
                v = v.strip()
                try:
                    params[k] = int(v)
                except ValueError:
                    try:
                        params[k] = float(v)
                    except ValueError:
                        params[k] = v
            sticky = bool(params.pop("sticky", name == "poison_shard"))
            faults.append(Fault(name, params, sticky))
        return cls(faults)

    @classmethod
    def from_env(cls) -> Optional["ChaosSpec"]:
        raw = os.environ.get(CHAOS_ENV, "").strip()
        return cls.parse(raw) if raw else None

    def respawn_view(self) -> Optional["ChaosSpec"]:
        """The spec a RESPAWNED worker receives: sticky faults only.
        One-shot faults model transient failures — the respawn is the
        recovery, so it must not re-fire them."""
        sticky = [f for f in self.faults if f.sticky]
        return ChaosSpec(sticky) if sticky else None


class DeviceChaos:
    """Device-tier fault injection (``tpu/batch.py``'s fault layer):
    :meth:`on_execute` is consulted once per device execution -- the
    dispatch + fetch of one batch, and each bisected retry chunk -- and
    either raises an injected typed fault (oom / compile) or returns
    seconds to wedge (the execution sleeps, so an armed deadline expires
    exactly as on a hung kernel).  Every hook is a no-op when the spec
    carries no device faults.  The typed faults come from
    ``tpu.device_faults``, which touches no card."""

    def __init__(self, spec: ChaosSpec):
        self.faults = [f for f in spec.faults if f.kind in DEVICE_FAULTS]
        self._fired: Dict[int, int] = {}
        self.executions = 0

    def __bool__(self) -> bool:
        return bool(self.faults)

    def fired(self, kind: Optional[str] = None) -> int:
        """How many injections have fired (optionally of one kind) —
        drills assert recovery stopped re-triggering faults."""
        return sum(
            n for idx, n in self._fired.items()
            if kind is None or self.faults[idx].kind == kind
        )

    def on_execute(self, n_lines: int) -> Optional[float]:
        from ..tpu.device_faults import DeviceCompileError, DeviceOomError

        self.executions += 1
        for idx, f in enumerate(self.faults):
            fired = self._fired.get(idx, 0)
            if not f.sticky and fired >= int(f.param("count", 1)):
                continue
            if self.executions <= int(f.param("after", 0)):
                continue
            if f.kind == "oom_batch":
                if n_lines >= int(f.param("min_lines", 0)):
                    self._fired[idx] = fired + 1
                    raise DeviceOomError(
                        "chaos: injected CUDA out of memory executing a "
                        f"{n_lines}-line device batch"
                    )
            elif f.kind == "fail_compile":
                self._fired[idx] = fired + 1
                raise DeviceCompileError(
                    "chaos: injected kernel build failure"
                )
            elif f.kind == "wedge_device":
                self._fired[idx] = fired + 1
                return float(f.param("seconds", 30.0))
        return None
