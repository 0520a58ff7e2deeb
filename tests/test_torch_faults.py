"""The port's device fault layer on the CPU, held to the JAX package.

An out-of-memory error bisects the batch's rows on the device and
retries: ``to_dict()``, ``valid``, ``reject_reasons`` and the oracle's
rows equal an undisturbed ``TpuBatchParser``'s.  Where the reference
sends a batch to its host oracle instead, the port raises the fault to
the caller, typed and counted: a wedged wait past the deadline
(``DeviceWedgeError``), an out-of-memory error at ``min_bucket``, any
other launch error; a kernel that fails to build raises and demotes the
parser for good; repeated faults open the breaker, which refuses batches
(``DeviceUnavailableError``) until its cool-off.  A batch never leaves
the card on its own, and the same instance goes on serving every entry
point once the fault is gone.  An error that is not the device's (a
wrapper's own check) propagates as it is, uncounted.

- The pure machines (classifier, breaker, budget and deadline resolution,
  the chaos grammar and hooks) against the reference's on the same
  inputs; the classifier's CUDA rules (``torch.cuda.OutOfMemoryError``,
  a launch returning ``cudaErrorMemoryAllocation``, a build failure).
- The reference's parity drills (its ``tests/test_device_faults.py``) on
  its cheap format ``%h %u %>s``, one module-scoped reference parser.
  The port pads no batch to a power-of-two bucket, so where a count
  depends on batch geometry (the standing clamp) the test states the
  port's own value.
- The aggregate's share, a ``data_parallel=4`` parser on the CPU mesh,
  and the byte budget, which raises before any executor call.
"""
import time

import numpy as np
import pytest
import torch

from logparser_tpu.tools.chaos import ChaosSpec as RefChaosSpec
from logparser_tpu.tools.chaos import DeviceChaos as RefDeviceChaos
from logparser_tpu.tpu import device_faults as ref_faults
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.observability import counter_sum, metrics
from logparser_tpu_torch.parallel import mesh as mesh_mod
from logparser_tpu_torch.tools.chaos import ChaosSpec, DeviceChaos
from logparser_tpu_torch.tpu import kernels
from logparser_tpu_torch.tpu.device_faults import (
    DeviceBreaker,
    DeviceBudgetError,
    DeviceCompileError,
    DeviceExecutionError,
    DeviceFaultPolicy,
    DeviceOomError,
    DeviceUnavailableError,
    DeviceWedgeError,
    as_device_fault,
    classify_device_error,
    resolve_budget,
    resolve_deadline,
    run_with_deadline,
)
from logparser_tpu_torch.tpu.pipeline import estimate_device_bytes, packed_row_count
from logparser_tpu_torch.tracing import flight_recorder

FMT = "%h %u %>s"
FIELDS = ["IP:connection.client.host", "STRING:request.status.last"]
OPS = [{"op": "count"}, {"op": "count_by", "field": "STRING:request.status.last"},
       {"op": "top_k", "field": "IP:connection.client.host", "k": 3}]


def _lines(n):
    lines = [b"10.0.%d.%d u%d %d" % ((i >> 8) % 256, i % 256, i, 200 + i % 7)
             for i in range(n)]
    # A few the device rejects (the oracle's and the reject ledger's rows).
    for i, bad in ((7, b""), (100, b"not a line"), (250, b"1.2.3.4 - 99x")):
        if i < n:
            lines[i] = bad
    return lines


def _port(**kw):
    kw.setdefault("device_chaos", None)   # none from the environment
    return TorchBatchParser(FMT, FIELDS, device="cpu", **kw)


# ---------------------------------------------------------------------------
# pure machines, held to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 123 bytes"),
    lambda: ValueError("pjrt: failed to allocate buffer"),
    lambda: RuntimeError("UNIMPLEMENTED: cannot lower op"),
    lambda: RuntimeError("error during lowering of fused computation"),
    lambda: RuntimeError("device halted unexpectedly"),
    lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_classifier_markers_equal_the_reference(make):
    assert classify_device_error(make()) == ref_faults.classify_device_error(make())


@pytest.mark.parametrize("port_cls,ref_cls", [
    (DeviceOomError, ref_faults.DeviceOomError),
    (DeviceCompileError, ref_faults.DeviceCompileError),
    (DeviceWedgeError, ref_faults.DeviceWedgeError),
])
def test_typed_faults_classify_by_type(port_cls, ref_cls):
    # A typed fault classifies by its type, whatever its message says.
    assert classify_device_error(port_cls("out of memory")) == \
        ref_faults.classify_device_error(ref_cls("out of memory"))


def test_classifier_cuda_rules():
    """The CUDA path's errors: torch's out-of-memory error and a launch
    returning cudaErrorMemoryAllocation are "oom"; any other launch code
    -- a sticky illegal address included -- "execute"; a kernel that
    fails to build, load or bind "compile"."""
    assert classify_device_error(torch.cuda.OutOfMemoryError("CUDA")) == "oom"
    assert classify_device_error(kernels.KernelLaunchError("split: x (2)", 2)) == "oom"
    assert classify_device_error(kernels.KernelLaunchError("split: x (700)", 700)) == "execute"
    assert classify_device_error(kernels.KernelLaunchError("split: x (719)", 719)) == "execute"
    assert classify_device_error(kernels.KernelBuildError("nvcc not found")) == "compile"
    assert isinstance(kernels.KernelBuildError("x"), RuntimeError)


def test_library_that_fails_to_load_is_a_build_error(tmp_path, monkeypatch):
    bogus = tmp_path / "libsplit.so"
    bogus.write_bytes(b"not a shared library")
    monkeypatch.setattr(kernels, "build", lambda: {k: bogus for k in kernels.KERNELS})
    monkeypatch.setattr(kernels._BUILD, "libs", {})
    with pytest.raises(kernels.KernelBuildError) as ei:
        kernels._lib("split")
    assert classify_device_error(ei.value) == "compile"


def _drive(breaker, script):
    out = []
    for op, kw in script:
        if op == "fault":
            out.append(breaker.record_fault(**kw))
        elif op == "ok":
            breaker.record_success(**kw)
        else:
            out.append(breaker.allow(**kw))
        out.append(breaker.state)
    return out


@pytest.mark.parametrize("threshold,cooloff,script", [
    (2, 10.0, [("allow", {"now": 0.0}), ("fault", {"now": 0.0}), ("fault", {"now": 1.0}),
               ("allow", {"now": 5.0}), ("allow", {"now": 11.5})]),
    (1, 10.0, [("fault", {"now": 0.0}), ("allow", {"now": 1.0}), ("fault", {"now": 12.0}),
               ("allow", {"now": 13.0}), ("ok", {"now": 30.0}), ("allow", {"now": 30.0})]),
    (3, 0.001, [("fault", {"permanent": True}), ("fault", {"permanent": True}),
                ("allow", {"now": 1e9}), ("ok", {}), ("allow", {"now": 1e9})]),
])
def test_breaker_equals_the_reference(threshold, cooloff, script):
    ours = _drive(DeviceBreaker(threshold, cooloff), script)
    assert ours == _drive(ref_faults.DeviceBreaker(threshold, cooloff), script)
    assert DeviceBreaker(threshold, cooloff).stats().keys() == \
        ref_faults.DeviceBreaker(threshold, cooloff).stats().keys()


def test_deadline_runner():
    assert run_with_deadline(lambda: 7, 5.0) == 7
    with pytest.raises(ValueError):
        run_with_deadline(lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0)
    with pytest.raises(DeviceWedgeError):
        run_with_deadline(lambda: time.sleep(1.0), 0.05)


@pytest.mark.parametrize("raw", [None, "", "777", "0", "garbage", "1.5"])
def test_env_resolution_equals_the_reference(monkeypatch, raw):
    for env in ("LOGPARSER_TPU_DEVICE_BYTES_BUDGET", "LOGPARSER_TPU_DEVICE_DEADLINE_S"):
        if raw is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, raw)
    for explicit in (None, 12345, 0):
        assert resolve_budget(explicit) == ref_faults.resolve_budget(explicit)
        assert resolve_deadline(explicit) == ref_faults.resolve_deadline(explicit)
    assert DeviceFaultPolicy() == DeviceFaultPolicy(**vars(ref_faults.DeviceFaultPolicy()))


CHAOS_SPECS = [
    "oom_batch:count=1:min_lines=100",
    "wedge_device:seconds=2.5",
    "wedge_device:seconds=1:count=1:after=2",
    "fail_compile",
    " oom_batch:sticky=1 ; fail_compile:after=3 ;",
    "kill_worker:worker=1:after=3;delay_put:seconds=0.01",
    "poison_shard:shard=2;io_error:op=write:shard=1:sticky=1",
    "preempt_host:host=1:after=3;wedge_device:seconds=abc",
    "",
]


def _spec_tuple(spec):
    return [(f.kind, f.params, f.sticky) for f in spec.faults]


@pytest.mark.parametrize("text", CHAOS_SPECS)
def test_chaos_grammar_equals_the_reference(text):
    ours, ref = ChaosSpec.parse(text), RefChaosSpec.parse(text)
    assert _spec_tuple(ours) == _spec_tuple(ref)
    assert bool(DeviceChaos(ours)) == bool(RefDeviceChaos(ref))
    view, ref_view = ours.respawn_view(), ref.respawn_view()
    assert (view is None) == (ref_view is None)
    if view is not None:
        assert _spec_tuple(view) == _spec_tuple(ref_view)


def test_chaos_rejects_unknown_faults_like_the_reference():
    with pytest.raises(ValueError, match="unknown chaos fault"):
        RefChaosSpec.parse("melt_card")
    with pytest.raises(ValueError, match="unknown chaos fault"):
        ChaosSpec.parse("melt_card")


@pytest.mark.parametrize("text,sizes", [
    ("oom_batch:count=1:min_lines=100", [50, 100, 100]),
    ("oom_batch:sticky=1:min_lines=10", [5, 20, 20, 20]),
    ("wedge_device:seconds=1:count=1:after=2", [10, 10, 10, 10]),
    ("fail_compile:count=2", [1, 1, 1]),
])
def test_chaos_hooks_fire_like_the_reference(text, sizes):
    def run(dc):
        out = []
        for n in sizes:
            try:
                out.append(dc.on_execute(n))
            except Exception as e:  # noqa: BLE001 -- the injected fault's kind
                out.append(classify_device_error(e))
        return out, dc.fired(), dc.executions

    ours = run(DeviceChaos(ChaosSpec.parse(text)))
    ref = run(RefDeviceChaos(RefChaosSpec.parse(text)))
    assert ours == ref


def test_estimate_covers_the_buffers_and_grows_with_the_batch():
    p = _port()
    rows = packed_row_count(p.units) + 4 * len(p.view_specs)
    small = estimate_device_bytes(p.units, p.view_specs, 64, 128)
    big = estimate_device_bytes(p.units, p.view_specs, 1024, 128)
    assert big > small >= 64 * 128 + 64 * 4 + rows * 64 * 4
    assert p.device_bytes_estimate(64, 128) == small
    # A 4-wide mesh over one device holds every shard's packed part
    # beside the gathered output.
    four = estimate_device_bytes(p.units, p.view_specs, 1024, 128,
                                 [("d", 256)] * 4, "d")
    assert four >= 1024 * 128 + 1024 * 4 + 2 * rows * 1024 * 4
    # On distinct devices the home device holds one shard and the gather.
    spread = estimate_device_bytes(p.units, p.view_specs, 1024, 128,
                                   [(d, 256) for d in "abcd"], "a")
    assert 256 * 128 + rows * 1024 * 4 <= spread < four


# ---------------------------------------------------------------------------
# parity drills
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    lines = _lines(300)
    parser = TpuBatchParser(FMT, FIELDS)
    return lines, parser, parser.parse_batch(lines)


def _same(res, ref):
    """The undisturbed reference's values, validity, reject reasons and
    oracle rows."""
    assert res.to_dict() == ref.to_dict()
    assert res.valid.tolist() == ref.valid.tolist()
    assert res.reject_reasons == ref.reject_reasons
    assert res.oracle_rows == ref.oracle_rows


def _raised(kind, call):
    """The fault ``call`` raises, which must be a ``kind``; the counters
    of device faults and the flight recorder's events moved by one
    fault (none for a refusal)."""
    faults, events = counter_sum("device_faults_total"), flight_recorder().total
    with pytest.raises(kind) as ei:
        call()
    moved = 0 if kind is DeviceUnavailableError else 1
    assert counter_sum("device_faults_total") == faults + moved
    assert flight_recorder().total >= events + moved
    return ei.value


def test_device_fault_stats_keys_equal_the_reference(reference):
    _, ref_parser, _ = reference
    assert _port().device_fault_stats().keys() == ref_parser.device_fault_stats().keys()


def test_oom_bisects_and_recovers(reference):
    lines, _, ref = reference
    p = _port(device_chaos="oom_batch:count=1")
    before = counter_sum("device_oom_retries_total")
    _same(p.parse_batch(lines), ref)
    assert counter_sum("device_oom_retries_total") > before
    _same(p.parse_batch(lines), ref)
    assert p.device_fault_stats()["state"] == "closed"


def test_repeated_oom_clamps_and_presplits(reference):
    lines, _, ref = reference
    p = _port(device_chaos="oom_batch:sticky=1:min_lines=129",
              fault_policy=DeviceFaultPolicy(oom_clamp_after=2))
    _same(p.parse_batch(lines), ref)
    # 300 rows fail, then their first 150: the clamp is half of that
    # (the reference, padding 300 to 512, clamps at 128).
    assert p.device_fault_stats()["oom_clamp"] == 75
    fired = p._device_chaos.fired("oom_batch")
    _same(p.parse_batch(lines), ref)
    assert p._device_chaos.fired("oom_batch") == fired   # pre-split below the threshold
    assert metrics().gauge_get("device_bucket_clamped") == 75


def test_oom_at_min_bucket_reroutes_to_the_oracle(reference):
    """Where the reference reroutes, the port raises: an out-of-memory
    error the bisection cannot recover leaves the parse as
    DeviceOomError; once the card has room the same instance parses."""
    lines, _, ref = reference
    p = _port(device_chaos="oom_batch:sticky=1",
              fault_policy=DeviceFaultPolicy(oom_retries=2, oom_clamp_after=99))
    retries = counter_sum("device_oom_retries_total")
    _raised(DeviceOomError, lambda: p.parse_batch(lines))
    assert counter_sum("device_oom_retries_total") > retries
    assert flight_recorder().snapshot()[-1]["fault"] == "oom"
    assert p.device_fault_stats()["consecutive_faults"] == 1
    p.arm_device_chaos(None)
    _same(p.parse_batch(lines), ref)
    assert p.device_fault_stats()["consecutive_faults"] == 0


def test_wedge_expires_and_reroutes(reference):
    """A wait past the deadline raises DeviceWedgeError at the deadline;
    the next batch is back on the device."""
    lines, _, ref = reference
    p = _port(execute_deadline_s=0.2, device_chaos="wedge_device:seconds=1.5:count=1")
    t0 = time.monotonic()
    _raised(DeviceWedgeError, lambda: p.parse_batch(lines))
    assert time.monotonic() - t0 < 1.5
    _same(p.parse_batch(lines), ref)


def test_repeated_wedges_open_the_breaker_then_it_recovers(reference):
    lines, _, ref = reference
    p = _port(execute_deadline_s=0.2,
              fault_policy=DeviceFaultPolicy(breaker_threshold=2, breaker_cooloff_s=0.3),
              device_chaos="wedge_device:seconds=1.0:count=2")
    for _ in range(2):
        _raised(DeviceWedgeError, lambda: p.parse_batch(lines))
    assert p.device_fault_stats()["state"] == "open"
    # Open: refused before any device work (the chaos hook does not fire).
    fired = p._device_chaos.fired()
    assert _raised(DeviceUnavailableError, lambda: p.parse_batch(lines)).state == "open"
    assert p._device_chaos.fired() == fired
    time.sleep(0.35)
    _same(p.parse_batch(lines), ref)
    assert p.device_fault_stats()["state"] == "closed"


def test_fail_compile_demotes_for_good_and_stays_exact(reference):
    """fail_compile raises DeviceCompileError and demotes the parser for
    good: every later entry -- parse, blob, stream -- is refused before
    any device work, and no batch is delivered off the card."""
    lines, _, _ = reference
    p = _port(device_chaos="fail_compile")
    before = counter_sum("device_compile_failures_total")
    _raised(DeviceCompileError, lambda: p.parse_batch(lines))
    assert counter_sum("device_compile_failures_total") == before + 1
    assert p.device_fault_stats()["state"] == "demoted"
    p.arm_device_chaos(None)   # a demotion outlives the fault that made it
    blob = b"\n".join(lines)
    for call in (lambda: p.parse_batch(lines), lambda: p.parse_blob(blob),
                 lambda: list(p.parse_batch_stream([lines, lines])),
                 lambda: p.aggregate_batch(lines, OPS)):
        assert _raised(DeviceUnavailableError, call).state == "demoted"
    assert p.device_fault_stats()["state"] == "demoted"


def test_a_kernel_build_failure_demotes_like_fail_compile(reference, monkeypatch):
    """A real build failure (the first launch's ``KernelBuildError``)
    raises like the injected one: the parser never falls back to the
    plain versions or to the host on its own; it is demoted."""
    lines, _, _ = reference
    p = _port()

    def broken(*a, **k):
        raise kernels.KernelBuildError("nvcc failed: split.cu (exit 1)")

    monkeypatch.setattr(kernels, "split", broken)
    _raised(kernels.KernelBuildError, lambda: p.parse_batch(lines))
    monkeypatch.undo()
    assert p.device_fault_stats()["state"] == "demoted"
    _raised(DeviceUnavailableError, lambda: p.parse_batch(lines))


def test_a_sticky_launch_error_reroutes_and_opens_the_breaker(reference, monkeypatch):
    """A sticky launch error raises, typed, and scores the breaker, which
    opens after ``breaker_threshold`` of them and refuses the next batch."""
    lines, _, _ = reference
    p = _port(fault_policy=DeviceFaultPolicy(breaker_threshold=2, breaker_cooloff_s=60))

    def sticky(*a, **k):
        raise kernels.KernelLaunchError(
            "split kernel launch failed: an illegal memory access was encountered (700)", 700)

    monkeypatch.setattr(kernels, "split", sticky)
    for _ in range(2):
        assert _raised(kernels.KernelLaunchError, lambda: p.parse_batch(lines)).cuda_error == 700
    assert p.device_fault_stats()["state"] == "open"
    _raised(DeviceUnavailableError, lambda: p.parse_batch(lines))


@pytest.mark.parametrize("error", [
    lambda: ValueError("split: buf must be a contiguous uint8 [B, L] tensor"),
    lambda: TypeError("an argument of the wrong type"),
])
def test_an_error_that_is_not_the_devices_propagates_uncounted(reference, monkeypatch, error):
    """A wrapper's own check or any other bug in the device path is the
    program's: it leaves the parse as it is, no fault is counted and the
    breaker is not scored."""
    lines, _, ref = reference
    p = _port()

    def broken(*a, **k):
        raise error()

    monkeypatch.setattr(kernels, "split", broken)
    faults = counter_sum("device_faults_total")
    with pytest.raises(type(error())):
        p.parse_batch(lines)
    with pytest.raises(type(error())):
        p.aggregate_batch(lines, OPS)
    assert counter_sum("device_faults_total") == faults
    assert p.device_fault_stats()["consecutive_faults"] == 0
    assert as_device_fault(error()) is None
    monkeypatch.undo()
    _same(p.parse_batch(lines), ref)


def test_device_errors_torch_raises_are_typed():
    oom = as_device_fault(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert isinstance(oom, DeviceOomError) and isinstance(oom.__cause__, torch.cuda.OutOfMemoryError)
    sticky = as_device_fault(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert isinstance(sticky, DeviceExecutionError)
    launch = kernels.KernelLaunchError("split: x (700)", 700)
    assert as_device_fault(launch) is launch


def test_stream_under_a_fault_keeps_every_batch_in_order(reference):
    """A bisected batch keeps its place in the stream; a fault that is
    not recovered raises in its batch's turn, after every earlier batch
    was delivered, and the stream ends there."""
    lines, ref_parser, _ = reference
    batches = [lines, lines[:150], lines]
    want = [ref_parser.parse_batch(b) for b in batches]
    p = _port(device_chaos="oom_batch:count=1:min_lines=200")
    for depth in (1, 2):
        p.arm_device_chaos("oom_batch:count=1:min_lines=200")
        got = list(p.parse_batch_stream(batches, depth=depth))
        assert len(got) == len(batches)
        for g, w in zip(got, want):
            _same(g, w)
        assert p._device_chaos.fired("oom_batch") == 1
    q = _port(execute_deadline_s=0.2, device_chaos="wedge_device:seconds=1:count=1:after=1")
    got = []
    with pytest.raises(DeviceWedgeError):
        for res in q.parse_batch_stream(batches, depth=2):
            got.append(res)
    assert len(got) == 1
    _same(got[0], want[0])


def test_budget_rejects_before_any_executor_call(reference, monkeypatch):
    lines, _, ref = reference
    p = _port(device_bytes_budget=128)

    def no_call(*a, **k):  # pragma: no cover - would mean a device pass ran
        raise AssertionError("the executor ran despite the budget reject")

    monkeypatch.setattr(mesh_mod.ShardedUnits, "__call__", no_call)
    before = counter_sum("device_budget_rejects_total")
    with pytest.raises(DeviceBudgetError) as ei:
        p.parse_batch(lines)
    assert ei.value.estimated_bytes > ei.value.budget_bytes == 128
    assert ei.value.lines == len(lines)
    with pytest.raises(DeviceBudgetError):
        p.aggregate_batch(lines, OPS)
    assert counter_sum("device_budget_rejects_total") == before + 2
    monkeypatch.undo()
    _same(_port(device_bytes_budget=1 << 30).parse_batch(lines), ref)


@pytest.fixture(scope="module")
def reference_aggregate(reference):
    lines, ref_parser, _ = reference
    return ref_parser.aggregate_batch(lines, OPS)


@pytest.mark.parametrize("error,demoted", [
    (lambda: kernels.KernelLaunchError("agg_lanes kernel launch failed (700)", 700), False),
    (lambda: kernels.KernelBuildError("nvcc failed: agg_lanes.cu (exit 1)"), True),
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 MiB"), False),
])
def test_aggregate_under_a_fault_takes_the_row_path(reference, reference_aggregate,
                                                     monkeypatch, error, demoted):
    """The aggregate's faults go through the parser's fault layer: an
    out-of-memory error takes the row path on the card (equal to the
    reference's aggregate, counted as a fallback batch); a launch error
    raises and scores the breaker; a build failure raises and demotes the
    parser."""
    lines = reference[0]
    want = reference_aggregate
    p = _port()

    def broken(*a, **k):
        raise error()

    monkeypatch.setattr(kernels, "agg_lanes", broken)
    kind = classify_device_error(error())
    faults = metrics().get("device_faults_total", {"kind": kind})
    fallback = metrics().get("analytics_batches_total", {"path": "fallback"})
    if kind == "oom":
        out = p.aggregate_batch(lines, OPS)
        assert out.state.summary() == want.state.summary()
        assert (out.good_lines, out.bad_lines) == (want.good_lines, want.bad_lines)
        assert [(r, why) for r, why, _ in out.reject_items] == \
            [(r, why) for r, why, _ in want.reject_items]
        assert out.device_rows == 0
        assert metrics().get("analytics_batches_total", {"path": "fallback"}) == fallback + 1
        assert p.device_fault_stats()["consecutive_faults"] == 0
    else:
        with pytest.raises(type(error())):
            p.aggregate_batch(lines, OPS)
        assert metrics().get("analytics_batches_total", {"path": "fallback"}) == fallback
        assert p.device_fault_stats()["consecutive_faults"] == (0 if demoted else 1)
    assert metrics().get("device_faults_total", {"kind": kind}) == faults + 1
    monkeypatch.undo()
    assert (p.device_fault_stats()["state"] == "demoted") == demoted
    if demoted:
        with pytest.raises(DeviceUnavailableError):
            p.aggregate_batch(lines, OPS)
        return
    again = p.aggregate_batch(lines, OPS)
    assert again.state.summary() == want.state.summary()
    assert again.device_rows > 0


def test_data_parallel_mesh_bisects_to_the_same_rows(reference, monkeypatch):
    lines, _, ref = reference
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: [torch.device("cpu")] * 8)
    p = _port(data_parallel=4, device_chaos="oom_batch:count=2:min_lines=151")
    assert p.mesh_devices == 4
    _same(p.parse_batch(lines), ref)
    assert p._device_chaos.fired("oom_batch") == 1   # the halves are below the threshold
    assert p.device_bytes_estimate(300, 128) > _port().device_bytes_estimate(300, 128)


def test_chaos_from_the_environment(reference, monkeypatch):
    lines, _, ref = reference
    monkeypatch.setenv("LOGPARSER_TPU_CHAOS", "oom_batch:count=1")
    p = TorchBatchParser(FMT, FIELDS, device="cpu")
    assert p.device_fault_stats()["chaos_armed"]
    _same(p.parse_batch(lines), ref)
    assert p._device_chaos.fired() == 1
    p.arm_device_chaos(None)
    assert not p.device_fault_stats()["chaos_armed"]


def test_flight_events_and_counters_name_the_fault():
    rows = _lines(80)
    p = _port(device_chaos="oom_batch:sticky=1",
              fault_policy=DeviceFaultPolicy(min_bucket=64, oom_clamp_after=99,
                                             breaker_threshold=1))
    ooms = metrics().get("device_faults_total", {"kind": "oom"})
    demotions = metrics().get("device_demotions_total", {"reason": "oom"})
    _raised(DeviceOomError, lambda: p.parse_batch(rows))
    assert metrics().get("device_faults_total", {"kind": "oom"}) == ooms + 1
    assert metrics().get("device_demotions_total", {"reason": "oom"}) == demotions + 1
    last = flight_recorder().snapshot()[-1]
    assert last["kind"] == "device_fault" and last["batch_rows"] == 80
    assert last["fault"] == "oom"
    assert p.device_fault_stats()["state"] == "open"


def test_a_failed_attempt_frees_its_tensors_before_the_retry(reference, monkeypatch):
    """A real out-of-memory error leaves the failed attempt's tensors as
    its frames' locals; the fault layer clears them before the halves
    allocate theirs (on the card, under a memory limit, the retries
    otherwise ran out of memory on the leftovers and the batch went to
    the oracle)."""
    import weakref

    lines, _, ref = reference
    p = _port()
    real = kernels.pack_rows
    seen = []

    def pack_rows(tables, flags, comps):
        if not seen:
            seen.append(weakref.ref(comps))
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 MiB")
        assert seen[0]() is None, "the failed attempt's components are still alive"
        seen.append(comps.shape[1])
        return real(tables, flags, comps)

    monkeypatch.setattr(kernels, "pack_rows", pack_rows)
    _same(p.parse_batch(lines), ref)
    assert seen[1:] == [150, 150]
