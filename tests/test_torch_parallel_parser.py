"""TorchBatchParser(data_parallel=N) and the mesh aggregate on the CPU.

The port's mesh is laid over ``[cpu] * k`` (``parallel.mesh.local_devices``
replaced with pytest's monkeypatch), the stand-in for the reference's
virtual CPU devices.  Every entry under a mesh -- ``parse_batch``,
``parse_blob``, ``parse_batch_stream``, ``aggregate_batch``,
``aggregate_blob``, ``aggregate_batch_stream`` -- must equal the unsharded
port parser (``to_dict``, ``needs_host``, ``to_arrow(strings="copy")``,
``AggregateState.to_ipc_bytes``); the sharded packed rows must equal the
reference executor's (``pipeline.build_units_jnp_fn``).  Exact: the
outputs are integers, strings and booleans.
"""
import numpy as np
import pytest
import torch

from logparser_tpu.tools.demolog import HEADLINE_FIELDS
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.parallel import mesh
from logparser_tpu_torch.tools import demolog
from logparser_tpu_torch.tpu.carry import units_from_reference
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import (
    corpus,
    first_mismatch,
    jax_unit_plain,
    reference_packed,
    reference_parser,
)

CPU = torch.device("cpu")


def _devices(monkeypatch, k):
    monkeypatch.setattr(mesh, "local_devices", lambda: [CPU] * k)


@pytest.fixture
def eight(monkeypatch):
    _devices(monkeypatch, 8)


def _same(a, b):
    assert a.needs_host.tolist() == b.needs_host.tolist()
    assert np.array_equal(a.valid, b.valid)
    assert a.to_dict() == b.to_dict()
    assert a.to_arrow(strings="copy").equals(b.to_arrow(strings="copy"))


def test_parser_data_parallel_width_resolution(monkeypatch):
    _devices(monkeypatch, 8)
    assert mesh.dp_device_count(8) == 8
    assert mesh.dp_device_count(5) == 4   # the largest power of two that fits
    assert mesh.dp_device_count(1) == 1
    assert TorchBatchParser("%h %u %>s", ["IP:connection.client.host"], device="cpu",
                            data_parallel=8).mesh_devices == 8
    p = TorchBatchParser("%h %u %>s", ["IP:connection.client.host"], device="cpu",
                         data_parallel=1)
    assert p.mesh_devices == 1 and p._mesh.devices == [[p.device]]   # the device alone
    _devices(monkeypatch, 5)
    assert mesh.dp_device_count() == 4
    assert TorchBatchParser("%h %u %>s", ["IP:connection.client.host"], device="cpu",
                            data_parallel=8).mesh_devices == 4
    _devices(monkeypatch, 1)   # a one-device host: data_parallel=8 resolves to 1
    p = TorchBatchParser("%h %u %>s", ["IP:connection.client.host"], device="cpu",
                         data_parallel=8)
    assert p.mesh_devices == 1 and p._mesh.devices == [[p.device]]


def test_parser_needs_a_mesh_of_its_device_type(monkeypatch):
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("meta")] * 2)
    with pytest.raises(ValueError, match="mesh's devices"):
        TorchBatchParser("%h %u %>s", ["IP:connection.client.host"], device="cpu",
                         data_parallel=2)


def test_parser_data_parallel_parse_parity(eight):
    fields = ["IP:connection.client.host", "STRING:request.status.last"]
    solo = TorchBatchParser("%h %u %>s", fields, device="cpu")
    dp = TorchBatchParser("%h %u %>s", fields, device="cpu", data_parallel=8)
    assert dp.mesh_devices == 8
    lines = [f"1.2.3.{i % 250} u{i} {200 + i % 5}".encode() for i in range(100)]
    lines[7] = b"garbage ! line"
    for views in (None, False):
        _same(dp.parse_batch(lines, emit_views=views), solo.parse_batch(lines, emit_views=views))
    blob = b"\n".join(lines)
    _same(dp.parse_blob(blob), solo.parse_blob(blob))
    for depth in (1, 2):
        got = list(dp.parse_batch_stream([lines, lines[:33], lines[:3]], depth=depth))
        want = list(solo.parse_batch_stream([lines, lines[:33], lines[:3]], depth=depth))
        for a, b in zip(got, want):
            _same(a, b)


def test_parser_data_parallel_combined_product_path(eight):
    """The headline configuration, view rows included, on a batch the
    mesh width does not divide (the last shard is padded)."""
    lines = demolog.generate_combined_lines(203, seed=5, garbage_fraction=0.04) + [""]
    solo = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu")
    dp = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu", data_parallel=8)
    a, b = dp.parse_batch(lines), solo.parse_batch(lines)
    _same(a, b)
    assert a.d2h_bytes == b.d2h_bytes   # [K + 4V, B]: no padding comes back


def test_parser_data_parallel_regrow_in_one_shard(eight):
    """One line past the 16 query-string slots lands in one shard of
    eight: the whole batch regrows (the overflow bit is read over every
    shard) and equals the unsharded parser, in parse_batch and in a
    stream whose pending batch is re-dispatched on every shard."""
    many = ('1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /p?'
            + "&".join(f"k{i}=v{i}" for i in range(20)) + ' HTTP/1.1" 200 5 "-" "u"')
    lines = demolog.generate_combined_lines(61, seed=53)
    lines.insert(37, many)                       # rows 32..39: shard 4
    solo = TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS, device="cpu")
    dp = TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS, device="cpu", data_parallel=8)
    a, b = dp.parse_batch(lines), solo.parse_batch(lines)
    assert a.csr_regrows == b.csr_regrows == 1 and dp.csr_slots == solo.csr_slots == 32
    _same(a, b)
    fresh_solo = TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS, device="cpu")
    fresh_dp = TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS, device="cpu",
                                data_parallel=8)
    batches = [lines[:20], lines, lines[:9]]
    got = list(fresh_dp.parse_batch_stream(batches, depth=2))
    want = list(fresh_solo.parse_batch_stream(batches, depth=2))
    assert [r.csr_regrows for r in got] == [r.csr_regrows for r in want] == [0, 1, 0]
    for x, y in zip(got, want):
        _same(x, y)


def test_data_parallel_packed_rows_equal_the_reference_executor(eight):
    """batch_parallel_runner over the reference parser's units (carried
    as plain data) against ``build_units_jnp_fn`` on one device: all K
    unit rows and the 4V view rows."""
    ref = reference_parser("combined", HEADLINE_FIELDS)
    specs = ref._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in ref.units])
    lines = corpus(seed=81, n=60, n_random=8)[:96]
    buf, lengths, _ = encode_batch(lines)
    got = mesh.batch_parallel_runner(units, mesh.make_mesh(8), specs)(buf, lengths)
    want = reference_packed(ref.units, specs, buf, lengths)
    assert first_mismatch(ref.units, specs, got.numpy(), want) is None


def test_mesh_aggregate_equals_single_device(eight):
    """aggregate_batch / aggregate_blob / aggregate_batch_stream(depth=2)
    under a mesh: the same AggregateState, IPC bytes and row accounting as
    one device (folds, rejects and needs_host included)."""
    lines = (demolog.generate_combined_lines(150, seed=42, garbage_fraction=0.05)
             + demolog.aggregate_edge_lines())
    solo = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu")
    dp = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu", data_parallel=8)
    ops = demolog.DASHBOARD_OPS

    def same(x, y):
        assert x.state == y.state
        assert x.state.to_ipc_bytes() == y.state.to_ipc_bytes()
        for key in ("lines_read", "good_lines", "bad_lines", "device_rows", "fold_rows"):
            assert getattr(x, key) == getattr(y, key), key
        assert x.needs_host.tolist() == y.needs_host.tolist()
        assert x.reject_rows.tolist() == y.reject_rows.tolist()

    x = dp.aggregate_batch(lines, ops)
    same(x, solo.aggregate_batch(lines, ops))
    assert x.fold_rows > 0 and x.device_rows > 0
    blob = "\n".join(lines).encode()
    same(dp.aggregate_blob(blob, ops), solo.aggregate_blob(blob, ops))
    batches = [lines[:50], lines, lines[:7]]
    for g, w in zip(dp.aggregate_batch_stream(batches, ops, depth=2),
                    solo.aggregate_batch_stream(batches, ops, depth=2)):
        same(g, w)
