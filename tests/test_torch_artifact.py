"""The port's parser artifacts on the CPU, held to the JAX package.

A port parser reloaded through ``to_bytes`` / ``from_bytes``, through
``save`` / ``load`` and through a plain pickle equals a freshly built
``TpuBatchParser`` (``to_dict()``, validity, the oracle's rows and
``to_arrow(strings="copy")``) on the headline, GeoIP and multi-format
lines, edge lines included.  The reference's own reloads are not used:
two of its artifact tests fail (ROADMAP C), so the port is held to a
freshly built reference parser, one per configuration, shared by the
file.  Also: an artifact made before the first parse, garbage and the
reference's artifacts refused with ValueError, no tensor in an
artifact, no runtime fault state across a reload, and ``prewarm``.
"""
import os
import pickle

import pytest
import torch

from logparser_tpu.geoip import GeoIPASNDissector as RefASN
from logparser_tpu.geoip import GeoIPCityDissector as RefCity
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.geoip import GeoIPASNDissector, GeoIPCityDissector
from logparser_tpu_torch.observability import counter_sum
from logparser_tpu_torch.tools import demolog, geoip_testdata
from logparser_tpu_torch.tpu import batch as batch_mod
from logparser_tpu_torch.tpu.device_faults import DeviceCompileError, DeviceFaultPolicy
from test_torch_harness import EDGE_LINES, assert_results_equal, corpus, reference_parser

N = 120
MULTI = "combined\ncommon"
MULTI_FIELDS = ["IP:connection.client.host", "BYTES:response.body.bytes",
                "TIME.EPOCH:request.receive.time.epoch", "HTTP.URI:request.firstline.uri"]


def _geo_dbs():
    fixtures = geoip_testdata.ensure_test_databases()
    return (os.path.join(fixtures, "GeoIP2-City-Test.mmdb"),
            os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb"))


def _config(name):
    """(format, fields, lines, the reference's kwargs, the port's kwargs)."""
    if name == "headline":
        return ("combined", demolog.HEADLINE_FIELDS,
                demolog.generate_combined_lines(N, seed=42, garbage_fraction=0.02)
                + EDGE_LINES, None, {})
    if name == "multi":
        return (MULTI, MULTI_FIELDS, corpus(31, n=N // 2, n_random=8), None, {})
    city, asn = _geo_dbs()
    return ("combined", demolog.GEOIP_FIELDS,
            demolog.geoip_chain_lines(N) + demolog.geoip_edge_lines(),
            {"extra_dissectors": [RefCity(city), RefASN(asn)]},
            {"extra_dissectors": [GeoIPCityDissector(city), GeoIPASNDissector(asn)]})


_WANT = {}


def _want(name):
    """(lines, the fresh reference's result, its copy-mode Arrow table),
    once per configuration."""
    if name not in _WANT:
        fmt, fields, lines, ref_kw, _ = _config(name)
        ref = (reference_parser(fmt, fields) if ref_kw is None
               else TpuBatchParser(fmt, list(fields), **ref_kw))
        res = ref.parse_batch(lines)
        _WANT[name] = (lines, res, res.to_arrow(include_validity=True, strings="copy"))
    return _WANT[name]


def _port(name, **kw):
    fmt, fields, _, _, our_kw = _config(name)
    return TorchBatchParser(fmt, fields, device="cpu", **our_kw, **kw)


def _holds(parser, name):
    lines, want, want_table = _want(name)
    got = parser.parse_batch(lines)
    assert_results_equal(got, want)
    assert got.to_arrow(strings="copy").equals(want_table)
    return got


@pytest.mark.parametrize("name", ["headline", "multi", "geoip"])
def test_reloaded_parser_equals_a_fresh_reference(name, tmp_path):
    parser = _port(name)
    _holds(parser, name)   # executors built: none of it ships
    blob = parser.to_bytes()
    assert blob.startswith(TorchBatchParser._ARTIFACT_MAGIC)
    loaded = TorchBatchParser.from_bytes(blob, device="cpu")
    _holds(loaded, name)
    assert loaded.executor_fingerprint() == parser.executor_fingerprint()
    path = str(tmp_path / "parser.lpt")
    parser.save(path)
    _holds(TorchBatchParser.load(path, device="cpu"), name)
    _holds(pickle.loads(pickle.dumps(parser)), name)


def test_a_parser_saved_before_its_first_parse(tmp_path):
    path = str(tmp_path / "fresh.lpt")
    _port("headline").save(path)
    loaded = TorchBatchParser.load(path, device="cpu")
    assert loaded.device == torch.device("cpu")
    assert loaded.prewarm(batch_sizes=[8, 64], max_line_len=300) == \
        {"8x384": "memory", "64x384": "memory"}
    _holds(loaded, "headline")


def test_a_grown_parser_keeps_its_slots():
    parser = TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS, device="cpu")
    parser._grow_csr_slots()
    loaded = TorchBatchParser.from_bytes(parser.to_bytes(), device="cpu")
    assert loaded.csr_slots == 32 and loaded.executor_fingerprint() == \
        parser.executor_fingerprint()


@pytest.mark.parametrize("blob", [
    b"", b"garbage", b"\x80\x04K\x01.",
    TorchBatchParser._ARTIFACT_MAGIC + b"not a pickle",
    TorchBatchParser._ARTIFACT_MAGIC + pickle.dumps({"parser": 1}),
    TorchBatchParser._ARTIFACT_MAGIC_V2 + pickle.dumps({"parser": "x", "libraries": None}),
])
def test_garbage_is_refused(blob):
    with pytest.raises(ValueError):
        TorchBatchParser.from_bytes(blob, device="cpu")


def test_a_reference_artifact_is_refused():
    """The reference's artifact (its own magic) is refused before any of
    its pickle -- jax objects -- is read."""
    ref_blob = reference_parser("combined", demolog.HEADLINE_FIELDS).to_bytes(
        embed_executables=False)
    with pytest.raises(ValueError, match="not a logparser_tpu_torch program artifact"):
        TorchBatchParser.from_bytes(ref_blob, device="cpu")
    with pytest.raises(ValueError):
        TpuBatchParser.from_bytes(_port("headline").to_bytes())


def test_runtime_fault_state_is_dropped_on_load():
    """The reference's version of this test fails (ROADMAP C); the port's
    is held to a freshly built TpuBatchParser."""
    lines, want, _ = _want("headline")
    p = _port("headline", device_chaos="fail_compile",
              fault_policy=DeviceFaultPolicy(breaker_threshold=5), execute_deadline_s=30)
    with pytest.raises(DeviceCompileError):
        p.parse_batch(lines)
    assert p.device_fault_stats()["state"] == "demoted"
    p._oom_clamp, p._oom_events = 64, 3
    loaded = TorchBatchParser.from_bytes(p.to_bytes(), device="cpu")
    stats = loaded.device_fault_stats()
    assert stats["state"] == "closed" and stats["oom_clamp"] is None
    assert not stats["chaos_armed"] and stats["oom_events"] == 0
    # The knobs ship; the breaker is rebuilt from them.
    assert loaded.fault_policy.breaker_threshold == 5 and loaded.execute_deadline_s == 30
    got = _holds(loaded, "headline")
    assert got.oracle_rows == want.oracle_rows   # back on the device path


def test_chaos_rearms_from_the_loading_environment(monkeypatch):
    blob = _port("headline").to_bytes()
    monkeypatch.setenv("LOGPARSER_TPU_CHAOS", "oom_batch:count=1")
    loaded = TorchBatchParser.from_bytes(blob, device="cpu")
    assert loaded.device_fault_stats()["chaos_armed"]
    before = counter_sum("device_oom_retries_total")
    _holds(loaded, "headline")
    assert counter_sum("device_oom_retries_total") > before


def test_no_tensor_ships_in_an_artifact():
    parser = _port("geoip")
    _holds(parser, "geoip")
    # The GeoIP table's device copies (made by a gather) stay behind.
    table = next(t for t in parser._geo_tables.values() if t is not None)
    table.gather(table.columns[0], torch.zeros(4, dtype=torch.int32))
    assert table._device_arrays
    loaded = TorchBatchParser.from_bytes(parser.to_bytes(), device="cpu")
    assert all(not t._device_arrays for t in loaded._geo_tables.values() if t is not None)
    assert not loaded._sharded and loaded._copy_stream is None
    # The per-device tables run_program and the SP runner cache on a
    # unit's program (on the card: CUDA tensors) stay behind too, and are
    # not part of the fingerprint.
    from logparser_tpu_torch.parallel.mesh import SpTables
    from logparser_tpu_torch.tpu.pipeline import SplitTables

    program = parser.units[0].program
    fingerprint = parser.executor_fingerprint()
    program._split_tables = {torch.device("cpu"): SplitTables(program)}
    program._sp_tables = {torch.device("cpu"): SpTables(program)}
    assert parser.executor_fingerprint() == fingerprint
    reloaded = TorchBatchParser.from_bytes(parser.to_bytes(), device="cpu")
    assert not hasattr(reloaded.units[0].program, "_split_tables")
    assert reloaded.executor_fingerprint() == fingerprint
    parser.stray = torch.zeros(3)
    with pytest.raises(TypeError, match="cannot ship in an artifact"):
        parser.to_bytes()


def test_the_card_is_the_default_on_load(monkeypatch):
    blob = _port("headline").to_bytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBatchParser.from_bytes(blob)
    assert batch_mod._LOADING.device is None
