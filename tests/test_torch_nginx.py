"""NGINX log_formats on the CPU against the reference package.

The port's NGINX variable table compiles to the reference's split
programs; the plain version of the ``secmillis`` task of ``span_stages``
(``parse_secmillis_spans``) matches on seeded bytes; and the two
configurations -- ``nginx_uri`` (the reference's bench config) and
``nginx_timing`` ($msec, $request_time) -- plus a mixed Apache / NGINX
parser equal ``TpuBatchParser`` bit for bit: packed rows through the
harness, ``to_dict()`` and ``needs_host``.  One reference parser per
configuration (module-scoped).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logparser_tpu.httpd.nginx import NginxHttpdLogFormatDissector
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu.tpu.program import compile_device_program as ref_compile
from logparser_tpu_torch import TorchBatchParser, UnsupportedFieldError
from logparser_tpu_torch.httpd.nginx import NginxLogFormat, looks_like_nginx_format
from logparser_tpu_torch.tools import demolog
from logparser_tpu_torch.tpu import pipeline, postproc
from logparser_tpu_torch.tpu.carry import units_from_reference
from logparser_tpu_torch.tpu.program import compile_device_program
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import (
    assert_parse_matches_reference,
    assert_results_equal,
    assert_plain_equal,
    first_mismatch,
    jax_program_plain,
    jax_unit_plain,
    reference_packed,
)

N_LINES = 2000
MIXED_FORMAT = "combined\n" + demolog.NGINX_TIMING_FORMAT
MIXED_FIELDS = ["IP:connection.client.host", "STRING:request.status.last",
                "HTTP.PATH:request.firstline.uri.path", "BYTES:response.body.bytes"]
CONFIGS = {
    "nginx_uri": (demolog.NGINX_URI_FORMAT, demolog.NGINX_URI_FIELDS,
                  demolog.nginx_uri_lines),
    "nginx_timing": (demolog.NGINX_TIMING_FORMAT, demolog.NGINX_TIMING_FIELDS,
                     demolog.nginx_timing_lines),
    "mixed": (MIXED_FORMAT, MIXED_FIELDS,
              lambda n: demolog.nginx_timing_lines(n // 2)
              + demolog.generate_combined_lines(n // 2, seed=50, garbage_fraction=0.01)),
}


@pytest.fixture(scope="module")
def reference():
    """{config: (TpuBatchParser, lines, its parse)}, built lazily once."""
    cache = {}

    def get(name):
        if name not in cache:
            fmt, fields, gen = CONFIGS[name]
            parser = TpuBatchParser(fmt, list(fields))
            lines = gen(N_LINES) + demolog.nginx_edge_lines()
            cache[name] = (parser, lines, parser.parse_batch(lines))
        return cache[name]
    return get


def _compare(ours, ref, lines):
    return assert_results_equal(ours, ref)


# -- the plain version of the secmillis task ----------------------------------

MS_EDGES = [b"1483455396.639", b"0.000", b"0.5", b"12", b"12.345", b"1.2345",
            b"123456789012345.678", b"1234567890123456.789", b"99999999999999999999.999",
            b".123", b"1.23", b"1a.123", b"1.1x3", b"-", b"", b"1.2.3.456"]


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_secmillis_spans_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, L = 3000, 64
    alpha = np.frombuffer(b"0123456789.-x ", dtype=np.uint8)
    buf = alpha[rng.integers(0, len(alpha), size=(B, L))]
    buf[::4] = rng.integers(0, 256, size=buf[::4].shape)
    s = rng.integers(-3, L, size=B).astype(np.int32)
    e = (s + rng.integers(-2, 26, size=B)).astype(np.int32)
    for i, edge in enumerate(MS_EDGES):
        buf[i] = 0
        buf[i, 2:2 + len(edge)] = np.frombuffer(edge, dtype=np.uint8)
        s[i], e[i] = 2, 2 + len(edge)
    want = ref_postproc.parse_secmillis_spans(jnp.asarray(buf), jnp.asarray(s),
                                              jnp.asarray(e))
    got = postproc.parse_secmillis_spans(torch.from_numpy(buf), torch.from_numpy(s),
                                         torch.from_numpy(e))
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for k in (1, 2, 3):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    ok = got[3][:len(MS_EDGES)].tolist()
    assert [MS_EDGES[i] for i, v in enumerate(ok) if v] == [
        b"1483455396.639", b"0.000", b"12.345", b"123456789012345.678"]


# -- the variable table -------------------------------------------------------

FORMATS = [
    demolog.NGINX_URI_FORMAT,
    demolog.NGINX_TIMING_FORMAT,
    '$remote_addr $binary_remote_addr [$time_iso8601] $upstream_addr '
    '$upstream_response_time $upstream_status "$http_x_forwarded_for" '
    '$ssl_protocol/$ssl_cipher $request_id $foo_bar $pipe $the_real_ip '
    '$arg_q $cookie_sid 100% $limit_rate $connection $gzip_ratio',
]


@pytest.mark.parametrize("fmt", FORMATS, ids=["uri", "timing", "many"])
def test_programs_match_reference(fmt):
    want = jax_program_plain(ref_compile(NginxHttpdLogFormatDissector(fmt)))
    got = jax_program_plain(compile_device_program(NginxLogFormat(fmt)))
    assert_plain_equal(got, want, "program")


def test_format_choice():
    assert looks_like_nginx_format("$a") and looks_like_nginx_format("combined")
    assert not looks_like_nginx_format("%h")
    parser = TorchBatchParser(MIXED_FORMAT, ["IP:connection.client.host"], device="cpu")
    assert [u.program.log_format for u in parser.units] == [
        '%h %l %u %t "%r" %>s %b "%{Referer}i" "%{User-Agent}i"',
        demolog.NGINX_TIMING_FORMAT]


# -- the configurations end to end --------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_reference(reference, name):
    _, lines, ref = reference(name)
    fmt, fields, _ = CONFIGS[name]
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    _compare(ours, ref, lines)
    assert ours.valid[:N_LINES].sum() >= 0.98 * N_LINES


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_packed_rows_match_reference(reference, name):
    parser, lines, _ = reference(name)
    specs = parser._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in parser.units])
    ex = pipeline.UnitsExecutor(units, specs)
    buf, lengths, _ = encode_batch(lines[:512] + demolog.nginx_edge_lines())
    want = reference_packed(parser.units, specs, buf, lengths)
    got = ex(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(parser.units, specs, got, want) is None
    fmt, fields, _ = CONFIGS[name]
    own = TorchBatchParser(fmt, fields, device="cpu").executor
    got = own(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(parser.units, specs, got, want) is None


def test_timing_edge_lines_take_the_reference_routes():
    fmt, fields, _ = CONFIGS["nginx_timing"]
    edge = demolog.nginx_edge_lines()
    res = TorchBatchParser(fmt, fields, device="cpu").parse_batch(edge)
    epoch = res.to_pylist("TIME.EPOCH:request.receive.time.epoch")
    ms = res.to_pylist("MILLISECONDS:response.server.processing.time")
    us = res.to_pylist("MICROSECONDS:response.server.processing.time")
    assert (epoch[0], ms[0], us[0]) == (1704067200123, 42, 42000)
    assert (ms[1], ms[4], ms[6]) == (0, 12345, 123456789012345678)
    assert epoch[8] == 0
    host = set(res.needs_host.tolist())
    # '0.5', '12', a four-digit fraction, 16-digit seconds, no fraction,
    # 20 digits, a '-' $msec, a '-' byte count and a referer with a space
    # go to the host; an IPv6 client stays on the card (the IP charset
    # takes it); a '-' or an exponent in the last token make the line
    # implausible: plain invalid.
    assert {2, 3, 5, 7, 9, 10, 11, 13, 15} <= host
    assert 14 not in host and res.valid[14]
    assert not ({12, 16} & host) and not res.valid[12] and not res.valid[16]


def test_widest_bucket_matches_reference():
    fmt, fields, gen = CONFIGS["nginx_timing"]
    lines = gen(150) + demolog.nginx_edge_lines()
    pad = 8191 - len(lines[0].encode())
    lines += [lines[0].replace('"GET ', '"GET /' + "w" * (pad - 1), 1),
              lines[0].replace('"GET ', '"GET /' + "w" * (pad + 99), 1)]
    ref = TpuBatchParser(fmt, list(fields)).parse_batch(lines)
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    assert ours.buf.shape[1] == 8191
    _compare(ours, ref, lines)
    assert len(lines) - 1 in ours.needs_host.tolist()


@pytest.mark.parametrize("fmt,field,why", [
    ("$time_iso8601 $status", "TIME.EPOCH:request.receive.time.epoch",
     "compile_java_pattern"),
])
def test_unported_nginx_fields_raise(fmt, field, why):
    with pytest.raises(UnsupportedFieldError, match=why):
        TorchBatchParser(fmt, [field], device="cpu")


_UPSTREAM_LINES = ["1.2.3.4 12, 34 : 56, 78", "1.2.3.4 0.001, 0.250 : 1.500",
                   "1.2.3.4 -", "1.2.3.4 5", "1.2.3.4 x, y", "1.2.3.4 ", "garbage"]


@pytest.mark.parametrize("fmt,fields,lines", [
    # Numeric upstream-list elements: typed by the host's casts.
    ("$remote_addr $upstream_response_length",
     ["BYTES:nginxmodule.upstream.response.length.0.value",
      "BYTES:nginxmodule.upstream.response.length.1.redirected"], _UPSTREAM_LINES),
    ("$remote_addr $upstream_response_time",
     ["SECOND_MILLIS:nginxmodule.upstream.response.time.1.redirected",
      "IP:connection.client.host"], _UPSTREAM_LINES),
    # $binary_remote_addr's IP_BINARY -> IP (BinaryIPDissector).
    ("$binary_remote_addr $status", ["IP:connection.client.host", "STRING:request.status.last"],
     ["\\x0A\\x00\\x00\\xFF 200", "\\x0a\\x00\\x00 200", "- 200", "1.2.3.4 404"]),
    # More than one producer: $msec and $time_local both give the epoch.
    ("$msec [$time_local]", ["TIME.EPOCH:request.receive.time.epoch"],
     ["1704067200.123 [01/Jan/2024:00:00:00 +0000]", "1.5 [02/Jan/2024:00:00:00 +0100]",
      "1704067200.123 [bad]", "x [01/Jan/2024:00:00:00 +0000]"]),
])
def test_host_nginx_fields_match_reference(fmt, fields, lines):
    """The fields these formats' device plans cannot deliver are the host
    oracle's, equal to the reference on every line."""
    plan = TorchBatchParser(fmt, fields, device="cpu").plan_by_id[fields[0]]
    assert plan.kind == "host"
    ours = assert_parse_matches_reference(fmt, fields, lines)
    assert len(ours.needs_host) and ours.valid.any()
