"""Formats the earlier slices refused, against the reference.

- A split program whose separators hold NUL bytes: the plain
  ``compute_split`` (the CPU side of the ``split`` kernel) against the
  reference's ``compute_split_dense``, on lines that end in NULs and are
  zero-padded, then end to end.
- A multi-format parser with a format the split cannot run: its
  plausibility-only probe unit contests the later formats' lines as the
  reference's does (``to_dict()``, ``needs_host``, packed words).
- NGINX upstream-list elements (the ``ulist`` plan).
- ``BYTESCLF`` over ``%B`` (the number -> CLF conversion, zero -> null).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.tpu import pipeline as ref_pipeline
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.tools.demolog import generate_combined_lines
from logparser_tpu_torch.tpu import pipeline
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import (
    assert_parse_matches_reference,
    assert_results_equal,
    packed_mismatch,
)

NUL_FIELDS = ["IP:connection.client.host", "STRING:connection.client.user",
              "STRING:request.status.last"]


def _nul_lines(seed):
    rng = np.random.default_rng(seed)
    lines = [b"1.2.3.4\x00bob\x00200", b"1.2.3.4\x00bob\x00200\x00", b"1.2.3.4\x00\x00200",
             b"\x00\x00", b"1.2.3.4 bob 200", b"a\x00b\x00c\x00\x00\x00", b"",
             b"1.2.3.4\x00\x00bob 200\x00", b"\x00"]
    alphabet = np.frombuffer(b"\x00\x00\x00ab1. -", dtype=np.uint8)
    lines += [bytes(rng.choice(alphabet, size=int(rng.integers(0, 50))))
              for _ in range(300)]
    for ln in generate_combined_lines(100, seed=seed):
        p = ln.split(" ")
        lines.append(f"{p[0]}\x00{p[2]}\x00{p[8]}".encode())
        lines.append(f"{p[0]}\x00\x00{p[2]} {p[8]}\x00".encode())
    return lines


def _compare(ours, ref, lines, fields):
    return assert_results_equal(ours, ref, fields)


@pytest.mark.parametrize("fmt", ["%h\x00%u\x00%>s", "%h\x00\x00%u %>s\x00"])
@pytest.mark.parametrize("L", [64, 1024])
def test_nul_separator_split_matches_compute_split_dense(fmt, L):
    ours_p = TorchBatchParser(fmt, NUL_FIELDS, device="cpu")
    ref_p = TpuBatchParser(fmt, NUL_FIELDS)
    prog = ref_p.units[0].program
    assert any(0 in op.lit for op in prog.ops)
    lines = _nul_lines(L)
    buf, lengths, _ = encode_batch(lines, line_len=L)
    s, e, f = pipeline.compute_split(ours_p.units[0].program, torch.from_numpy(buf),
                                     torch.from_numpy(lengths))
    rs, re_, rv, rp, _ = ref_pipeline.compute_split_dense(
        prog, jnp.asarray(buf.astype(np.int32)), jnp.asarray(lengths), need_plausible=True)
    np.testing.assert_array_equal(s.numpy(), np.stack([np.asarray(x) for x in rs]))
    np.testing.assert_array_equal(e.numpy(), np.stack([np.asarray(x) for x in re_]))
    f = f.numpy()
    np.testing.assert_array_equal((f & pipeline.SPLIT_VALID) != 0, np.asarray(rv))
    np.testing.assert_array_equal((f & pipeline.SPLIT_PLAUSIBLE) != 0, np.asarray(rp))
    assert ((f & 1) != 0).sum() > 50
    _compare(ours_p.parse_batch(lines), ref_p.parse_batch(lines), lines, NUL_FIELDS)


PROBE_FIELDS = ["IP:connection.client.host", "STRING:connection.client.user",
                "STRING:request.status.last"]


@pytest.mark.parametrize("fmt", ["%h%l %u %>s\n%h %u %>s", "%h %u %>s\n%h%l %u %>s",
                                 "$remote_addr$status\n$remote_addr $remote_user $status"])
def test_probe_units_match_reference(fmt):
    """The reference's multi-format case and its mirror: the probe unit's
    plausibility bit, the contest, packed words and values."""
    ref = TpuBatchParser(fmt, PROBE_FIELDS)
    ours_p = TorchBatchParser(fmt, PROBE_FIELDS, device="cpu")
    assert [u.plausibility_only for u in ours_p.units] == \
        [u.plausibility_only for u in ref.units]
    lines = (["1.2.3.4 frank 200", "1.2.3.4- frank 200", "1.2.3.4 - frank 200",
              "1.2.3.4200", "x", ""]
             + [f"10.0.{i % 256}.{i // 256} u{i} {200 + i % 3}" for i in range(100)])
    assert packed_mismatch(ref, lines) is None
    _compare(ours_p.parse_batch(lines), ref.parse_batch(lines), lines, PROBE_FIELDS)


ULIST_FMT = '$remote_addr "$upstream_addr" "$upstream_status" $status'
ULIST_FIELDS = [
    "UPSTREAM_ADDR:nginxmodule.upstream.addr.0.value",
    "UPSTREAM_ADDR:nginxmodule.upstream.addr.1.value",
    "UPSTREAM_ADDR:nginxmodule.upstream.addr.0.redirected",
    "UPSTREAM_STATUS:nginxmodule.upstream.status.0.value",
    "STRING:request.status.last",
]


def test_upstream_list_elements_match_reference():
    ref = TpuBatchParser(ULIST_FMT, ULIST_FIELDS)
    assert ref._unit_oracle_fields == [[]]
    ours_p = TorchBatchParser(ULIST_FMT, ULIST_FIELDS, device="cpu")
    assert [p.kind for p in ours_p.units[0].plans] == [p.kind for p in ref.units[0].plans]
    lines = ['1.2.3.4 "10.0.0.1:80" "200" 200', '1.2.3.4 "-" "-" 200',
             '1.2.3.4 "10.0.0.1:80, 10.0.0.2:80" "502, 200" 502',
             '1.2.3.4 "unix:/tmp/s" "200" 200', '1.2.3.4 "a : b" "x" 200']
    lines += [f'9.9.9.{i % 250} "10.1.{i % 256}.{i // 256}:8080" "{200 + i % 4}" 200'
              for i in range(100)]
    assert packed_mismatch(ref, lines) is None
    _compare(ours_p.parse_batch(lines), ref.parse_batch(lines), lines, ULIST_FIELDS)


def test_numeric_upstream_list_element_matches_reference():
    """A numeric upstream-list element is typed by the host's casts: the
    oracle delivers it, equal to the reference on every line."""
    ours = assert_parse_matches_reference(
        '$remote_addr "$upstream_response_length"',
        ["BYTES:nginxmodule.upstream.response.length.0.value", "IP:connection.client.host"],
        ['1.2.3.4 "12, 34"', '1.2.3.4 "-"', '1.2.3.4 "7 : 8"', '1.2.3.4 "x"', "junk"])
    assert ours.to_pylist("BYTES:nginxmodule.upstream.response.length.0.value")[0] == 12


BYTES_FIELDS = ["BYTESCLF:response.body.bytes", "BYTES:response.body.bytes",
                "IP:connection.client.host"]


def test_bytesclf_over_percent_b_matches_reference():
    """%B's BYTES through the number -> CLF conversion: 0 reads null, a
    leading zero and a value past Long.MAX go to the host, a 20-digit run
    fails the conversion; BYTES itself keeps the >19-digit patch."""
    fmt = "%h %B"
    ref = TpuBatchParser(fmt, BYTES_FIELDS)
    assert ref._unit_oracle_fields == [[]]
    lines = ["1.2.3.4 0", "1.2.3.4 00", "1.2.3.4 007", "1.2.3.4 123", "1.2.3.4 -",
             "1.2.3.4 12345678901234567890", "1.2.3.4 9223372036854775808",
             "1.2.3.4 9223372036854775807", "1.2.3.4 "]
    lines += [f"1.2.3.{i % 250} {i * 7919 % 100000}" for i in range(100)]
    assert packed_mismatch(ref, lines) is None
    ours = TorchBatchParser(fmt, BYTES_FIELDS, device="cpu").parse_batch(lines)
    _compare(ours, ref.parse_batch(lines), lines, BYTES_FIELDS)
    clf = ours.to_pylist("BYTESCLF:response.body.bytes")
    assert clf[0] is None and clf[3] == 123
    assert {1, 2} <= set(ours.needs_host.tolist())


def test_query_string_over_a_token_matches_reference():
    """NGINX $args: the query-string split over a token's span (no '?'
    skip, no URI encode set, the CLF-dash guard), its values URL-decoded
    on the host as the reference's are."""
    fmt = '$remote_addr [$time_local] "$args" $status'
    fields = ["STRING:request.firstline.uri.query.*", "STRING:request.firstline.uri.query.k",
              "STRING:request.status.last"]
    ref = TpuBatchParser(fmt, fields)
    assert ref._unit_oracle_fields == [[]]
    args = ["K=kelvin", "k=plain", "x=1", "a=%41&b=+&k=%zz", "%zz", "-", "", "k", "=v",
            "k=1&k=2", "a=b=c&k=%u0041", "q=caf%C3%A9&k=x+y", "K=kelvin"]
    lines = [f'1.2.3.4 [01/Jan/2024:00:00:00 +0000] "{a}" 200' for a in args]
    assert packed_mismatch(ref, lines) is None
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    _compare(ours, ref.parse_batch(lines), lines, fields)
