"""The port's host framing and its single-card utilities against the JAX
package, on the CPU.

- ``native.encode_blob`` (the g++ framer and ``_encode_blob_numpy``),
  ``_count_lines``, ``_bucket`` and ``runtime.encode_batch`` against the
  reference's (``logparser_tpu/native``, ``tpu/runtime.py``): the same
  bytes, lengths and overflow rows, on hypothesis blobs (seeded by
  hypothesis' own database-free derandomization) and crafted ones (CRLF,
  empty lines, no trailing newline, a 9,000-byte line, ``alloc=``);
- ``runtime.run_program`` against the reference's on headline,
  NUL-separated and escaped-quote inputs;
- ``postproc.unescape_compact_spans`` against the reference's on the
  fuzz cases of ``tests/test_fuzz_differential.py`` and a 2,000-line
  corpus with 5% escaped quotes (rows flagged exact also equal
  ``decode_apache_httpd_log_value``);
- ``GeoDeviceTable.gather`` against the reference's on the fixture City
  and ASN tables, with negative and out-of-range rows.

Every comparison is exact (integers and bytes, tolerance 0; floats bit for
bit, NaN included).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from logparser_tpu import native as ref_native
from logparser_tpu.dissectors.utils import decode_apache_httpd_log_value
from logparser_tpu.feeder.worker import _count_lines as ref_count_lines
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu import runtime as ref_runtime
from logparser_tpu_torch import TorchBatchParser, native
from logparser_tpu_torch.tools.demolog import (
    HEADLINE_FIELDS,
    force_escaped_quote_lines,
    generate_combined_lines,
)
from logparser_tpu_torch.tpu import postproc, runtime
from test_torch_harness import EDGE_LINES, corpus, reference_parser

BLOBS = [
    b"",
    b"one line no newline",
    b"a\nbb\nccc\n",
    b"a\r\nb\r\n",
    b"a\r\nb\rc\r\r\n\r",
    b"\n\n",
    b"\n",
    b"\r",
    b"x" * 9000 + b"\nshort\n",
    b"x" * 9000,
    bytes(range(1, 10)) + b"\n" + b"\xff\xfe binary ok\n",
    b"\x00\x00\n\x00",
]

# Bytes a framer treats specially, and a few plain ones.
_BLOB_BYTES = st.sampled_from(list(b"\n\r\x00 ab\"\\\xff"))
_blobs = st.lists(_BLOB_BYTES, max_size=400).map(bytes)
_lines = st.lists(st.one_of(st.lists(_BLOB_BYTES, max_size=40).map(bytes),
                            st.text(max_size=20)), max_size=30)


def _same(got, want):
    (b1, l1, o1), (b2, l2, o2) = got, want
    assert b1.dtype == b2.dtype == np.uint8 and l1.dtype == l2.dtype == np.int32
    assert b1.shape == b2.shape
    assert np.array_equal(b1, b2) and np.array_equal(l1, l2)
    assert list(o1) == list(o2)


def test_the_framer_builds():
    assert native.native_available(), "g++ is in this container"
    assert native.framer() == "native"


@pytest.mark.parametrize("blob", BLOBS)
@pytest.mark.parametrize("line_len", [0, 64, 8191])
def test_encode_blob_equals_the_reference(blob, line_len):
    want = ref_native.encode_blob(blob, line_len=line_len)
    _same(native.encode_blob(blob, line_len=line_len), want)
    _same(native._encode_blob_numpy(blob, line_len, 64, 8191),
          ref_native._encode_blob_numpy(blob, line_len, 64, 8191))
    assert native._count_lines(blob) == ref_count_lines(blob) == want[0].shape[0]


@settings(max_examples=150, deadline=None, derandomize=True)
@given(blob=_blobs, min_bucket=st.sampled_from([32, 64, 128]))
def test_encode_blob_equals_the_reference_on_any_bytes(blob, min_bucket):
    want = ref_native.encode_blob(blob, min_bucket=min_bucket, cap=256)
    _same(native.encode_blob(blob, min_bucket=min_bucket, cap=256), want)
    _same(native._encode_blob_numpy(blob, 0, min_bucket, 256),
          ref_native._encode_blob_numpy(blob, 0, min_bucket, 256))
    assert native._count_lines(blob) == ref_count_lines(blob)


@pytest.mark.parametrize("blob", [b"a\nbb\n", b"", b"y" * 9000 + b"\nok\r\n"])
@pytest.mark.parametrize("numpy_path", [False, True])
def test_encode_blob_alloc_frames_into_the_given_arrays(blob, numpy_path):
    """``alloc`` hands out destination arrays full of garbage: the framed
    rows, their padding and the lengths (overflow bit stripped in place)
    are written over all of it."""
    given_arrays = []

    def alloc(n, L):
        buf = np.full((n, L), 0xAB, dtype=np.uint8)
        lengths = np.full(n, -7, dtype=np.int32)
        given_arrays.append((buf, lengths))
        return buf, lengths

    if numpy_path:
        got = native._encode_blob_numpy(blob, 0, 64, 8191, alloc=alloc)
    else:
        got = native.encode_blob(blob, alloc=alloc)
    _same(got, ref_native.encode_blob(blob))
    (buf, lengths), = given_arrays
    if got[0].shape[0]:
        assert np.shares_memory(got[0], buf) and np.shares_memory(got[1], lengths)
    else:   # the empty blob's placeholder row is cleared
        assert not buf.any() and not lengths.any()


def test_bucket_rule_is_the_reference_rule():
    for max_len in list(range(0, 1100)) + [2047, 2048, 2049, 5000, 8191, 9000]:
        for min_bucket in (32, 64, 128, 256):
            want = ref_native._bucket(max_len, min_bucket, 8191)
            assert native._bucket(max_len, min_bucket, 8191) == want
            assert runtime.bucket_length(max_len, min_bucket) == \
                ref_runtime.bucket_length(max_len, min_bucket)


def _reference_takes_native_path(lines):
    raw = [ln.encode() if isinstance(ln, str) else ln for ln in lines]
    raw = [r[:-1] if r.endswith(b"\n") else r for r in raw]
    return bool(raw) and not any(b"\n" in r or r.endswith(b"\r") or not r for r in raw)


LINE_LISTS = [
    [b"simple", b"two words", b"trailing-cr\r", b"", b"with\nnewline"],
    [b"alpha", b"beta", b"gamma delta"],
    ["a\n", "b\n", "c"],
    ["a\n\n", "b"],
    ["a\r\n", "b"],
    ["x" * 9000, "short", "y" * 8191],
    ["", ""],
    ["\n"],
    [],
    ["café ☃", b"\xff\xfe", "\x00tail"],
]


@pytest.mark.parametrize("lines", LINE_LISTS)
def test_encode_batch_equals_the_reference(lines):
    want = ref_runtime.encode_batch(lines)
    _same(runtime.encode_batch(lines), want)
    framer = runtime.encode_lines(lines)[3]
    assert framer == ("native" if _reference_takes_native_path(lines) else "numpy")


@settings(max_examples=150, deadline=None, derandomize=True)
@given(lines=_lines, line_len=st.sampled_from([0, 64]))
def test_encode_batch_equals_the_reference_on_any_lines(lines, line_len):
    _same(runtime.encode_batch(lines, line_len=line_len),
          ref_runtime.encode_batch(lines, line_len=line_len))
    framer = runtime.encode_lines(lines, line_len=line_len)[3]
    assert framer == ("native" if _reference_takes_native_path(lines) else "numpy")


def test_encode_batch_takes_the_native_path_on_a_corpus():
    lines = generate_combined_lines(3000, seed=11, garbage_fraction=0.02)
    buf, lengths, overflow, framer = runtime.encode_lines(lines)
    assert framer == "native"
    _same((buf, lengths, overflow), ref_runtime.encode_batch(lines))


# --------------------------------------------------------------------------
# run_program


def _programs(fmt, fields):
    ref = reference_parser(fmt, fields).units[0].program
    ours = TorchBatchParser(fmt, fields, device="cpu").units[0].program
    return ref, ours


def _nul_lines():
    rng = np.random.default_rng(61)
    lines = []
    for ln in generate_combined_lines(600, seed=62, garbage_fraction=0.02):
        parts = ln.split(" ")
        line = (f"{parts[0]}\x00{parts[2]}\x00{parts[8]}" if len(parts) >= 9
                else ln).encode()
        if rng.random() < 0.1:
            line += b"\x00" * int(rng.integers(1, 4))
        lines.append(line)
    return lines


RUN_PROGRAM_CASES = {
    "headline": ("combined", HEADLINE_FIELDS, lambda: corpus(71, n=600)),
    "nul": ("%h\x00%u\x00%>s", ["IP:connection.client.host",
                                "STRING:connection.client.user",
                                "STRING:request.status.last"], _nul_lines),
    "escaped_quote": ("combined", HEADLINE_FIELDS, lambda: force_escaped_quote_lines(
        generate_combined_lines(600, seed=72, garbage_fraction=0.02), 5) + EDGE_LINES),
}


@pytest.mark.parametrize("name", sorted(RUN_PROGRAM_CASES))
def test_run_program_equals_the_reference(name):
    fmt, fields, make = RUN_PROGRAM_CASES[name]
    ref_prog, prog = _programs(fmt, fields)
    buf, lengths, _ = runtime.encode_batch(make())
    want = ref_runtime.run_program(ref_prog, buf, lengths)
    got = runtime.run_program(prog, buf, lengths, device="cpu")
    for k in ("starts", "ends", "valid"):
        assert got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["valid"].dtype == torch.bool and 0 < int(got["valid"].sum()) < len(lengths)
    # Tensors on the CPU route there too.
    again = runtime.run_program(prog, torch.from_numpy(buf), torch.from_numpy(lengths))
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_numpy_inputs_ask_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is satisfied")
    _, prog = _programs("combined", HEADLINE_FIELDS)
    buf, lengths, _ = runtime.encode_batch(["x"])
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.run_program(prog, buf, lengths)
    with pytest.raises(RuntimeError, match="CUDA"):
        postproc.unescape_compact_spans(buf, np.zeros(1, np.int32), lengths, 8)


# --------------------------------------------------------------------------
# unescape_compact_spans

FUZZ_CASES = [
    (b'esc \\" quote', True),
    (b"a\\\\b", True),
    (b'a\\\\\\"b', True),
    (b'run\\\\\\\\\\"x', True),
    (b'\\" \\" \\"', True),
    (b"plain", True),
    (b"tail\\\\", True),
    (b"a\\qb", True),
    (b"odd\\", False),
    (b"a\\nb", False),
    (b"\\x41z", False),
]


def _unescape_both(buf, start, end, width):
    want = ref_postproc.unescape_compact_spans(
        jnp.asarray(buf), jnp.asarray(start), jnp.asarray(end), width)
    got = postproc.unescape_compact_spans(buf, start, end, width, device="cpu")
    o1, n1, e1 = (np.asarray(x) for x in want)
    o2, n2, e2 = (x.numpy() for x in got)
    assert o2.dtype == np.uint8 and n2.dtype == np.int32 and e2.dtype == np.bool_
    assert o1.shape == o2.shape
    assert np.array_equal(o1, o2) and np.array_equal(n1, n2) and np.array_equal(e1, e2)
    return o2, n2, e2


@pytest.mark.parametrize("width", [32, 8, 64])
def test_unescape_equals_the_reference_on_the_fuzz_cases(width):
    L = max(len(c) for c, _ in FUZZ_CASES) + 2
    buf = np.zeros((len(FUZZ_CASES), L), dtype=np.uint8)
    for i, (c, _) in enumerate(FUZZ_CASES):
        buf[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
    start = np.zeros(len(FUZZ_CASES), dtype=np.int32)
    end = np.array([len(c) for c, _ in FUZZ_CASES], dtype=np.int32)
    out, out_len, exact = _unescape_both(buf, start, end, width)
    for i, (c, want_exact) in enumerate(FUZZ_CASES):
        if len(c) <= min(width, L):
            assert bool(exact[i]) == want_exact, c
        if exact[i]:
            ref = decode_apache_httpd_log_value(c.decode("latin-1")).encode("latin-1")
            assert bytes(out[i, :out_len[i]]) == ref, c


def test_unescape_equals_the_reference_on_an_escaped_corpus():
    lines = force_escaped_quote_lines(generate_combined_lines(2000, seed=73), 5)
    buf, _, _ = runtime.encode_batch(lines)
    start = np.array([ln.rindex(' "') + 2 for ln in lines], dtype=np.int32)
    end = np.array([len(ln) - 1 for ln in lines], dtype=np.int32)
    width = min(int((end - start).max()) + 1, buf.shape[1])
    out, out_len, exact = _unescape_both(buf, start, end, width)
    assert exact.all() and int((out_len < end - start).sum()) == 100
    for i in range(0, len(lines), 7):
        span = bytes(buf[i, start[i]:end[i]]).decode("latin-1")
        assert bytes(out[i, :out_len[i]]) == \
            decode_apache_httpd_log_value(span).encode("latin-1")


@pytest.mark.parametrize("L,width", [(64, 32), (64, 100), (128, 7), (40, 40)])
def test_unescape_equals_the_reference_on_random_bytes(L, width):
    """Backslashes, quotes and escape letters; starts and ends past both
    edges, start bits above bit_length(L - 1)."""
    rng = np.random.default_rng(L * 1000 + width)
    alpha = np.frombuffer(b'\\\\\\"abnrtvxq ', dtype=np.uint8)
    B = 2000
    buf = alpha[rng.integers(0, len(alpha), (B, L))].astype(np.uint8)
    start = rng.integers(-5, L + 3, B).astype(np.int32)
    end = (start + rng.integers(-3, L + 5, B)).astype(np.int32)
    start[:50] += np.int32(1 << 12)
    _unescape_both(buf, start, end, width)


# --------------------------------------------------------------------------
# GeoDeviceTable.gather


def _tables():
    import os

    from logparser_tpu.geoip.device import GeoDeviceTable as RefTable
    from logparser_tpu.geoip.mmdb import MMDBReader as RefReader
    from logparser_tpu_torch.geoip import GeoDeviceTable, MMDBReader
    from logparser_tpu_torch.geoip.device import _EXTRACTORS
    from logparser_tpu_torch.tools.geoip_testdata import (
        ensure_synthetic_city_database,
        ensure_test_databases,
    )

    fixtures = ensure_test_databases()
    paths = [os.path.join(fixtures, name)
             for name in ("GeoIP2-City-Test.mmdb", "GeoLite2-ASN-Test.mmdb")]
    paths.append(ensure_synthetic_city_database(3001, seed=9))
    for path in paths:
        cols = list(_EXTRACTORS)
        yield (os.path.basename(path), RefTable(RefReader(path), cols),
               GeoDeviceTable(MMDBReader(path), cols))


def test_gather_equals_the_reference_on_the_fixture_tables():
    """The fixture City and ASN tables (one range each) and a synthetic
    City table of 3,001 networks: every row, random rows in [-2N, 2N),
    and crafted ones past both ends."""
    rng = np.random.default_rng(74)
    sizes = []
    for name, ref, ours in _tables():
        n = len(ours) + 1
        sizes.append(n)
        rows = np.concatenate([np.arange(n), rng.integers(-2 * n, 2 * n, 500),
                               [-1, -2, -n, -n - 1, -n - 5, n, n + 1, 10**6,
                                2**31 - 1, -2**31]]).astype(np.int32)
        for column in ours.columns:
            want = np.asarray(ref.gather(column, jnp.asarray(rows)))
            got = ours.gather(column, rows, device="cpu")
            assert got.dtype == torch.from_numpy(ours.arrays[column]).dtype
            got = got.numpy()
            if got.dtype.kind == "f":
                assert np.array_equal(got, want, equal_nan=True), (name, column)
            else:
                # The reference gathers int64 columns as int32 (JAX without
                # x64): equal below 2**31, which every fixture ASN is.
                assert int(np.abs(got).max()) < 2**31
                assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
                    (name, column)
            # A tensor of rows routes by its device.
            again = ours.gather(column, torch.from_numpy(rows))
            assert np.array_equal(again.numpy(), got, equal_nan=got.dtype.kind == "f")
    assert sizes == [2, 2, 3002]


def test_gather_columns_equals_the_reference_gather_per_column():
    """gather_columns on the fixture tables -- every column in one call,
    and a subset in another order -- equals the reference's gather of each
    column (by value, NaN for NaN; int64 below 2**31), from one plain
    call and no launch on the CPU."""
    from logparser_tpu_torch.tpu import kernels

    rng = np.random.default_rng(75)
    for name, ref, ours in _tables():
        n = len(ours) + 1
        rows = np.concatenate([rng.integers(-2 * n, 2 * n, 300),
                               [-1, -n, -n - 1, n, 2**31 - 1, -2**31]]).astype(np.int32)
        subset = ["asn.number", "location.latitude", "city.name", "country.iso"]
        kernels.reset_launch_counts()
        for columns in (ours.columns, subset):
            got = ours.gather_columns(columns, rows, device="cpu")
            assert list(got) == list(columns), name
            for column in columns:
                want = np.asarray(ref.gather(column, jnp.asarray(rows)))
                g = got[column]
                assert g.dtype == torch.from_numpy(ours.arrays[column]).dtype
                g = g.numpy()
                if g.dtype.kind == "f":
                    assert np.array_equal(g, want, equal_nan=True), (name, column)
                else:
                    assert int(np.abs(g).max()) < 2**31
                    assert np.array_equal(g.astype(np.int64), want.astype(np.int64)), \
                        (name, column)
        assert kernels.launch_counts()["geo_gather"] == 0   # CPU: the plain version
        assert ours.gather_columns([], rows, device="cpu") == {}


def test_geo_gather_wrapper_checks_its_inputs():
    """One launch takes 1 to 13 columns (a table's extractors) of one N,
    float32, int32 or int64, on the rows' device."""
    from logparser_tpu_torch.geoip.device import _EXTRACTORS
    from logparser_tpu_torch.tpu import kernels

    rows = torch.tensor([0, -1, 5], dtype=torch.int32)
    col = torch.arange(4, dtype=torch.int32)
    assert kernels.GATHER_MAX_COLUMNS == len(_EXTRACTORS)
    with pytest.raises(ValueError, match="columns"):
        kernels.geo_gather([], rows)
    with pytest.raises(ValueError, match="columns"):
        kernels.geo_gather([col] * (len(_EXTRACTORS) + 1), rows)
    with pytest.raises(ValueError, match="one N"):
        kernels.geo_gather([col, torch.arange(5, dtype=torch.int32)], rows)
    with pytest.raises(TypeError):
        kernels.geo_gather([col.to(torch.int16)], rows)
    with pytest.raises(TypeError):
        kernels.geo_gather([col], rows.to(torch.int64))
    got = kernels.geo_gather([col, col.to(torch.int64) * 2**40], rows)
    assert [g.tolist() for g in got] == [[0, 3, 3], [0, 3 * 2**40, 3 * 2**40]]


def test_kernel_signatures_match_the_sources():
    """Each kernel's ctypes argument list has one entry per parameter of
    its C entry point (the stream last): an entry short would pass the
    stream pointer as a 32-bit int.  Read from csrc/, so it runs here."""
    import re

    from logparser_tpu_torch.tpu import kernels

    assert set(kernels._SIGNATURES) == set(kernels.KERNELS)
    for k in kernels.KERNELS:
        src = (kernels.CSRC / f"{k}.cu").read_text()
        m = re.search(rf"LP_EXPORT int lp_{k}\(([^)]*)\)", src)
        params = [p.strip() for p in m.group(1).split(",")]
        assert params[-1].endswith("stream"), k
        assert len(kernels._SIGNATURES[k]) == len(params), k
        ptr = [("*" in p) for p in params]
        assert ptr == [t is kernels._P for t in kernels._SIGNATURES[k]], k
