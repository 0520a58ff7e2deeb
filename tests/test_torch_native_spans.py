"""The port's native delivery passes against the JAX package's, on the CPU.

Each span, view and repair function of ``logparser_tpu_torch.native`` --
``gather_spans``, ``gather_spans_multi``, ``copy_spans``,
``scatter_spans``, ``build_views``, ``patch_views``, ``views_interleave``,
``repair_spans``, ``assemble_special`` and ``_ramp`` -- is held equal to
the same function of ``logparser_tpu.native`` (byte for byte), on
hypothesis inputs (derandomized) and crafted ones: empty spans, spans
that end at the row's end, null rows, values past a view's 12 inline
bytes and past 64 KB, ``fix`` / ``amp`` special rows with good and bad
escapes, encode-set and non-ASCII bytes.  Where a port wrapper keeps a
numpy fallback (the library absent), the fallback is held equal to the
native path; where it has none (``views_interleave``, ``repair_spans``,
``assemble_special``) it returns None, as the reference's does, and the
bridge's own numpy repair (``arrow_bridge._repair_fix_segments``) is held
equal to the native one.
"""
import contextlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from logparser_tpu import native as ref_native
from logparser_tpu.tpu import arrow_bridge as ref_bridge
from logparser_tpu_torch import native
from logparser_tpu_torch.tpu import arrow_bridge

ALPHABET = b"aZ09%fF+?&= ;\"<{|\x80\xc3\xa9\xff"
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True)


@contextlib.contextmanager
def without_library():
    """The port's wrappers with the library absent (their numpy paths)."""
    saved = native.get_lib
    native.get_lib = lambda: None
    try:
        yield
    finally:
        native.get_lib = saved


@st.composite
def span_cases(draw, max_b=6, max_l=48):
    """(buf [B, L], starts [K, B], lens [K, B]) with spans inside each row,
    empty ones and ones ending at the row's end included."""
    B = draw(st.integers(0, max_b))
    L = draw(st.integers(1, max_l))
    K = draw(st.integers(1, 3))
    raw = draw(st.binary(min_size=B * L, max_size=B * L))
    buf = np.frombuffer(bytes(ALPHABET[c % len(ALPHABET)] for c in raw),
                        dtype=np.uint8).reshape(B, L).copy()
    starts = np.zeros((K, B), dtype=np.int32)
    lens = np.zeros((K, B), dtype=np.int64)
    for k in range(K):
        for r in range(B):
            s = draw(st.integers(0, L))
            kind = draw(st.sampled_from(["any", "empty", "to_end"]))
            n = {"empty": 0, "to_end": L - s}.get(kind) if kind != "any" else draw(
                st.integers(0, L - s))
            starts[k, r], lens[k, r] = s, n
    return buf, starts, lens


def _wide_case():
    """Two rows of 70,000 bytes: spans of 0, 12, 13 and 65,600 bytes, one
    ending at the row's end."""
    rng = np.random.default_rng(19)
    L = 70_000
    buf = rng.choice(np.frombuffer(ALPHABET, dtype=np.uint8), size=(2, L))
    starts = np.array([[0, L - 65_600], [5, L - 13], [L, 7]], dtype=np.int32)
    lens = np.array([[65_600, 65_600], [12, 13], [0, 66_000]], dtype=np.int64)
    return buf, starts, lens


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@SETTINGS
@given(case=span_cases())
def test_gather_spans_equal_reference(case):
    buf, starts, lens = case
    got = native.gather_spans(buf, starts[0], lens[0])
    _same(got, ref_native.gather_spans(buf, starts[0], lens[0]))
    got_m = native.gather_spans_multi(buf, starts, lens)
    _same(got_m, ref_native.gather_spans_multi(buf, starts, lens))


def test_gather_spans_wide_and_numpy():
    buf, starts, lens = _wide_case()
    want = ref_native.gather_spans_multi(buf, starts, lens)
    _same(native.gather_spans_multi(buf, starts, lens), want)
    _same(native.gather_spans(buf, starts[0], lens[0]),
          ref_native.gather_spans(buf, starts[0], lens[0]))
    with without_library():
        _same(native.gather_spans_multi(buf, starts, lens), want)
        _same(native.gather_spans(buf, starts[2], lens[2]),
              ref_native.gather_spans(buf, starts[2], lens[2]))


@SETTINGS
@given(case=span_cases())
def test_gather_numpy_fallback_equals_native(case):
    buf, starts, lens = case
    nat = (native.gather_spans(buf, starts[0], lens[0]),
           native.gather_spans_multi(buf, starts, lens))
    with without_library():
        fb = (native.gather_spans(buf, starts[0], lens[0]),
              native.gather_spans_multi(buf, starts, lens))
    _same(nat[0], fb[0])
    _same(nat[1], fb[1])


@st.composite
def copy_cases(draw):
    n_src = draw(st.integers(0, 200))
    src = np.frombuffer(draw(st.binary(min_size=n_src, max_size=n_src)), dtype=np.uint8)
    n = draw(st.integers(0, 8))
    src_off, lens = [], []
    for _ in range(n):
        s = draw(st.integers(0, n_src))
        src_off.append(s)
        lens.append(draw(st.integers(0, n_src - s)))
    return src, np.asarray(src_off, dtype=np.int64), np.asarray(lens, dtype=np.int64)


def _copy_scatter(mod, src, src_off, lens):
    dst_off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=dst_off[1:])
    copied = mod.copy_spans(src, src_off, dst_off)
    # Scatter into a buffer with 3-byte gaps, the rows in reverse order.
    at, pos = np.zeros(len(lens), dtype=np.int64), 1
    for r in reversed(range(len(lens))):
        at[r], pos = pos, pos + int(lens[r]) + 3
    out = np.full(pos, 0xEE, dtype=np.uint8)
    mod.scatter_spans(src, src_off, lens, out, at)
    return copied, out


@SETTINGS
@given(case=copy_cases())
def test_copy_and_scatter_equal_reference(case):
    src, src_off, lens = case
    got = _copy_scatter(native, src, src_off, lens)
    _same(got, _copy_scatter(ref_native, src, src_off, lens))
    with without_library():
        fb = _copy_scatter(native, src, src_off, lens)
    _same(got, fb)


def test_copy_spans_wide():
    src = np.random.default_rng(3).integers(0, 256, 200_000, dtype=np.uint8)
    src_off = np.array([0, 100_000, 199_990], dtype=np.int64)
    lens = np.array([70_000, 0, 10], dtype=np.int64)
    want = _copy_scatter(ref_native, src, src_off, lens)
    _same(_copy_scatter(native, src, src_off, lens), want)
    with without_library():
        _same(_copy_scatter(native, src, src_off, lens), want)
    with pytest.raises(TypeError):
        native.copy_spans(src.astype(np.int16), src_off, np.zeros(4, np.int64))


def _null_some(lens, seed):
    """lens as int32 with every fifth row a null (-1)."""
    out = lens.astype(np.int32).copy()
    out.reshape(-1)[seed % 5::5] = -1
    return out


@SETTINGS
@given(case=span_cases(), seed=st.integers(0, 4))
def test_build_views_equal_reference(case, seed):
    buf, starts, lens = case
    lens32 = _null_some(lens, seed)
    got = native.build_views(buf, starts, lens32).copy()
    assert np.array_equal(got, ref_native.build_views(buf, starts, lens32))
    with without_library():
        fb = native.build_views(buf, starts, lens32).copy()
    assert np.array_equal(got, fb)


def test_build_views_wide_and_guard():
    buf, starts, lens = _wide_case()
    lens32 = np.minimum(lens, 70_000 - starts).astype(np.int32)
    want = ref_native.build_views(buf, starts, lens32).copy()
    assert np.array_equal(native.build_views(buf, starts, lens32), want)
    with without_library():
        assert np.array_equal(native.build_views(buf, starts, lens32), want)
    big = np.zeros((1, 1), dtype=np.uint8)
    with pytest.raises(ValueError):
        native.build_views(np.broadcast_to(big, (2**16, 2**15)), np.zeros((1, 2**16), np.int32),
                           np.zeros((1, 2**16), np.int32))


@st.composite
def patch_cases(draw):
    B = draw(st.integers(1, 8))
    n = draw(st.integers(0, B))
    rows = np.asarray(draw(st.permutations(range(B)))[:n], dtype=np.int64)
    lens = np.asarray([draw(st.sampled_from([0, 1, 12, 13, 40])) for _ in range(n)],
                      dtype=np.int64)
    side_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=side_off[1:])
    side = np.frombuffer(draw(st.binary(min_size=int(side_off[-1]),
                                        max_size=int(side_off[-1]))), dtype=np.uint8)
    views = np.frombuffer(draw(st.binary(min_size=16 * B, max_size=16 * B)),
                          dtype=np.uint8).reshape(B, 16)
    return views, rows, side, side_off, draw(st.integers(1, 3))


@SETTINGS
@given(case=patch_cases())
def test_patch_views_equal_reference(case):
    views, rows, side, side_off, bi = case
    got, want, fb = views.copy(), views.copy(), views.copy()
    native.patch_views(got, rows, side, side_off, bi)
    ref_native.patch_views(want, rows, side, side_off, bi)
    assert np.array_equal(got, want)
    with without_library():
        native.patch_views(fb, rows, side, side_off, bi)
    assert np.array_equal(got, fb)


@st.composite
def packed_cases(draw):
    """A [R, stride] int32 block of view rows: merged words (start | len
    << 13 | live << 26) over a [B, L] buffer and random prefix words."""
    B = draw(st.integers(0, 9))
    stride = B + draw(st.integers(0, 3))
    L = draw(st.integers(1, 64))
    F = draw(st.integers(1, 3))
    rng = np.random.default_rng(draw(st.integers(0, 2**16)))
    block = rng.integers(-2**31, 2**31, size=(4 * F, stride), dtype=np.int64).astype(np.int32)
    for f in range(F):
        s = rng.integers(0, L + 1, size=stride)
        n = np.minimum(rng.integers(0, 40, size=stride), L - s)
        live = rng.random(stride) < 0.8
        block[4 * f] = (s | (n << 13) | (live.astype(np.int64) << 26)).astype(np.int32)
    rows = np.asarray(draw(st.permutations(range(F))), dtype=np.int64) * 4
    return block, rows, B, L


@SETTINGS
@given(case=packed_cases())
def test_views_interleave_equal_reference(case):
    block, rows, B, L = case
    got = native.views_interleave(block, rows, B, L).copy()
    want = ref_native.views_interleave(block, rows, B, L)
    assert np.array_equal(got, want)


def test_views_interleave_refusals():
    block = np.zeros((4, 3), dtype=np.int32)
    with without_library():
        assert native.views_interleave(block, np.zeros(1, np.int64), 3, 8) is None


def test_views_interleave_refuses_what_the_reference_refuses():
    block = np.zeros((4, 6), dtype=np.int32)
    rows = np.zeros(1, np.int64)
    for args in [(block[:, ::2], rows, 3, 8), (block.astype(np.int64), rows, 3, 8),
                 (block, rows, 2**16, 2**15)]:
        assert native.views_interleave(*args) is None
        assert ref_native.views_interleave(*args) is None


@st.composite
def repair_cases(draw):
    n = draw(st.integers(0, 10))
    pieces = [draw(st.sampled_from(
        [b"", b"%", b"%2", b"%zz", b"%41", b"%c3%a9", b"%E9", b"a b", b"x{y}|z",
         b"\xc3\xa9", b"\xff", b"plain", b"%%41", b"^[]`<>\"", b"a%2"]))
        + draw(st.binary(max_size=4).map(
            lambda b: bytes(ALPHABET[c % len(ALPHABET)] for c in b)))
        for _ in range(n)]
    seg = np.frombuffer(b"".join(pieces), dtype=np.uint8)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(p) for p in pieces], out=off[1:])
    return seg, off


@SETTINGS
@given(case=repair_cases(), escape=st.booleans())
def test_repair_spans_equal_reference(case, escape):
    seg, off = case
    got = native.repair_spans(seg, off, escape, arrow_bridge._IS_ENC)
    want = ref_native.repair_spans(seg, off, escape, ref_bridge._IS_ENC)
    _same(got, want)


@pytest.mark.parametrize("mode", ["path", "query", "userinfo", ""])
def test_repair_fix_segments_native_numpy_and_reference(mode):
    """The bridge's repair (native passes + Python rows) equals the
    reference's and the bridge's numpy path, over every crafted piece and
    a 70,000-byte value."""
    pieces = [b"", b"%", b"%2", b"%zz", b"%41", b"%c3%a9", b"%E9", b"a b", b"x{y}|z",
              b"\xc3\xa9", b"\xff", b"plain", b"%%41", b"^[]`<>\"", b"a%2",
              b"q=%2x&r=%41+b", b"%" * 70_000]
    seg = np.frombuffer(b"".join(pieces), dtype=np.uint8)
    off = np.zeros(len(pieces) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in pieces], out=off[1:])

    def flat(out):
        data, lens = out
        return bytes(np.asarray(data)), np.asarray(lens).tolist()

    got = flat(arrow_bridge._repair_fix_segments(seg, off, mode))
    assert got == flat(ref_bridge._repair_fix_segments(seg, off, mode))
    with without_library():
        assert flat(arrow_bridge._repair_fix_segments(seg, off, mode)) == got


@st.composite
def special_cases(draw):
    case = draw(span_cases(max_b=8, max_l=40))
    buf, starts, lens = case
    B = buf.shape[0]
    n = draw(st.integers(0, B))
    rows = np.sort(np.asarray(draw(st.permutations(range(B)))[:n], dtype=np.int64))
    fix = np.asarray([draw(st.booleans()) for _ in range(n)], dtype=np.uint8)
    amp = np.asarray([draw(st.booleans()) for _ in range(n)], dtype=np.uint8)
    return buf, starts[0], rows, lens[0][rows], fix, amp, draw(st.integers(0, 1))


@SETTINGS
@given(case=special_cases())
def test_assemble_special_equal_reference(case):
    buf, starts, rows, span_lens, fix, amp, mode = case
    B = buf.shape[0]
    views0 = np.arange(16 * B, dtype=np.uint8).reshape(B, 16)
    got_v, want_v = views0.copy(), views0.copy()
    got = native.assemble_special(buf, starts, rows, span_lens, fix, amp, mode,
                                  arrow_bridge._IS_ENC, got_v, 2)
    want = ref_native.assemble_special(buf, starts, rows, span_lens, fix, amp, mode,
                                       ref_bridge._IS_ENC, want_v, 2)
    _same(got, want)
    assert np.array_equal(got_v, want_v)


def test_without_the_library_the_fused_passes_return_none():
    seg = np.frombuffer(b"%41", dtype=np.uint8)
    off = np.array([0, 3], dtype=np.int64)
    buf = np.zeros((1, 4), dtype=np.uint8)
    with without_library():
        assert native.repair_spans(seg, off, False, arrow_bridge._IS_ENC) is None
        assert native.assemble_special(buf, np.zeros(1, np.int32), np.zeros(1, np.int64),
                                       np.ones(1, np.int64), np.ones(1, np.uint8),
                                       np.zeros(1, np.uint8), 0, arrow_bridge._IS_ENC,
                                       np.zeros((1, 16), np.uint8), 1) is None


@SETTINGS
@given(lens=st.lists(st.integers(1, 30), max_size=12))
def test_ramp_equal_reference(lens):
    arr = np.asarray(lens, dtype=np.int64)
    assert np.array_equal(native._ramp(arr), ref_native._ramp(arr))


def test_pooled_buffer_is_not_reused_while_held():
    """A view array stays the pool's only while nothing holds it: a live
    Arrow buffer over it keeps the next batch from writing into it."""
    held = native._pooled_empty_u8(4112).reshape(257, 16)[3]
    other = native._pooled_empty_u8(4112)
    assert other.ctypes.data != held.base.ctypes.data
    addr = other.ctypes.data
    del other
    again = native._pooled_empty_u8(4112)
    assert again.ctypes.data == addr or not native._BUF_POOL_ENABLED
