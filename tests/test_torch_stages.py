"""The span post-stages and the timestamp parser equal the reference.

Plain PyTorch versions of logparser_tpu_torch (the CPU side of the
``span_stages`` and ``timestamp`` kernels) against logparser_tpu's jnp
stages on the same numpy-seeded buffers and spans: gather, first-line
split, the 19-digit long frame, the view prefix words and the timestamp
components, all exact -- including the int32 wraparound the reference
computes on garbage bytes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.tpu import pipeline as ref_pipeline
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu import timeparse as ref_timeparse
from logparser_tpu.tools.demolog import HEADLINE_FIELDS
from logparser_tpu_torch.tpu import postproc, timeparse
from logparser_tpu_torch.tpu.carry import units_from_reference
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import corpus, jax_unit_plain, reference_parser

ALPHABET = np.frombuffer(b"GETPOSHT/1.0 2-\"x9a.\\:[]+Jan", dtype=np.uint8)


def _buffers(seed, B=200, L=128):
    rng = np.random.default_rng(seed)
    buf = rng.choice(ALPHABET, size=(B, L)).astype(np.uint8)
    s = rng.integers(0, L + 8, size=B).astype(np.int32)
    e = (s + rng.integers(-3, 40, size=B)).astype(np.int32)
    return buf, np.minimum(s, L), np.clip(e, 0, L)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ours, ref, what):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref), err_msg=what)


@pytest.mark.parametrize("L", [64, 96, 128, 512])
def test_gather_matches_reference(L):
    rng = np.random.default_rng(L)
    buf = rng.integers(0, 256, size=(64, L), dtype=np.uint8)
    start = rng.integers(0, 2 * L + 40, size=64).astype(np.int32)
    for width in (1, 5, 12, 19):
        ours = postproc.gather_span_bytes(_t(buf), _t(start), width).numpy()
        ref = ref_postproc.gather_span_bytes(jnp.asarray(buf), jnp.asarray(start), width)
        _eq(ours, ref, f"gather width {width}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_firstline_matches_reference(seed):
    buf, s, e = _buffers(seed)
    lines = [b'GET /a HTTP/1.1', b"GET /x", b"POST  /y  HTTP/2.0", b"-", b"",
             b"GET / HTTP/1.1.1", b"A B HTTP/1.", b"A B HTTP/x.1", b"A B HTTP/10.25"]
    rbuf, rlen, _ = encode_batch(lines, line_len=128)
    buf = np.concatenate([buf, rbuf])
    s = np.concatenate([s, np.zeros(len(lines), np.int32)])
    e = np.concatenate([e, rlen])
    ours = postproc.split_firstline(_t(buf), _t(s), _t(e))
    ref = ref_postproc.split_firstline(jnp.asarray(buf), None, jnp.asarray(s),
                                       jnp.asarray(e))
    for k in ref:
        _eq(ours[k].numpy(), ref[k], k)
    assert ours["has_protocol"].any() and (~ours["has_protocol"]).any()


@pytest.mark.parametrize("clf", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_long_spans_match_reference(clf, seed):
    rng = np.random.default_rng(seed)
    digits = [str(int(x)) for x in rng.integers(0, 10 ** 9, size=40)]
    nums = ["-", "", "0", "007", "12345678901234567890", "9" * 19, "9223372036854775808",
            "12a4", "1" * 25] + digits + ["".join(rng.choice(list("0123456789-x"), size=k))
                                           for k in rng.integers(0, 24, size=40)]
    buf, lengths, _ = encode_batch(nums, line_len=64)
    buf2, s2, e2 = _buffers(seed, B=100, L=64)   # garbage windows (wrapping sums)
    buf = np.concatenate([buf, buf2])
    s = np.concatenate([np.zeros(len(nums), np.int32), s2])
    e = np.concatenate([lengths, e2])
    (hi, lo, d18, nd), null, ok, big = postproc.parse_long_spans(_t(buf), _t(s), _t(e), clf)
    (rhi, rlo, rd18, rnd), rnull, rok, rbig = ref_postproc.parse_long_spans(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e), clf=clf
    )
    for name, a, b in (("hi", hi, rhi), ("lo", lo, rlo), ("d18", d18, rd18),
                       ("ndig", nd, rnd), ("null", null, rnull), ("ok", ok, rok),
                       ("big", big, rbig)):
        _eq(a.numpy(), b, name)
    values, _, _ = postproc.combine_long_limbs(hi.numpy(), lo.numpy(), d18.numpy(),
                                               nd.numpy(), null.numpy())
    want, _, _ = ref_postproc.combine_long_limbs(np.asarray(rhi), np.asarray(rlo),
                                                 np.asarray(rd18), np.asarray(rnd),
                                                 np.asarray(rnull))
    _eq(values, want, "combined values")


@pytest.mark.parametrize("seed", [5, 6])
def test_prefix_words_match_reference(seed):
    buf, s, e = _buffers(seed)
    rng = np.random.default_rng(seed)
    ok = rng.random(len(s)) < 0.8
    null = rng.random(len(s)) < 0.2
    ours = postproc.span_prefix_words(_t(buf), _t(s), _t(e), _t(ok & ~null))
    ref = ref_pipeline.span_prefix_words(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e), jnp.asarray(ok),
        jnp.asarray(null), None, ref_postproc.gather_span_bytes,
    )
    for k in range(3):
        _eq(ours[k].numpy(), ref[k], f"word {k}")


def _timestamp_spans(seed):
    rng = np.random.default_rng(seed)
    stamps = []
    for _ in range(150):
        stamps.append("%02d/%s/%04d:%02d:%02d:%02d %s%02d%02d" % (
            rng.integers(0, 40), rng.choice(["Jan", "feb", "MAR", "Dex", "Jun", "sep"]),
            rng.integers(0, 3000), rng.integers(0, 30), rng.integers(0, 70),
            rng.integers(0, 62), rng.choice(["+", "-", " "]), rng.integers(0, 30),
            rng.integers(0, 70)))
    stamps += ["29/Feb/2024:12:00:00 +0000", "29/Feb/2023:12:00:00 +0000",
               "31/Apr/2024:12:00:00 +0000", "31/Dec/2024:23:59:60 -0930",
               "01/Jan/2024:00:00:00 +14:00", "01/Jan/2024:00:00:00 +140",
               "01/Jan/2024:00:00:00", "", "01/Jan/2024:00:00:00 +00000"]
    mutated = []
    for st in stamps[:60]:
        b = bytearray(st.encode() or b"x")
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        mutated.append(bytes(b))
    buf, lengths, _ = encode_batch(stamps + mutated, line_len=64)
    return buf, np.zeros(len(lengths), np.int32), lengths


@pytest.mark.parametrize("seed", [7, 8])
def test_timestamp_matches_reference(seed):
    ref_unit = reference_parser("combined", HEADLINE_FIELDS).units[0]
    (ref_plan,) = [p for p in ref_unit.plans if p.kind == "ts"]
    (plan,) = [p for p in units_from_reference([jax_unit_plain(ref_unit)])[0].plans
               if p.kind == "ts"]
    buf, s, e = _timestamp_spans(seed)
    comp, ok = timeparse.parse_device_timestamp(_t(buf), _t(s), _t(e), plan.meta)
    ref_comp, ref_ok = ref_timeparse.parse_device_timestamp(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e), ref_plan.meta,
        ref_postproc.gather_span_bytes,
    )
    _eq(ok.numpy(), ref_ok, "ok")
    for k in ref_comp:
        _eq(comp[k].numpy(), ref_comp[k], k)
    assert ok.any() and (~ok).any()


def test_timestamp_on_corpus_spans():
    """The timestamp token's real spans out of the split, garbage lines
    included."""
    ref_unit = reference_parser("combined", HEADLINE_FIELDS).units[0]
    (ref_plan,) = [p for p in ref_unit.plans if p.kind == "ts"]
    (plan,) = [p for p in units_from_reference([jax_unit_plain(ref_unit)])[0].plans
               if p.kind == "ts"]
    buf, lengths, _ = encode_batch(corpus(9))
    starts, ends, *_ = ref_pipeline.compute_split(
        ref_unit.program, jnp.asarray(buf), jnp.asarray(lengths), need_plausible=True
    )
    s, e = np.asarray(starts[3]), np.asarray(ends[3])
    comp, ok = timeparse.parse_device_timestamp(_t(buf), _t(s), _t(e), plan.meta)
    ref_comp, ref_ok = ref_timeparse.parse_device_timestamp(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e), ref_plan.meta,
        ref_postproc.gather_span_bytes,
    )
    _eq(ok.numpy(), ref_ok, "ok")
    for k in ref_comp:
        _eq(comp[k].numpy(), ref_comp[k], k)


def test_layouts_outside_the_slice_do_not_compile():
    from logparser_tpu.dissectors.timelayout import compile_java_pattern
    from logparser_tpu_torch.dissectors.timelayout import APACHE_LAYOUT, TimeLayout

    ref = compile_java_pattern("dd/MMM/yyyy:HH:mm:ss ZZ")
    assert APACHE_LAYOUT.items == ref.items
    assert timeparse.compile_layout_for_device(APACHE_LAYOUT) is not None
    for pattern in ("yyyy-MM-dd'T'HH:mm:ssXXX", "dd/MMMM/yyyy ZZ",
                    "hh:mm a dd/MM/yyyy ZZ", "dd/MM/yyyy z", "dd/MM/yy ZZ",
                    "HH:mm:ss ZZ", "dd/MM/yyyy"):
        items = compile_java_pattern(pattern).items
        assert timeparse.compile_layout_for_device(TimeLayout(items)) is None, pattern
