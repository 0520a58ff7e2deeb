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
    """A layout the reference keeps on its host stays off the device here
    too ("HH:mm:ss ZZ" has no date); the others compile to the
    reference's device layout (XXX offsets, full month names, am/pm, zone
    text, two-digit years and default zones joined the slice with the
    strftime timestamps)."""
    from logparser_tpu.dissectors.timelayout import compile_java_pattern
    from logparser_tpu_torch.dissectors.timelayout import APACHE_LAYOUT, TimeLayout
    from logparser_tpu_torch.tpu.carry import time_layout_to_plain
    from test_torch_harness import assert_plain_equal

    ref = compile_java_pattern("dd/MMM/yyyy:HH:mm:ss ZZ")
    assert APACHE_LAYOUT.items == ref.items
    assert timeparse.compile_layout_for_device(APACHE_LAYOUT) is not None
    for pattern in ("yyyy-MM-dd'T'HH:mm:ssXXX", "dd/MMMM/yyyy ZZ",
                    "hh:mm a dd/MM/yyyy ZZ", "dd/MM/yyyy z", "dd/MM/yy ZZ",
                    "HH:mm:ss ZZ", "dd/MM/yyyy"):
        layout = compile_java_pattern(pattern)
        want = ref_timeparse.compile_layout_for_device(layout)
        got = timeparse.compile_layout_for_device(
            TimeLayout(layout.items, layout.default_zone))
        assert (got is None) == (want is None), pattern
        if got is not None:
            assert_plain_equal(time_layout_to_plain(got), time_layout_to_plain(want))
    items = compile_java_pattern("HH:mm:ss ZZ").items
    assert timeparse.compile_layout_for_device(TimeLayout(items)) is None


def _reference_span_rows(stages, buf, s, e):
    """Every task's rows of tools.kernel_ab.seeded_stage_tables, from the
    JAX package's functions: the span chain (split_firstline,
    split_protocol_version, the CLF dash through gather_span_bytes), the
    prefix words (span_prefix_words), the long frames (parse_long_spans,
    with the port's >19-digit span patch and zero_null leading-zero row)
    and parse_secmillis_spans."""
    from logparser_tpu_torch.tpu import pipeline as tp

    jb = jnp.asarray(buf)
    want = {}
    for task in stages.tasks_py:
        kind, tok, part, clf = task[:4]
        js, je = jnp.asarray(s[tok]), jnp.asarray(e[tok])
        first = ref_postproc.gather_span_bytes(jb, js, 1)[:, 0]
        dash = ((je - js) == 1) & (first == ord("-"))
        zeros = jnp.zeros_like(js, dtype=bool)
        if kind == tp.TASK_SPAN:
            start, end, ok, null = js, je, ~zeros, zeros
            if part == tp.PART_DIRECT:
                null = dash
            elif part == tp.PART_ULIST0:
                ok = ~dash
            elif part == tp.PART_ULIST_ABSENT:
                end, ok = js, zeros
            else:
                fl = ref_postproc.split_firstline(jb, None, js, je)
                name = {tp.PART_METHOD: "method", tp.PART_URI: "uri"}.get(part, "proto")
                start, end = fl[f"{name}_start"], fl[f"{name}_end"]
                ok = fl["ok"] & fl["has_protocol"] if name == "proto" else fl["ok"]
                if part in (tp.PART_PV_PROTOCOL, tp.PART_PV_VERSION):
                    pv = ref_postproc.split_protocol_version(jb, start, end)
                    if part == tp.PART_PV_PROTOCOL:
                        end = pv["proto_end"]
                    else:
                        start, end = pv["ver_start"], pv["ver_end"]
                    null = pv["null"]
            for o, v in zip(task[4:8], (start, end - start, ok, null)):
                want[o] = v
            words = ref_pipeline.span_prefix_words(jb, start, end, ok, null, None,
                                                   ref_postproc.gather_span_bytes)
            for k in range(3):
                want[task[11] + k] = words[k]
        elif kind == tp.TASK_SECMILLIS:
            (hi, lo, d18, nd), milli, is_null, ok = ref_postproc.parse_secmillis_spans(
                jb, js, je)
            for o, v in zip(task[4:12], (hi, lo, d18, nd, ok, is_null, zeros, milli)):
                want[o] = v
        else:
            (hi, lo, d18, nd), is_null, ok, big = ref_postproc.parse_long_spans(
                jb, js, je, clf=bool(clf))
            if part == tp.LONG_ZERO_NULL:
                ok, big = ok & ~big, zeros
                want[task[11]] = ((je - js) > 1) & (first == ord("0"))
            else:
                span = js | (jnp.minimum(je - js, 8191) << 13)
                hi, lo, d18 = (jnp.where(big, span, hi), jnp.where(big, 0, lo),
                               jnp.where(big, 0, d18))
            for o, v in zip(task[4:11], (hi, lo, d18, nd, ok, is_null, big)):
                want[o] = v
    return want


@pytest.mark.parametrize("L", [64, 384, 2048])
def test_seeded_spans_match_reference(L):
    """The span_stages kernel's seeded edge cases (tools.kernel_ab.
    seeded_span_case under seeded_stage_tables: request lines with no or
    one space, bad versions, past 128 bytes and past L, starts with bits
    above the gather mask, longs of 0 to 25 digits and leading zeros,
    secmillis spans of 4 to 23 bytes) through span_stages_plain equal the
    JAX package's functions, every row bit for bit."""
    from logparser_tpu_torch.tools.kernel_ab import seeded_span_case, seeded_stage_tables
    from logparser_tpu_torch.tpu import pipeline as tp

    buf, s, e = seeded_span_case(300, L, seed=L + 1)
    stages = seeded_stage_tables(tp)
    got = tp.span_stages_plain(stages, _t(buf), _t(s), _t(e),
                               torch.empty((stages.n_out, buf.shape[0]), dtype=torch.int32))
    want = _reference_span_rows(stages, buf, s, e)
    assert sorted(want) == list(range(stages.n_out))
    for r, v in want.items():
        _eq(got[r].numpy(), np.asarray(v).astype(np.int32), f"row {r}")
    protocol_ok = [t[6] for t in stages.tasks_py if t[:3] == (tp.TASK_SPAN, 0, tp.PART_PROTOCOL)]
    assert got[protocol_ok[0]].any() and not got[protocol_ok[0]].all()
