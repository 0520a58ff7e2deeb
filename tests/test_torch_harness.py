"""Shared harness for the PyTorch port's tests (logparser_tpu_torch).

The JAX package is the reference: the same inputs, made from a seed with
numpy and the in-repo generator, go through the JAX function (on the CPU)
and its counterpart in the port, and every comparison is exact (integer
outputs, tolerance 0).  Mismatches in the packed ``[K + 4V, B]`` output are
named by ``(field, component)`` through ``PackedLayout.slots``.

This module also holds a few tests of the harness itself.
"""
import numpy as np

import jax.numpy as jnp

from _shared_parsers import shared_parser
from logparser_tpu.analytics.spec import AggregateSpec as RefAggregateSpec
from logparser_tpu.tpu import pipeline as ref_pipeline
from logparser_tpu.tools.demolog import HEADLINE_FIELDS, generate_combined_lines
from logparser_tpu_torch.analytics import AggregateSpec
from logparser_tpu_torch.tpu.runtime import encode_batch

_EDGE_PREFIX = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 0'

# Crafted edge lines: escaped quotes (final op / non-final op), CLF '-'
# and >19-digit / >Long.MAX byte counts, a request line with no protocol,
# a lower-case month, unusual and invalid offsets and dates, UTF-8 bytes,
# an empty line, separators only, and bare garbage.
EDGE_LINES = [
    _EDGE_PREFIX + ' "x" "esc \\" quote"',
    _EDGE_PREFIX + ' "x" "tail\\"',
    _EDGE_PREFIX + ' "x" "even\\\\"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /p\\" HTTP/1.0" 200 0 "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 - "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 '
    '12345678901234567890 "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 '
    '1234567890123456789x1 "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 '
    '9223372036854775808 "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /x" 200 5 "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /x HTTP/1.1.1" 200 5 "x" "y"',
    '1.2.3.4 - - [01/jan/2024:00:00:00 -0930] "GET / HTTP/1.1" 200 5 "x" "y"',
    '1.2.3.4 - - [31/Dec/2024:23:59:60 +1400] "GET / HTTP/1.1" 200 5 "x" "y"',
    '1.2.3.4 - - [29/Feb/2023:00:00:00 +0000] "GET / HTTP/1.1" 200 5 "x" "y"',
    '1.2.3.4 - - [29/Feb/2024:00:00:00 +2500] "GET / HTTP/1.1" 200 5 "x" "y"',
    '1.2.3.4 - - [01/Foo/2024:00:00:00 +0000] "GET / HTTP/1.1" 200 5 "x" "y"',
    _EDGE_PREFIX + ' "x" "café ☃ UTF-8"',
    "",
    " ",
    '"',
    '] "',
    " ".join(['"'] * 10),
    '"\\" " \\" " "\\\\" "\\\\\\"',
    "GET / HTTP/1.1",
    "completely broken line",
    "a" * 100,
]


def corpus(seed: int, n: int = 96, garbage: float = 0.2, n_random: int = 24):
    """Generator lines + edge lines + numpy-seeded random byte lines (the
    shapes of tests/test_bitplane_split.py and test_fuzz_differential.py)."""
    rng = np.random.default_rng(seed)
    lines = list(generate_combined_lines(n, seed=seed, garbage_fraction=garbage))
    lines += EDGE_LINES
    lines.append("".join(rng.choice(list(' "[]abc0123'), size=50)))
    lines.append("".join(rng.choice(list(' "\\ab0'), size=60)))
    for _ in range(n_random):
        raw = rng.integers(0, 256, size=int(rng.integers(0, 140)), dtype=np.uint8)
        lines.append(bytes(raw).replace(b"\n", b" "))
    # Mutated real lines: one byte replaced by a separator-ish byte.
    base = generate_combined_lines(n_random, seed=seed + 1)
    for line in base:
        b = bytearray(line.encode())
        i = int(rng.integers(0, len(b)))
        b[i] = int(rng.choice(list(b' "[]-\\09:/')))
        lines.append(bytes(b))
    return lines


def assert_results_equal(ours, ref, fields=None):
    """The port's BatchResult equals the reference's on every row, the rows
    its host oracle visited included: needs_host == oracle_row_ids,
    valid, reject_reasons, rescue_reasons, the good / bad counts and
    every value of to_dict() (types included).  Returns the oracle rows."""
    assert ours.needs_host.tolist() == ref.oracle_row_ids.tolist()
    np.testing.assert_array_equal(ours.valid, ref.valid)
    assert ours.reject_reasons == ref.reject_reasons
    assert ours.rescue_reasons == ref.rescue_reasons
    assert (ours.good_lines, ours.bad_lines) == (ref.good_lines, ref.bad_lines)
    got, want = ours.to_dict(), ref.to_dict()
    assert list(got) == list(want)
    for fid in fields or want:
        for i, (a, b) in enumerate(zip(got[fid], want[fid])):
            assert a == b and type(a) is type(b), (fid, i, a, b)
    return set(ours.needs_host.tolist())


def assert_parse_matches_reference(fmt, fields, lines, ref_kwargs=None, **kwargs):
    """Parse ``lines`` with a fresh TorchBatchParser (CPU, ``kwargs``) and
    a TpuBatchParser of the same configuration (``ref_kwargs``, the
    reference's own extra dissectors; without them the shared parser of
    ``kwargs``): assert_results_equal, and to_arrow(strings="copy")
    equal.  Returns the port's result."""
    from logparser_tpu.tpu.batch import TpuBatchParser
    from logparser_tpu_torch import TorchBatchParser

    if ref_kwargs is None:
        ref = shared_parser(fmt, fields, **kwargs).parse_batch(lines)
    else:
        ref = TpuBatchParser(fmt, list(fields), **ref_kwargs).parse_batch(lines)
    ours = TorchBatchParser(fmt, fields, device="cpu", **kwargs).parse_batch(lines)
    assert_results_equal(ours, ref)
    assert ours.to_arrow(strings="copy").equals(
        ref.to_arrow(include_validity=True, strings="copy"))
    return ours


def reference_parser(fmt, fields):
    return shared_parser(fmt, list(fields))


def jax_program_plain(prog):
    """Plain data of one JAX DeviceProgram (the port's carry schema)."""
    return {
        "log_format": prog.log_format,
        "ops": tuple((op.kind, bytes(op.lit), op.token_index, op.charset,
                      op.min_len, op.max_len, op.narrow) for op in prog.ops),
        "tokens": tuple((t.index, t.charset, t.min_len, t.max_len, t.narrow,
                         tuple(tuple(o) for o in t.outputs))
                        for t in prog.tokens),
        "charset_table": np.asarray(prog.charset_table, dtype=bool),
        "charset_ids": dict(prog.charset_ids),
        "max_lit_len": prog.max_lit_len,
    }


def jax_unit_plain(unit):
    """Plain data of one JAX FormatUnit (the schema of the port's
    carry.unit_to_plain), read attribute by attribute."""
    plans = []
    for p in unit.plans:
        meta = None
        if p.kind == "ts":
            dl = p.meta
            loc = dl.locale
            meta = {
                "segments": tuple(
                    tuple((it.kind, it.offset, it.width, it.field, it.text,
                           tuple(it.table), tuple(it.zone_idx),
                           tuple(it.fold_flags)) for it in seg)
                    for seg in dl.segments
                ),
                "seg_widths": tuple(dl.seg_widths),
                "tail": dl.tail,
                "default_offset_seconds": dl.default_offset_seconds,
                "min_prefix": dl.min_prefix,
                "locale": {
                    "tag": loc.tag,
                    "months_short": tuple(loc.months_short),
                    "months_full": tuple(loc.months_full),
                    "days_short": tuple(loc.days_short),
                    "days_full": tuple(loc.days_full),
                    "ampm": tuple(loc.ampm),
                    "week_first_day": loc.week_first_day,
                    "week_min_days": loc.week_min_days,
                },
                "zone_table": dl.zone_table is not None,
            }
        elif p.kind in ("qscsr", "ulist"):
            meta = p.meta
        elif p.kind == "geo":
            tag, column, table = p.meta
            meta = (tag, column, np.asarray(table.starts, dtype=np.uint32),
                    np.asarray(table.ends, dtype=np.uint32))
        plans.append((p.field_id, p.kind, p.token_index, tuple(p.steps),
                      p.comp, meta, p.null_mode, p.scale, p.attr))
    return {
        "program": jax_program_plain(unit.program),
        "plans": tuple(plans),
        "layout": {
            "slots": {k: dict(v) for k, v in unit.layout.slots.items()},
            "n_rows": unit.layout.n_rows,
            "csr_slots": unit.layout.csr_slots,
        },
        "row_offset": unit.row_offset,
        "plausibility_only": bool(unit.plausibility_only),
    }


def assert_plain_equal(a, b, path="unit"):
    """Deep equality of plain data, numpy arrays compared exactly; the
    assertion names the first differing path."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_plain_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_plain_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


_REFERENCE_FNS = {}


def reference_packed(units, view_specs, buf, lengths) -> np.ndarray:
    """The reference executor's packed rows; one jitted executor per
    (units, layouts, view specs), so batches of one shape compile once."""
    key = (tuple((id(u), id(u.layout)) for u in units),
           tuple((f, tuple(i)) for f, i in view_specs or ()))
    entry = _REFERENCE_FNS.get(key)
    if entry is None:
        # The units ride along so their ids stay unique while cached.
        entry = _REFERENCE_FNS[key] = (
            ref_pipeline.build_units_jnp_fn(units, view_specs or None), list(units))
    return np.asarray(entry[0](jnp.asarray(buf), jnp.asarray(lengths)))


def packed_mismatch(ref, lines):
    """first_mismatch of the port's executor over ``ref``'s units (carried
    as plain data) against ``ref``'s own view-emitting executor (the one
    its parse_batch runs, so the two share a compile), on ``lines``."""
    import torch

    from logparser_tpu_torch.tpu.carry import units_from_reference
    from logparser_tpu_torch.tpu.pipeline import UnitsExecutor

    buf, lengths, _ = encode_batch(lines)
    specs = ref._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in ref.units])
    got = UnitsExecutor(units, specs)(torch.from_numpy(buf), torch.from_numpy(lengths))
    B = len(lines)
    pad = ref._bucket(B) - B    # parse_batch's padded batch shape
    want = ref.device_views_fn()(jnp.asarray(np.pad(buf, ((0, pad), (0, 0)))),
                                 jnp.asarray(np.pad(lengths, (0, pad))))
    return first_mismatch(ref.units, specs, got.numpy(), np.asarray(want)[:, :B])


def slot_names(units, view_specs):
    """{packed row: [(field, component), ...]} from the layouts' slots."""
    names = {}
    for u in units:
        names.setdefault(u.row_offset, []).append(("@row0", "valid|plausible|esc"))
        for key, comps in u.layout.slots.items():
            for comp, (row, _, _) in comps.items():
                names.setdefault(u.row_offset + row, []).append((key, comp))
    K = sum(u.layout.n_rows for u in units)
    for vi, (fid, _) in enumerate(view_specs or ()):
        for k, part in enumerate(("span_word", "prefix0", "prefix1", "prefix2")):
            names[K + 4 * vi + k] = [(fid, f"view.{part}")]
    return names


def first_mismatch(units, view_specs, got: np.ndarray, want: np.ndarray):
    """None when equal, else (row, line, (field, component) candidates,
    got, want) of the first differing word, the component narrowed to the
    slot whose bits differ."""
    if got.shape != want.shape:
        return ("shape", got.shape, want.shape)
    diff = np.argwhere(got != want)
    if diff.size == 0:
        return None
    r, b = (int(x) for x in diff[0])
    cands = slot_names(units, view_specs).get(r, [])
    x = int(got[r, b]) ^ int(want[r, b])
    narrowed = []
    for u in units:
        for key, comps in u.layout.slots.items():
            for comp, (row, shift, bits) in comps.items():
                if u.row_offset + row != r:
                    continue
                mask = 0xFFFFFFFF if bits == 0 else ((1 << bits) - 1) << shift
                if x & mask:
                    narrowed.append((key, comp))
    return (r, b, narrowed or cands, int(got[r, b]), int(want[r, b]))


def test_first_mismatch_names_the_slot():
    parser = reference_parser("combined", HEADLINE_FIELDS)
    units, specs = parser.units, parser._view_specs()
    K = sum(u.layout.n_rows for u in units) + 4 * len(specs)
    want = np.zeros((K, 3), dtype=np.int32)
    got = want.copy()
    row, shift, _ = units[0].layout.slots["STRING:request.status.last"]["len"]
    got[row, 1] = 1 << shift
    assert first_mismatch(units, specs, want, want) is None
    r, b, names, _, _ = first_mismatch(units, specs, got, want)
    assert (r, b) == (row, 1)
    assert names == [("STRING:request.status.last", "len")]


def test_corpus_is_seeded():
    a, b = corpus(3), corpus(3)
    assert a == b and corpus(4) != a
    assert any(isinstance(x, bytes) for x in a)


def test_jax_unit_plain_covers_the_headline_units():
    parser = reference_parser("combined", HEADLINE_FIELDS)
    plain = jax_unit_plain(parser.units[0])
    kinds = [p[1] for p in plain["plans"]]
    assert kinds.count("span") == 7 and "ts" in kinds and "long" in kinds
    assert plain["layout"]["n_rows"] == parser.units[0].layout.n_rows


def assert_aggregate_matches_reference(ref, ours, lines, spec):
    """The port's outcome equals the reference's over the whole batch, the
    rows its host oracle rescues folded in: state, good / bad counts,
    oracle_rows and reject_items; the folded rows are the reference
    kernel's, and needs_host is exactly the folded rows the reference's row
    path sends to its oracle (row results do not depend on the batch, so
    the full batch's oracle rows stand for those of the fold replay).  An
    AggregateSpec instance goes to both as an instance (no validate_for),
    an op list as a list."""
    out = ours.aggregate_batch(lines, spec)
    instance = isinstance(spec, AggregateSpec)
    ref_spec = RefAggregateSpec.parse(
        [op.as_dict() for op in spec.ops] if instance else spec)
    buf, lengths, overflow = encode_batch(lines)
    B = ref._bucket(len(lines))
    host_kill = np.zeros(B, dtype=bool)
    host_kill[overflow] = True
    fn = ref._agg_executor(ref_spec)
    cls = np.asarray(fn(jnp.asarray(np.pad(buf, ((0, B - len(lines)), (0, 0)))),
                        jnp.asarray(np.pad(lengths, (0, B - len(lines)))),
                        jnp.int32(len(lines)), jnp.asarray(host_kill))["cls"])[:len(lines)]
    oracle = ref.parse_batch(lines).oracle_row_ids
    oracle = set() if oracle is None else set(oracle.tolist())
    folded = np.nonzero(cls == 1)[0].tolist()
    assert out.needs_host.tolist() == [i for i in folded if i in oracle]
    want = ref.aggregate_batch(lines, ref_spec if instance else spec)
    assert out.state.summary() == want.state.summary()
    assert out.state.to_ipc_bytes() == want.state.to_ipc_bytes()
    assert (out.good_lines, out.bad_lines, out.oracle_rows) == \
        (want.good_lines, want.bad_lines, want.oracle_rows)
    assert out.reject_items == want.reject_items
    assert out.device_rows == want.device_rows == int((cls == 0).sum())
    assert out.fold_rows == len(folded)
    assert out.good_lines + out.bad_lines == len(lines)
    return out
