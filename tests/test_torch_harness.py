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
from logparser_tpu.tpu import pipeline as ref_pipeline
from logparser_tpu.tools.demolog import HEADLINE_FIELDS, generate_combined_lines

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


def reference_packed(units, view_specs, buf, lengths) -> np.ndarray:
    fn = ref_pipeline.build_units_jnp_fn(units, view_specs or None)
    return np.asarray(fn(jnp.asarray(buf), jnp.asarray(lengths)))


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
