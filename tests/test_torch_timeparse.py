"""The port's timestamp parser equals the reference's, bit for bit.

``logparser_tpu_torch.tpu.timeparse.parse_device_timestamp`` (plain
PyTorch, on the CPU) against ``logparser_tpu.tpu.timeparse`` on the same
``[B, L]`` buffers and spans: every component (``year month day hour
minute second milli offset_seconds``) and ``ok``, rejected rows included,
tolerance 0.  The layouts are the reference's device layouts
(``tests/test_timeparse.py``), the %Z layout and a full-month-name
layout; port layouts are built from the reference layout's item tuples.
Inputs: 60 renders, hostile mutations, the reference's zone samples, and
numpy-seeded random spans at several line buckets and span starts.
"""
import random
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.dissectors.strftime_stamp import compile_strftime as ref_compile_strftime
from logparser_tpu.dissectors.timelayout import compile_java_pattern
from logparser_tpu.tpu import timeparse as ref_timeparse
from logparser_tpu.tpu.postproc import gather_span_bytes as ref_gather
from logparser_tpu_torch.dissectors.timelayout import TimeLayout
from logparser_tpu_torch.tpu import pipeline, timeparse
from logparser_tpu_torch.tpu.carry import time_layout_to_plain
from test_torch_harness import assert_plain_equal
from test_timeparse import DEVICE_LAYOUTS, sample_strings

ZONE_LAYOUT = ("strf", "%d/%b/%Y:%H:%M:%S %Z")
LAYOUTS = DEVICE_LAYOUTS + [
    ZONE_LAYOUT,
    ("strf", "%d/%b/%Y %H:%M:%S %Z"),
    ("strf", "%d/%B/%Y:%H:%M:%S %z"),          # variable-width month names
    ("java", "dd/MMMM/yyyy:HH:mm:ss.SSS ZZ"),  # full names, millis
    ("strf", "%y%m%d %I:%M %p msec_frac"),     # two-digit year, am/pm, millis
    ("strf", "%a %d %B %Y %H:%M"),             # day names, default zone
    ("java", "hh:mm a dd/MM/yyyy XXX"),
]

# The reference's zone samples (tests/test_timeparse.py) plus DST edges,
# case variants, greedy tokens and window misses.
ZONE_SAMPLES = [
    "07/Mar/2026 10:00:00 UTC", "07/Mar/2026 10:00:00 GMT",
    "07/Mar/2026 10:00:00 utc", "07/Mar/2026 10:00:00 Z", "07/Mar/2026 10:00:00 UT",
    "07/Mar/2026 10:00:00 CET", "07/Mar/2026 10:00:00 Europe/Amsterdam",
    "07/Jul/2026 10:00:00 CET", "07/Mar/2026 10:00:00 UTCX",
    "07/Mar/2026 10:00:00 UTC2", "07/Mar/2026 10:00:00 europe/amsterdam",
]
ZONES = ["UTC", "utc", "Z", "z", "CET", "cest", "CEST", "EST", "edt", "PST",
         "Europe/Paris", "Europe/paris", "America/New_York", "Asia/Tokyo",
         "Asia/Kolkata", "Australia/Sydney", "America/Argentina/Buenos_Aires",
         "UTCX", "UTC-", "UTC/", "UTC_", "CET+", "Mars/Olympus", "", "Etc/UTC",
         "GMT", "MEST", "Pacific/Auckland", "Africa/Nairobi", "+0100"]


def ref_layout(kind, pattern):
    return ref_compile_strftime(pattern) if kind == "strf" else compile_java_pattern(pattern)


def port_layout(ref):
    """The port's TimeLayout from the reference layout's plain items."""
    return TimeLayout([tuple(it) for it in ref.items], ref.default_zone)


def zone_renders(rng, n=120):
    """Renders of %d/%b/%Y:%H:%M:%S %Z (and the ' ' variant) over the
    vocabulary, DST edges and years around the tables' window."""
    out = []
    for _ in range(n):
        year = rng.choice([1969, 1970, 1971, 2024, 2037, 2038, 2040, 2096, 2097,
                           rng.randint(1970, 2100)])
        month, day = rng.randint(1, 12), rng.randint(1, 31)
        hh = rng.choice([0, 1, 2, 3, 23, 24, 25, rng.randint(0, 23)])
        sep = rng.choice([":", " "])
        out.append(f"{day:02d}/{['Jan', 'Mar', 'Jun', 'Oct', 'Dec', 'Feb'][month % 6]}"
                   f"/{year}{sep}{hh:02d}:{rng.randint(0, 59):02d}:{rng.randint(0, 60):02d}"
                   f" {rng.choice(ZONES)}")
    out += ["31/Mar/2024:02:30:00 CET", "27/Oct/2024:02:30:00 CET",
            "27/Oct/2024:01:59:00 CET", "27/Oct/2024:03:00:00 CET",
            "31/Mar/2024:01:59:00 Europe/Paris", "31/Mar/2024:03:00:00 Europe/Paris",
            "01/Jan/2024:10:00:00 CEST", "31/Dec/1969:23:59:00 UTC",
            "01/Jan/1970:00:00:00 UTC", "01/Jul/2040:10:00:00 CET",
            "01/Jul/2040:10:00:00 UTC", "01/Jul/2096:10:00:00 Asia/Kolkata",
            "31/Dec/2096:23:59:00 UTC", "01/Jan/2024:24:00:00 UTC",
            "01/Jan/2024:25:00:00 UTC", "29/Feb/2023:10:00:00 UTC",
            "29/Feb/2024:10:00:00 UTC"]
    return out


def samples_for(kind, pattern, layout):
    rng = random.Random(zlib.crc32(pattern.encode()))
    if "%Z" in pattern:
        base = zone_renders(rng) + ZONE_SAMPLES
        hostile = []
        for s in base[:40]:
            m = list(s)
            m[rng.randrange(len(m))] = rng.choice("0123456789abcXYZ/:+- ._")
            hostile.append("".join(m))
        return base + hostile + ["", "garbage", base[0][:-1], base[0] + "0"]
    got = sample_strings(layout, rng)
    assert got, pattern
    return got


def make_buffers(samples, L, seed):
    """[B, L] rows holding each sample at a seeded start, random bytes
    around it; spans (start, end) plus a few empty, reversed and
    out-of-row spans."""
    rng = np.random.default_rng(seed)
    B = len(samples) + 6
    buf = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    start = np.zeros(B, dtype=np.int32)
    end = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(samples):
        raw = s.encode()[:L]
        st = int(rng.integers(0, L - len(raw) + 1))
        buf[i, st:st + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        if st + len(raw) < L and rng.random() < 0.5:
            buf[i, st + len(raw)] = 0
        start[i], end[i] = st, st + len(raw)
    extra = [(0, 0), (5, 3), (L, L), (L - 1, L), (0, L), (L // 2, L)]
    for k, (s, e) in enumerate(extra):
        start[len(samples) + k], end[len(samples) + k] = s, e
    return buf, start, end


def run_both(ref_dl, dl, buf, start, end):
    comp, ok = timeparse.parse_device_timestamp(
        torch.from_numpy(buf), torch.from_numpy(start), torch.from_numpy(end), dl)
    ref_comp, ref_ok = ref_timeparse.parse_device_timestamp(
        jnp.asarray(buf), jnp.asarray(start), jnp.asarray(end), ref_dl, ref_gather)
    return comp, ok, {k: np.asarray(v) for k, v in ref_comp.items()}, np.asarray(ref_ok)


def assert_same(comp, ok, ref_comp, ref_ok, what):
    assert set(comp) == set(ref_comp), what
    bad = np.nonzero(ok.numpy() != ref_ok)[0]
    assert bad.size == 0, (what, "ok", bad[:5])
    for k, want in ref_comp.items():
        got = comp[k].numpy()
        assert got.dtype == np.int32, (what, k, got.dtype)
        bad = np.nonzero(got != want)[0]
        assert bad.size == 0, (what, k, bad[:5], got[bad[:5]], want[bad[:5]])


@pytest.mark.parametrize("kind,pattern", LAYOUTS)
def test_compiled_layout_matches_reference(kind, pattern):
    ref = ref_layout(kind, pattern)
    ref_dl = ref_timeparse.compile_layout_for_device(ref)
    dl = timeparse.compile_layout_for_device(port_layout(ref))
    assert ref_dl is not None and dl is not None, pattern
    assert_plain_equal(time_layout_to_plain(dl), time_layout_to_plain(ref_dl))


@pytest.mark.parametrize("kind,pattern", LAYOUTS)
def test_parse_matches_reference(kind, pattern):
    ref = ref_layout(kind, pattern)
    ref_dl = ref_timeparse.compile_layout_for_device(ref)
    dl = timeparse.compile_layout_for_device(port_layout(ref))
    samples = samples_for(kind, pattern, ref)
    widest = max(dl.windows()) + timeparse.TAIL_WIDTH
    buckets = sorted({max(len(s.encode()) for s in samples) + 2, 64, 128})
    checked_ok = 0
    for L in buckets:
        if L < widest:
            continue
        buf, start, end = make_buffers(samples, L, seed=L)
        comp, ok, ref_comp, ref_ok = run_both(ref_dl, dl, buf, start, end)
        assert_same(comp, ok, ref_comp, ref_ok, (pattern, L))
        checked_ok += int(ok.sum())
    # Both verdicts occur: the comparison covers accepted and rejected rows.
    assert checked_ok > 20


def test_zone_layout_accepts_the_vocabulary():
    """%Z zone text: abbreviations case-folded, region ids exact, greedy
    tokens and unknown zones rejected; the CEST abbreviation resolves
    through CET's table (+1 h in winter), the DST gap and overlap minutes
    take the pre-transition offset, DST zones are device-valid only up to
    their last explicit transition."""
    ref = ref_layout(*ZONE_LAYOUT)
    dl = timeparse.compile_layout_for_device(port_layout(ref))
    cases = {
        "01/Jan/2024:10:00:00 CEST": (True, 3600),
        "31/Mar/2024:02:30:00 CET": (True, 3600),
        "27/Oct/2024:02:30:00 CET": (True, 7200),
        "01/Jul/2024:10:00:00 europe/paris": (False, None),
        "01/Jul/2024:10:00:00 Europe/Paris": (True, 7200),
        "01/Jul/2024:10:00:00 UTCX": (False, None),
        "01/Jan/2024:24:00:00 UTC": (True, 0),
        "01/Jan/2024:25:00:00 UTC": (False, None),
        "31/Dec/1969:23:00:00 UTC": (False, None),
        "01/Jul/2040:10:00:00 CET": (False, None),
        "01/Jul/2040:10:00:00 UTC": (True, 0),
        "01/Jul/2096:10:00:00 Asia/Kolkata": (True, 19800),
    }
    samples = list(cases)
    buf = np.zeros((len(samples), 64), dtype=np.uint8)
    for i, s in enumerate(samples):   # as in a line: the zone, then ']'
        raw = (s + "]").encode()
        buf[i, :len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    end = torch.tensor([len(s) for s in samples], dtype=torch.int32)
    comp, ok = timeparse.parse_device_timestamp(
        torch.from_numpy(buf), torch.zeros_like(end), end, dl)
    for i, s in enumerate(samples):
        want_ok, want_off = cases[s]
        assert bool(ok[i]) == want_ok, s
        if want_ok:
            assert int(comp["offset_seconds"][i]) == want_off, s
    assert int(comp["hour"][samples.index("01/Jan/2024:24:00:00 UTC")]) == 0


def test_fields_stage_and_zone_lookup_compose():
    """The two kernels' plain versions (timestamp up to the wall minute,
    then zone_lookup with the verdict as its gate) give the whole
    parse_device_timestamp, row for row."""
    ref = ref_layout(*ZONE_LAYOUT)
    dl = timeparse.compile_layout_for_device(port_layout(ref))
    samples = samples_for(*ZONE_LAYOUT, ref)
    buf, start, end = make_buffers(samples, 64, seed=2)
    b = torch.from_numpy(buf)
    s, e = torch.from_numpy(start)[None, :], torch.from_numpy(end)[None, :]
    tables = pipeline.TsTables(0, dl)
    rows = torch.empty((4, len(samples) + 6), dtype=torch.int32)
    zone = torch.empty(rows.shape[1], dtype=torch.int32)
    pipeline.timestamp_plain(tables, b, s, e, rows, zone)
    pipeline.zone_lookup_plain(tables.zone, zone, rows[2], rows[3], rows[2:4])
    comp, ok = timeparse.parse_device_timestamp(b, s[0], e[0], dl)
    assert torch.equal(rows[2], comp["offset_seconds"])
    assert torch.equal(rows[3], ok.to(torch.int32))
    assert torch.equal(rows[0] & 0x3FFF, comp["year"] & 0x3FFF)


def test_narrow_bucket_raises():
    ref = ref_layout(*ZONE_LAYOUT)
    dl = timeparse.compile_layout_for_device(port_layout(ref))
    buf = torch.zeros((2, 16), dtype=torch.uint8)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="narrower"):
        timeparse.parse_device_timestamp(buf, z, z, dl)


@pytest.mark.parametrize("items,zone", [
    ([("num", "day", 1, 2, True), ("lit", "/"), ("num", "year", 4, 4, False),
      ("lit", "/"), ("num", "month", 2, 2, False)], None),            # space-padded
    ([("num", "wby", 4, 4, False), ("lit", "-W"), ("num", "isoweek", 2, 2, False)], None),
    ([("num", "year", 4, 4, False), ("num", "month", 2, 2, False),
      ("num", "day", 2, 2, False)], "Europe/Paris"),                   # DST default zone
    ([("num", "hour", 2, 2, False), ("lit", ":"), ("num", "minute", 2, 2, False),
      ("lit", " "), ("offset",)], None),                              # no date
    ([("num", "year", 4, 4, False), ("offset",), ("num", "month", 2, 2, False),
      ("num", "day", 2, 2, False)], None),                            # offset not last
])
def test_host_only_layouts_stay_host_only(items, zone):
    from logparser_tpu.dissectors.timelayout import TimeLayout as RefTimeLayout

    assert ref_timeparse.compile_layout_for_device(RefTimeLayout(items, zone)) is None
    assert timeparse.compile_layout_for_device(TimeLayout(items, zone)) is None


# kernel_ab's seeded timestamp case (the inputs timestamp_seeded feeds the
# card): every layout at a power-of-two bucket (spans near its end cross
# the gather mask's span) and at L = 384.
from logparser_tpu.dissectors.timelayout import TimeLayout as RefTimeLayout  # noqa: E402
from logparser_tpu_torch.tools.kernel_ab import (  # noqa: E402
    TS_SEEDED_LAYOUTS,
    seeded_timestamp_case,
    ts_render,
)


@pytest.mark.parametrize("L", [256, 384])
@pytest.mark.parametrize("name", [n for n, _ in TS_SEEDED_LAYOUTS])
def test_seeded_timestamp_case_matches_reference(name, L):
    """The seeded spans through the reference's parse_device_timestamp and
    the port's, bit for bit, and through timestamp_plain (the bundle the
    kernel is held to): its rows are the components packed, and for the
    %Z layout the wall minute and the zone index."""
    (case,) = [c for c in seeded_timestamp_case(600, L, seed=14) if c[0] == name]
    _, layout, buf, start, end = case
    dl = timeparse.compile_layout_for_device(layout)
    ref_dl = ref_timeparse.compile_layout_for_device(
        RefTimeLayout([tuple(it) for it in layout.items], layout.default_zone))
    assert dl is not None and ref_dl is not None
    comp, ok, ref_comp, ref_ok = run_both(ref_dl, dl, buf, start, end)
    assert_same(comp, ok, ref_comp, ref_ok, (name, L))
    assert 0 < int(ok.sum()) < len(ok)            # both verdicts occur
    tables = pipeline.TsTables(0, dl)
    rows = torch.empty((4, len(start)), dtype=torch.int32)
    zone = torch.empty(len(start), dtype=torch.int32) if tables.zone is not None else None
    fields, fok = timeparse.parse_timestamp_fields(
        torch.from_numpy(buf), torch.from_numpy(start), torch.from_numpy(end), dl)
    pipeline.timestamp_plain(tables, torch.from_numpy(buf), torch.from_numpy(start)[None],
                             torch.from_numpy(end)[None], rows, zone)
    c1 = (fields["year"] | fields["month"] << 14 | fields["day"] << 18 | fields["hour"] << 23)
    assert torch.equal(rows[0], c1.to(torch.int32))
    assert torch.equal(rows[3], fok.to(torch.int32))
    if zone is not None:
        assert torch.equal(zone, fields["zone_idx"])
        assert torch.equal(rows[2], fields["minutes"])


def test_seeded_timestamp_renders_cover_the_zone_vocabulary():
    """Every %Z entry of the vocabulary is rendered (entry i in turn), and
    the render mixes valid timestamps with broken ones."""
    from logparser_tpu_torch.dissectors.tztable import default_zone_table

    vocab = [e[0].decode() for e in timeparse.zone_vocabulary(default_zone_table())]
    (case,) = [c for c in seeded_timestamp_case(len(vocab) * 4, 256, seed=14)
               if c[0] == "zonetext"]
    layout = case[1]
    rng = np.random.default_rng(0)
    renders = [ts_render(rng, layout, vocab, i) for i in range(len(vocab) * 4)]
    for e in vocab:
        assert any(r.endswith(" " + e) for r in renders), e


@pytest.mark.parametrize("name", [n for n, _ in TS_SEEDED_LAYOUTS])
def test_register_path_takes_only_the_offset_layouts(name):
    """TsTables.fixed picks the timestamp kernel's register path for
    Apache's %t (its hour) and strftime's %d/%b/%Y:%H:%M:%S %z (its clock
    hour) alone; every other layout, %Z's included, is interpreted from
    the image."""
    (case,) = [c for c in seeded_timestamp_case(8, 256, seed=14) if c[0] == name]
    tables = pipeline.TsTables(0, timeparse.compile_layout_for_device(case[1]))
    assert tables.fixed == {"apache": 1, "strftime_z": 2}.get(name, 0)
    assert tables.fixed == 0 or tables.window == 27


def _zone_records(index):
    """The %Z table of a TsTables image, read as csrc/timestamp.cu reads
    it: (bucket count, bucket starts, records (length, fold, entry number,
    zone index, want words, mask words))."""
    n_segs, n_items = index[0], index[1]
    items = [index[2 + 3 * n_segs + 5 * i:][:5] for i in range(n_items)]
    (arg,) = [it[3] for it in items if it[0] == pipeline.ITEM_ZONE]
    tab = index[arg:]
    rw, nb = tab[0], tab[2]
    nw = (rw - 2) // 2
    starts = tab[3:4 + nb]
    recs = []
    for n in range(starts[-1]):
        r = tab[4 + nb + n * rw:][:rw]
        recs.append((r[0] & 0xFF, (r[0] >> 8) & 1, r[0] >> 16, r[1],
                     r[2:2 + nw], r[2 + nw:2 + 2 * nw]))
    return nb, starts, recs


@pytest.mark.parametrize("kind,pattern", [ZONE_LAYOUT, ("strf", "%d/%b/%Y %H:%M:%S %Z")])
def test_zone_image_finds_the_first_entry_in_table_order(kind, pattern):
    """Every %Z entry, lowered, uppered and as written, looked up as the
    kernel looks it up in TsTables.index -- its token's folded hash picks a
    bucket, whose records keep table order, and the first record of the
    token's length whose words match wins -- finds the first entry in
    table order that the reference's rule accepts (the same length, equal
    bytes, letters case-folded where the entry folds), and its zone."""
    dl = timeparse.compile_layout_for_device(port_layout(ref_layout(kind, pattern)))
    (zit,) = [it for seg in dl.segments for it in seg if it.kind == "zone"]
    index = pipeline.TsTables(0, dl).index.tolist()
    nb, starts, recs = _zone_records(index)
    assert [r[2] for r in recs] == sorted(
        range(len(zit.table)), key=lambda n: (pipeline._token_hash(zit.table[n]) & (nb - 1), n))

    def words(tok, nw):
        padded = tok + bytes(4 * nw - len(tok))
        return [int.from_bytes(padded[4 * k:4 * k + 4], "little") for k in range(nw)]

    def kernel(tok):
        bk = pipeline._token_hash(tok) & (nb - 1)
        for ln, _, n, zi, want, mask in recs[starts[bk]:starts[bk + 1]]:
            if ln != len(tok):
                continue
            cut = [(1 << 8 * min(4, ln - 4 * k)) - 1 for k in range((ln + 3) // 4)]
            if all(((w | (m & 0xFFFFFFFF)) & c) == (v & 0xFFFFFFFF)
                   for w, m, c, v in zip(words(tok, len(want)), mask, cut, want)):
                return n, zi
        return None

    def rule(tok):
        for n, e in enumerate(zit.table):
            same = e.lower() == tok.lower() if zit.fold_flags[n] else e == tok
            if len(e) == len(tok) and same:
                return n, zit.zone_idx[n]
        return None

    tokens = {t for e in zit.table for t in (e, e.lower(), e.upper(), e + b"x", e[:-1])}
    assert len(tokens) > 3 * len(zit.table)
    hits = 0
    for tok in sorted(t for t in tokens if t):
        assert kernel(tok) == rule(tok), tok
        hits += rule(tok) is not None
    assert hits >= len(zit.table)
