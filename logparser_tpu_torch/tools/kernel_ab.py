"""A parent commit's kernels beside this checkout's, on one card, in one
process.

    mkdir -p DIR && for f in $(git ls-tree --name-only PARENT logparser_tpu_torch/csrc/); do
        git show PARENT:$f > DIR/$(basename $f); done
    python3 -m logparser_tpu_torch.tools.kernel_ab DIR [KERNEL ...]   # from the checkout's root

DIR holds the parent's ``csrc`` sources (the ``.cu`` files and the headers
they include; ``.kernel_ab_parent/`` is git-ignored for it).  KERNEL picks
the kernels to compare -- ``zone_lookup``, ``geo_lookup``, ``split``,
``agg_reduce``, ``csr_split``, ``sp_program`` -- all six by default.

The parent's kernels are built with nvcc into a temporary directory.  Each
runs through this checkout's wrapper (``kernels.split`` and so on) with the
parent's library swapped in, its C parameters matched to the wrapper's
arguments by name: a parameter the parent lacks (split's ``n_lits``) is
dropped, one only the parent has is an error.  So parent and change pay
the same host enqueue.  The cases:

- ``zone_lookup`` (every transition key +-1 minute, the window and clip
  edges, 65,536 random pairs), ``zone_lookup_gated`` (the zonetext batch's
  timestamp rows), ``geo_lookup`` (the geoip_chain path: City and ASN),
  ``geo_lookup_synthetic`` (the 131,072-network synthetic City table),
  ``geo_lookup_large`` (4,194,304 seeded ranges), beside
  ``torch.searchsorted``;
- ``split_headline`` (L = 384), ``split_uri`` (the URI chain's batch),
  ``split_cookies`` (L = 2048), ``split_nul`` (L = 64) and
  ``split_headline_8191`` (the headline lines in the widest bucket);
- ``agg_reduce_dashboard`` (B = 65,547) and ``agg_reduce_seeded_<B>``:
  seeded lanes (:func:`seeded_reduce_case`, 2 sums and 2 histograms) at
  B = 4,095, 4,096, 4,097, 65,547 and 262,144, beside the reshaped sum
  of the tiles' halves (chip_smoke.agg_reduce_library);
- ``csr_split_uri_<slots>`` (the URI chain's two query groups on its
  batch, the block as it stands before the CSR stage, at 16 and 128
  slots) and ``csr_split_cookie`` (the cookie group on the cookies batch,
  L = 2,048, 128 slots);
- ``sp_program_headline`` (the padded headline batch on 2 x 4, every
  shard on the card) and ``sp_program_long`` (8,192 long lines at
  L = 32,768 on 1 x 4): here the "parent" is the per-op path in this
  checkout -- the sp_split launches of a batch against sp_program's --
  and ``..._runner`` the same pair as whole runners (PyTorch combines,
  copies and host enqueue included).  No parent library is built for
  them.

Each case holds parent and change to the plain version bit for bit, then
times them with chip_smoke.DeviceClock in turns (parent, change, change,
parent; the library call after) and prints one JSON line: each turn's
device ms and host enqueue ms, the bound (chip_smoke's cost functions)
and the card.  Then the card's name and power limit, and a last line
``{"ok": true, ...}``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analytics import device as agg_device

REPS = 25
CASE_KERNELS = ("zone_lookup", "geo_lookup", "split", "agg_reduce", "csr_split",
                "sp_program")
NO_PARENT_LIBRARY = ("sp_program",)   # its "parent" is the per-op path
SEEDED_B = (4095, 4096, 4097, 65547, 262144)


class Case(NamedTuple):
    name: str
    kernel: str
    run: Callable
    plain: Callable
    library: Optional[Callable]
    bytes_moved: int
    ops: int
    parent: Optional[Callable] = None        # else: the parent's library
    parent_plain: Optional[Callable] = None  # what the parent is held to, else plain


# ---------------------------------------------------------------------------
# seeded inputs of the reductions (also the tests')
# ---------------------------------------------------------------------------


class ReduceTables(torch.nn.Module):
    """The reduction half of ``analytics.device.AggTables`` over seeded
    lanes: ``sums`` (the first row of each limbs lane summed) and
    ``hists`` ((first lane row, integer edges) each), encoded as
    AggTables encodes them (an edge <= 0 always holds)."""

    def __init__(self, n_lane_rows: int, sums: Sequence[int],
                 hists: Sequence[Tuple[int, Sequence[int]]]):
        super().__init__()
        self.n_lane_rows = n_lane_rows
        self.sums_py = list(sums)
        self.hists_py: List[Tuple[int, int, int, int]] = []
        self.edges_py: List[Tuple[int, int, int, int]] = []
        n_bins = 0
        for row, edges in hists:
            self.hists_py.append((row, len(self.edges_py), len(edges), n_bins))
            n_bins += len(edges) + 1
            self.edges_py += agg_device.edge_rows(edges)
        self.n_bins = n_bins
        self.register_buffer("sums", torch.tensor(self.sums_py or [0], dtype=torch.int32))
        self.register_buffer("hists", torch.tensor(self.hists_py or [[0] * 4],
                                                   dtype=torch.int32))
        self.register_buffer("edges", torch.tensor(self.edges_py or [[0] * 4],
                                                   dtype=torch.int32))


# Two limbs lanes (rows 0-2 and 3-5) and a row no reduction reads.
SEEDED_SUMS = (0, 3)
SEEDED_HISTS = ((0, (0, 1000, 10 ** 6, 10 ** 7)),
                (3, (1, 0xFFFF, 0x10000, 999999, 10 ** 6, 10 ** 12, 10 ** 12 + 65536,
                     10 ** 18)))
_LIMB_EDGES = np.array([0, 1, 0xFFFF, 0x10000, 999999], dtype=np.int64)


def seeded_reduce_case(B: int, seed: int, selected: str = "some"):
    """(ReduceTables, cls [B] uint8, lanes [7, B] int32) on the CPU.
    Limbs are uniform or one of 0, 1, 0xFFFF, 0x10000, 999,999 (the high
    limb up to 9,223,372); ``selected`` "some" (a fifth of the rows
    unselected: limb 0 -1, the others left random), "none" or "all"."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 10 ** 6, size=(7, B), dtype=np.int64)
    special = rng.random((7, B)) < 0.5
    lanes = np.where(special, _LIMB_EDGES[rng.integers(0, 5, size=(7, B))], lanes)
    for r in (0, 3):
        big = rng.random(B) < 0.1
        lanes[r] = np.where(big, rng.integers(0, 9223373, size=B), lanes[r])
    lanes = lanes.astype(np.int32)
    if selected != "all":
        for r in (0, 3):
            off = np.ones(B, bool) if selected == "none" else rng.random(B) < 0.2
            lanes[r][off] = -1
    cls = rng.integers(0, 4, size=B, dtype=np.uint8)
    tables = ReduceTables(7, SEEDED_SUMS, SEEDED_HISTS)
    return tables, torch.from_numpy(cls), torch.from_numpy(np.ascontiguousarray(lanes))


SPLIT_WIDTHS = (1, 31, 32, 33, 384, 1025, 2048, 8191)
_SPLIT_ALPHABET = np.frombuffer(b' "[]\\-0123456789/:+abcGETHTP.=', dtype=np.uint8)
_NUL_ALPHABET = np.frombuffer(b"\x00\x00\x00ab1. -\\\"", dtype=np.uint8)
_HEAD = b'1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 0 "'


def seeded_split_case(B: int, L: int, seed: int, nul: bool = False):
    """(buf [B, L] uint8, lengths [B] int32) on the CPU for the split
    kernel: a third combined-shaped lines whose referer or user-agent
    holds a run of 1-70 backslashes ending just before a quote near a word
    (32-byte) or 32-word (1,024-byte) boundary, a third random bytes of a
    separator-heavy alphabet (NULs in it with ``nul``) with the same runs,
    a third random bytes alone; lengths 0, L and anywhere between (a
    crafted line's own, cut at L), garbage past each length."""
    rng = np.random.default_rng(seed)
    alphabet = _NUL_ALPHABET if nul else _SPLIT_ALPHABET
    buf = rng.choice(alphabet, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    marks = [q for q in (31, 32, 33, 95, 96, 127, 128, 255, 256, 1023, 1024, 1025,
                          2047, 2048, 4096)
             if q < L] + [L - 1]
    for row in range(B):
        kind = row % 3
        q = min(max(int(rng.choice(marks)) + int(rng.integers(-2, 3)), 0), L - 1)
        run = int(rng.integers(1, 71))
        if kind == 0:       # a crafted line
            ua = rng.random() < 0.5
            head = _HEAD + (b'x" "' if ua else b"")
            fill = max(q - run - len(head), 0)
            field = b"u" * fill + b"\\" * run + b'"' + b"v" * int(rng.integers(0, 5))
            line = head + field + (b'"' if ua else b'" "y"')
            n = min(len(line), L)
            buf[row, :n] = np.frombuffer(line[:n], dtype=np.uint8)
            lengths[row] = n
        elif kind == 1:     # random bytes with a run before a quote
            buf[row, max(q - run, 0):q] = ord("\\")
            buf[row, q] = ord('"')
    lengths[0] = 0
    lengths[min(2, B - 1)] = L
    return buf, lengths


CSR_SEPARATORS = {"cookie": b"; ", "query": b"&"}
CSR_TILE = 32         # csr_split.cu's tile: 32 consecutive lines
CSR_SHORT_SPAN = 64   # a tile whose raw spans are all this short is split a thread a line
_CSR_ALPHABET = np.frombuffer(b"ab09xZ=%+-?;; &&\x80\xc3\xa9\xff .", dtype=np.uint8)


def _csr_crafted(W: int, slots: int, sep: bytes) -> List[bytes]:
    """The crafted span texts of :func:`seeded_csr_case`."""
    seg = b"k=v" + sep
    S = CSR_SHORT_SPAN
    return [
        b"a" * (W - 1) + sep + b"b=c",                      # the separator split at W
        b"a" * (W - 2) + sep + b"b=c",                      # ... and just inside
        b";", b";;;;", b"a=1;;b=2; ;c=3", b"&&&", b"a=1&&b=2",
        b"=first" + sep + b"last=" + sep + b"=", b"a==b" + sep + b"=" + sep + b"c=",
        sep + sep + b"x=1" + sep,                            # empty segments
        b"%41=v+w" + sep + b"n\xc3\xa9=%zz" + sep + b"+=%" + sep + b"\xff\x80=\xff",
        (seg * (W // len(seg) + 1))[:W],                    # exactly W bytes
        (seg * (W // len(seg) + 1))[:W + 1],                # one byte more
        b"-", b"?", b"?a=1" + sep + b"b=2", b"??=?",
        seg * (slots + 3),                                   # more segments than slots
        sep * (slots + 1),                                   # ... short ones where they fit
        b"", b"a=1" + sep * 3,
        b"a" * (S - len(sep)) + sep,                         # a separator ending at byte S
        b"a" * (S - 1) + b";",                               # a ';' at byte S - 1, ' ' after
        b"x=" + b"\xc3\xa9%+" * ((S - 2) // 4) + b"=y"[:S - 2 - 4 * ((S - 2) // 4)],
        (seg * (S // len(seg) + 1))[:S],                    # exactly S bytes
        (seg * (S // len(seg) + 1))[:S + 1],                # one byte more
    ]


def seeded_csr_case(B: int, L: int, slots: int, mode: str, seed: int):
    """(buf [B, L] uint8, start [B] int32, end [B] int32) on the CPU: spans
    for ``split_csr`` with ``mode``'s separator (``"cookie"``: "; ",
    ``"query"``: "&") and the window W = 8 * slots.  The crafted spans,
    each at the row's start, its end and byte 5: a "; " (or "&") split by
    the window's end, a lone ';', ';;' runs, '=' first and last in a
    segment, empty segments, '%', '+' and high bytes in names and values,
    a span of exactly W bytes and one of W + 1, a lone '-', a leading '?',
    more segments than slots, an empty span, a separator ending at byte 64,
    a ';' at byte 63 (a ' ' follows every span that ends in ';', outside
    it), spans of exactly 64 bytes and 65; and the odd spans: one that ends
    before it starts, one that runs past L (the window's clamp), (L, L) and
    (0, L).  Laid out in the kernel's tiles of 32 rows: first the crafted
    spans of at most 64 bytes, in tiles of their own (csr_split's
    thread-a-line path), then the longer ones, each group's last tile
    filled up with random spans; then random tiles.  A random span starts
    anywhere and is 0 to 64 bytes long in the short tiles and every other
    random tile, else 0 to 2W, cut at L; its bytes are the separator-heavy
    alphabet."""
    rng = np.random.default_rng(seed)
    sep = CSR_SEPARATORS[mode]
    W = 8 * slots
    buf = rng.choice(_CSR_ALPHABET, size=(B, L)).astype(np.uint8)
    start = rng.integers(0, L, size=B).astype(np.int32)
    width = rng.integers(0, 2 * W + 1, size=B)
    capped = np.zeros(B, dtype=bool)
    placed = []   # (row bytes at, text) or (None, (s, e)): an odd span
    for text in _csr_crafted(W, slots, sep):
        for at in dict.fromkeys((0, max(L - len(text), 0), min(5, L - 1))):
            placed.append((at, text[:L - at]))
    placed += [(None, (min(s, L), e)) for s, e in ((4, 2), (L - 3, L + 40), (L, L), (0, L))]

    def span_len(item):
        at, x = item
        return len(x) if at is not None else x[1] - x[0]

    rows = []
    for short in (True, False):
        group = [item for item in placed if (span_len(item) <= CSR_SHORT_SPAN) == short]
        pad = -len(group) % CSR_TILE
        rows += group + [short] * pad   # a bool: a random row, capped if True
    first = len(rows)
    rows = rows[:B] + [((r - first) // CSR_TILE) % 2 == 0   # random tiles, every other capped
                       for r in range(first, B)]
    end = np.zeros(B, dtype=np.int32)
    for row, item in enumerate(rows):
        if isinstance(item, bool):
            capped[row] = item
            continue
        at, x = item
        if at is None:
            start[row], end[row] = x
            continue
        buf[row, at:at + len(x)] = np.frombuffer(x, dtype=np.uint8) if x else 0
        start[row], end[row] = at, at + len(x)
        if x.endswith(b";") and at + len(x) < L:
            buf[row, at + len(x)] = ord(" ")
    random = np.array([isinstance(item, bool) for item in rows], dtype=bool)
    width = np.where(capped, rng.integers(0, CSR_SHORT_SPAN + 1, size=B), width)
    end = np.where(random, np.minimum(start + width, L), end).astype(np.int32)
    return buf, start, end


def csr_tile_kinds(start: np.ndarray, end: np.ndarray) -> Tuple[int, int]:
    """(tiles whose raw spans are all at most 64 bytes, the other tiles):
    how csr_split divides the rows [start, end) between its two paths."""
    n = -len(start) % CSR_TILE
    widths = np.concatenate([end - start, np.zeros(n, dtype=end.dtype)])
    short = (widths.reshape(-1, CSR_TILE) <= CSR_SHORT_SPAN).all(axis=1)
    return int(short.sum()), int((~short).sum())


# ---------------------------------------------------------------------------
# the parent's libraries
# ---------------------------------------------------------------------------


def c_params(source: str, name: str) -> List[Tuple[str, bool]]:
    """[(parameter name, is a pointer)] of ``lp_<name>`` in a C source."""
    m = re.search(rf"LP_EXPORT int lp_{name}\(([^)]*)\)", source)
    if not m:
        raise RuntimeError(f"no lp_{name} entry point")
    return [(re.split(r"[\s*]+", p.strip())[-1], "*" in p) for p in m.group(1).split(",")]


class ParentLib:
    """The parent's library of one kernel, called with the wrapper's
    argument list (stream last): arguments are picked by parameter name."""

    def __init__(self, path: Path, name: str, parent_src: str, src: str):
        dll = ctypes.CDLL(str(path))
        theirs, ours = c_params(parent_src, name), c_params(src, name)
        index = {n: i for i, (n, _) in enumerate(ours)}
        unknown = [n for n, _ in theirs if n not in index]
        if unknown:
            raise RuntimeError(f"the parent's lp_{name} takes {unknown}, which the "
                               "wrapper does not pass")
        pick = [index[n] for n, _ in theirs]
        fn = getattr(dll, f"lp_{name}")
        fn.argtypes = [ctypes.c_void_p if ptr else ctypes.c_int for _, ptr in theirs]
        fn.restype = ctypes.c_int
        err = getattr(dll, f"lp_{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        setattr(self, f"lp_{name}", lambda *args: fn(*[args[i] for i in pick]))
        setattr(self, f"lp_{name}_error", err)


def build_parent(src: Path, out: Path, names: Sequence[str]) -> Dict[str, ParentLib]:
    """{kernel: the parent's library}, built from ``src`` into ``out``."""
    from ..tpu import kernels

    procs = {k: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(src), "-o",
         str(out / f"lib{k}_parent.so"), str(src / f"{k}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in names}
    libs = {}
    for k, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc refused the parent's {k}.cu:\n{log}")
        libs[k] = ParentLib(out / f"lib{k}_parent.so", k, (src / f"{k}.cu").read_text(),
                            (kernels.CSRC / f"{k}.cu").read_text())
    return libs


@contextlib.contextmanager
def parent_kernel(name: str, lib: ParentLib):
    """The wrappers launch the parent's ``name`` inside."""
    from ..tpu import kernels

    kernels._lib(name)   # this checkout's libraries loaded, to swap one
    saved = kernels._BUILD.libs[name]
    kernels._BUILD.libs[name] = lib
    try:
        yield
    finally:
        kernels._BUILD.libs[name] = saved


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _cuda(*tensors):
    return [t.cuda() for t in tensors]


def zone_cases(smoke, kernels, pipeline):
    from ..dissectors.tztable import SPAN_MINUTES, default_zone_table
    from ..tools import demolog
    from ..tpu import runtime
    from .. import TorchBatchParser

    zt = pipeline.ZoneTables(default_zone_table()).cuda()
    table = zt.table
    sorted_keys = torch.from_numpy(table.keys.astype(np.int64)).cuda()

    def case(name, zones, minutes, gate, bytes_moved):
        query = zones.to(torch.int64) * SPAN_MINUTES + minutes.to(torch.int64).clamp(
            0, SPAN_MINUTES - 1)
        return Case(name, "zone_lookup",
                    lambda: kernels.zone_lookup(zt, zones, minutes, gate=gate),
                    lambda: pipeline.zone_lookup_plain(
                        zt, zones, minutes, gate,
                        torch.empty((2, zones.shape[0]), dtype=torch.int32, device="cuda")),
                    lambda: torch.searchsorted(sorted_keys, query, right=True),
                    bytes_moved, 0)

    z, m = smoke.zone_probe_pairs(np, table, SPAN_MINUTES)
    zones, minutes = _cuda(torch.from_numpy(z), torch.from_numpy(m))
    yield case("zone_lookup", zones, minutes, None,
               16 * len(z) + smoke.zone_table_bytes(torch, zt, zones, minutes))

    lines = demolog.zonetext_lines(smoke.N_LINES) + demolog.strftime_edge_lines()
    buf, lengths, _ = runtime.encode_batch(lines)
    (t,) = TorchBatchParser(demolog.ZONETEXT_FORMAT, demolog.ZONETEXT_FIELDS).executor.unit_tables
    (ts,) = t.ts
    dbuf, dlen = _cuda(torch.from_numpy(buf), torch.from_numpy(lengths))
    starts, ends, _ = kernels.split(t.split, dbuf, dlen)
    zones = torch.empty(dbuf.shape[0], dtype=torch.int32, device="cuda")
    rows = kernels.timestamp(ts, dbuf, starts, ends, zone_out=zones)
    minutes, gate = rows[2].clone(), rows[3].clone()
    yield case("zone_lookup_gated", zones, minutes, gate,
               20 * len(lines) + smoke.zone_table_bytes(torch, zt, zones, minutes))


def geo_cases(smoke, kernels, pipeline):
    from ..geoip import GeoDeviceTable, GeoIPASNDissector, GeoIPCityDissector
    from ..tools import demolog, geoip_testdata
    from ..tpu import runtime
    from .. import TorchBatchParser

    mask = 0xFFFFFFFF
    fixtures = geoip_testdata.ensure_test_databases()
    asn = os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb")

    def joins_of(city, lines, city_only=False):
        parser = TorchBatchParser("combined", demolog.GEOIP_FIELDS, extra_dissectors=[
            GeoIPCityDissector(city), GeoIPASNDissector(asn)])
        (t,) = parser.executor.unit_tables
        buf, lengths, _ = runtime.encode_batch(lines)
        dbuf, dlen = _cuda(torch.from_numpy(buf), torch.from_numpy(lengths))
        starts, ends, _ = kernels.split(t.split, dbuf, dlen)
        groups = [g for g in t.geo if not city_only or "location.latitude" in g.table.columns]
        out = []
        for g in groups:
            ip = kernels.ipv4_spans(g, dbuf, starts, ends)
            out.append((g, ip[0].clone(), ip[1].clone()))
        return out

    def case(name, joins):
        lib = [(g.starts.to(torch.int64) & mask, k.to(torch.int64) & mask) for g, k, _ in joins]
        bound = 0
        for g, k, gate in joins:
            host_gate = None if gate is None else gate.cpu().numpy()
            bound += (8 + (0 if gate is None else 4)) * k.shape[0] + smoke.geo_search_bytes(
                np, g.table.starts, g.table.ends, k.cpu().numpy().view(np.uint32), host_gate)[0]
        return Case(name, "geo_lookup",
                    lambda: [kernels.geo_lookup(g, k, gate=gate) for g, k, gate in joins],
                    lambda: [pipeline.geo_lookup_plain(g, k, gate, torch.empty_like(k))
                             for g, k, gate in joins],
                    lambda: [torch.searchsorted(s, k, right=True) for s, k in lib], bound, 0)

    city = os.path.join(fixtures, "GeoIP2-City-Test.mmdb")
    edge = demolog.geoip_edge_lines()
    yield case("geo_lookup", joins_of(city, demolog.geoip_chain_lines(smoke.N_LINES) + edge))

    syn = geoip_testdata.ensure_synthetic_city_database(seed=smoke.GEO_SYNTHETIC_SEED)
    nets = geoip_testdata.synthetic_networks(geoip_testdata.SYNTHETIC_NETWORKS,
                                             smoke.GEO_SYNTHETIC_SEED)
    yield case("geo_lookup_synthetic",
               joins_of(syn, demolog.geoip_synthetic_lines(smoke.N_LINES, nets) + edge, True))

    large, keys = smoke.large_geo_table(np, GeoDeviceTable)
    gl = pipeline.GeoTables(pipeline._GeoGroup("large", 0, large)).cuda()
    yield case("geo_lookup_large", [(gl, torch.from_numpy(keys.view(np.int32)).cuda(), None)])


def split_cases(smoke, kernels, pipeline):
    from ..tools import demolog
    from ..tpu import runtime
    from .. import TorchBatchParser

    def case(name, parser, lines, line_len=0):
        buf, lengths, _ = runtime.encode_batch(lines, line_len=line_len)
        (t,) = parser.executor.unit_tables
        dbuf, dlen = _cuda(torch.from_numpy(buf), torch.from_numpy(lengths))
        B, L = buf.shape
        return Case(name, "split", lambda: kernels.split(t.split, dbuf, dlen),
                    lambda: pipeline.compute_split(t.split.program, dbuf, dlen), None,
                    *smoke.split_cost(t.split, B, L))

    headline = TorchBatchParser("combined", demolog.HEADLINE_FIELDS)
    lines = demolog.generate_combined_lines(smoke.N_LINES, seed=42,
                                            garbage_fraction=0.01) + smoke.EDGE_LINES
    yield case("split_headline", headline, lines)
    yield case("split_uri", TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS),
               demolog.generate_combined_lines(smoke.N_LINES, seed=53)
               + demolog.uri_edge_lines())
    yield case("split_cookies",
               TorchBatchParser(demolog.COOKIE_FORMAT, demolog.COOKIE_FIELDS,
                                type_remappings=demolog.COOKIE_REMAPPINGS),
               demolog.cookie_lines(smoke.N_LINES) + demolog.cookie_edge_lines())
    yield case("split_nul", TorchBatchParser(smoke.NUL_FORMAT, smoke.NUL_FIELDS),
               smoke.nul_lines(np))
    yield case("split_headline_8191", headline, lines, line_len=8191)


def agg_cases(smoke, kernels, pipeline):
    from ..analytics import AggregateSpec
    from ..tools import demolog
    from ..tpu import runtime
    from .. import TorchBatchParser

    def case(name, t, cls, lanes):
        B = cls.shape[0]
        tile, ntiles = agg_device.sum_tiling(B)

        def plain():
            return agg_device.agg_reduce_plain(
                t, cls, lanes, torch.empty(1 + t.n_bins, dtype=torch.int32, device="cuda"),
                torch.empty((len(t.sums_py), ntiles, 3, 2), dtype=torch.int32,
                            device="cuda"))

        return Case(name, "agg_reduce", lambda: kernels.agg_reduce(t, cls, lanes), plain,
                    smoke.agg_reduce_library(torch, t, lanes),
                    *smoke.agg_reduce_cost(t, B, ntiles))

    lines = (demolog.generate_combined_lines(smoke.N_LINES, seed=42, garbage_fraction=0.01)
             + demolog.aggregate_edge_lines())
    buf, lengths, _ = runtime.encode_batch(lines)
    ex = TorchBatchParser("combined", demolog.HEADLINE_FIELDS)._agg_executor(
        AggregateSpec.parse(demolog.DASHBOARD_OPS))
    dbuf, dlen = _cuda(torch.from_numpy(buf), torch.from_numpy(lengths))
    B = dbuf.shape[0]
    cls, lanes = kernels.agg_lanes(ex.tables, ex.units(dbuf, dlen), dbuf, B,
                                   torch.zeros(B, dtype=torch.uint8, device="cuda"))
    yield case("agg_reduce_dashboard", ex.tables, cls, lanes)
    for B in SEEDED_B:
        t, cls, lanes = seeded_reduce_case(B, seed=B)
        yield case(f"agg_reduce_seeded_{B}", t.cuda(), *_cuda(cls, lanes))


def csr_cases(smoke, kernels, pipeline):
    from ..tools import demolog
    from ..tpu import runtime
    from .. import TorchBatchParser

    def grown(parser, slots):
        while parser.csr_slots < slots:
            parser._grow_csr_slots()
        return parser

    def case(name, dbuf, block, groups, cursors, cap):
        base = block.clone()
        B = dbuf.shape[0]
        n_read = n_bytes = 0
        for c in groups:
            if cursors:
                s, e = cursors[0][c.token_index], cursors[1][c.token_index]
                n_bytes += 8 * B
            else:
                s = base[c.src[0]]
                e = s + base[c.src[1]]
                n_bytes += 12 * B
            n = smoke.span_bytes(torch, s, e, cap(c))
            n_read += n
            n_bytes += n + 4 * B * (2 * c.slots + 2)

        def run():
            for c in groups:
                kernels.csr_split(c, dbuf, block, *cursors)
            return block

        def plain():
            out = base.clone()
            for c in groups:
                pipeline.csr_split_plain(c, dbuf, out, *cursors)
            return out

        return Case(name, "csr_split", run, plain, None, n_bytes, 6 * n_read)

    lines = demolog.generate_combined_lines(smoke.N_LINES, seed=53) + demolog.uri_edge_lines()
    buf, lengths, _ = runtime.encode_batch(lines)
    dbuf, dlen = _cuda(torch.from_numpy(buf), torch.from_numpy(lengths))
    for slots in (16, 128):
        (t,) = grown(TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS),
                     slots).executor.unit_tables
        starts, ends, _ = kernels.split(t.split, dbuf, dlen)
        block = torch.zeros((t.n_comp, dbuf.shape[0]), dtype=torch.int32, device="cuda")
        a = t.stages.n_out
        kernels.span_stages(t.stages, dbuf, starts, ends, out=block[:a])
        for g, ts in enumerate(t.ts):
            kernels.timestamp(ts, dbuf, starts, ends, out=block[a + 4 * g:a + 4 * g + 4])
        for u in t.uri:
            kernels.uri_split(u, dbuf, starts, ends, block)
        yield case(f"csr_split_uri_{slots}", dbuf, block, t.csr, (), lambda c: c.window)

    lines = demolog.cookie_lines(smoke.N_LINES) + demolog.cookie_edge_lines()
    buf, lengths, _ = runtime.encode_batch(lines)
    dbuf, dlen = _cuda(torch.from_numpy(buf), torch.from_numpy(lengths))
    (t,) = grown(TorchBatchParser(demolog.COOKIE_FORMAT, demolog.COOKIE_FIELDS,
                                  type_remappings=demolog.COOKIE_REMAPPINGS),
                 128).executor.unit_tables
    starts, ends, _ = kernels.split(t.split, dbuf, dlen)
    block = torch.zeros((t.n_comp, dbuf.shape[0]), dtype=torch.int32, device="cuda")
    yield case("csr_split_cookie", dbuf, block, [c for c in t.csr if c.mode == "cookie"],
               (starts, ends), lambda c: c.window)


def sp_cases(smoke, kernels, pipeline):
    from ..parallel import mesh
    from ..tools import demolog
    from ..tpu import runtime
    from .. import TorchBatchParser

    prog = TorchBatchParser("combined", demolog.HEADLINE_FIELDS).units[0].program
    cuda0 = torch.device("cuda", 0)

    flat = smoke.flat

    def cases(name, shape, dbuf, dlen):
        B, L = dbuf.shape
        m = mesh.make_mesh(*shape, devices=[cuda0] * 8)
        run = mesh.sequence_parallel_runner(prog, m, L)
        per_op = mesh._sp_runner(prog, m, L, one_launch=False)
        fused = smoke.recorded(kernels, "sp_program", lambda: run(dbuf, dlen))
        calls = smoke.recorded(kernels, "sp_split", lambda: per_op(dbuf, dlen))
        cost = smoke.sp_cost(prog, B, L)
        yield Case(name, "sp_program",
                   lambda: flat([kernels.sp_program(*a, **k) for a, k in fused]),
                   lambda: flat([mesh.sp_program_plain(*a, **k) for a, k in fused]), None,
                   *cost, parent=lambda: [kernels.sp_split(*a, **k) for a, k in calls],
                   parent_plain=lambda: [mesh.sp_split_step_plain(*a, **k) for a, k in calls])

        def plain_runner():
            with smoke.swapped(kernels, "sp_program", mesh.sp_program_plain):
                return flat([run(dbuf, dlen)])

        yield Case(f"{name}_runner", "sp_program", lambda: flat([run(dbuf, dlen)]),
                   plain_runner, None, *cost, parent=lambda: flat([per_op(dbuf, dlen)]))

    lines = demolog.generate_combined_lines(smoke.N_LINES, seed=42,
                                            garbage_fraction=0.01) + smoke.EDGE_LINES
    lines += [""] * (-len(lines) % 4)
    buf, lengths, _ = runtime.encode_batch(lines)
    yield from cases("sp_program_headline", (2, 4),
                     *_cuda(torch.from_numpy(buf), torch.from_numpy(lengths)))
    buf, lengths, _ = runtime.encode_batch(demolog.long_combined_lines(8192, seed=63),
                                           line_len=32768)
    yield from cases("sp_program_long", (1, 4),
                     *_cuda(torch.from_numpy(buf), torch.from_numpy(lengths)))


CASES = {"zone_lookup": zone_cases, "geo_lookup": geo_cases, "split": split_cases,
         "agg_reduce": agg_cases, "csr_split": csr_cases, "sp_program": sp_cases}


def _same(a, b) -> bool:
    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv) -> int:
    if not argv or any(k not in CASE_KERNELS for k in argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    from ..tpu import kernels, pipeline

    names = argv[1:] or list(CASE_KERNELS)
    smi = smoke.card_line()
    kernels.build()
    with tempfile.TemporaryDirectory() as tmp:
        parent = build_parent(Path(argv[0]).resolve(), Path(tmp),
                              [k for k in names if k not in NO_PARENT_LIBRARY])
        clock = smoke.DeviceClock(torch)
        for kname in names:
            for case in CASES[kname](smoke, kernels, pipeline):
                if case.parent is not None:
                    run_parent = case.parent
                else:
                    def run_parent(case=case, lib=parent[case.kernel]):
                        with parent_kernel(case.kernel, lib):
                            return case.run()

                for who, fn, plain in (("parent", run_parent, case.parent_plain or case.plain),
                                       ("change", case.run, case.plain)):
                    want = plain()
                    got = fn()
                    torch.cuda.synchronize()
                    if not _same(got, want):
                        print(f"kernel_ab: {case.name}: the {who} kernel differs from the "
                              "plain version", file=sys.stderr)
                        return 1
                    del want, got
                turns = [("parent", run_parent), ("change", case.run),
                         ("change", case.run), ("parent", run_parent)]
                if case.library is not None:
                    turns.append(("library", case.library))
                bound, bound_by = smoke.bound_ms(case.bytes_moved, case.ops)
                line = {"case": case.name, "kernel": case.kernel, "bound_ms": bound,
                        "bound_by": bound_by, "bytes": case.bytes_moved}
                for who, fn in turns:
                    ms, enqueue = clock.time(fn, REPS)
                    line.setdefault(f"{who}_ms", []).append(ms)
                    line.setdefault(f"{who}_enqueue_ms", []).append(enqueue)
                line["card"] = smi
                print(json.dumps(line), flush=True)
                del case, turns, run_parent
                torch.cuda.empty_cache()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
