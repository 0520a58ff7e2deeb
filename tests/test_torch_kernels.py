"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(decided inside the ``cuda_device`` fixture, never at import).  This file
imports neither jax nor the JAX package, so it also runs on a machine
without them; there, skip the JAX-forcing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.analytics import AggregateSpec
from logparser_tpu_torch.analytics import device as agg_device
from logparser_tpu_torch.dissectors.tztable import SPAN_MINUTES, default_zone_table
from logparser_tpu_torch.tools.demolog import (
    COMBINEDIO_STRFTIME_FIELDS,
    COOKIE_FIELDS,
    COOKIE_FORMAT,
    COOKIE_REMAPPINGS,
    cookie_edge_lines,
    cookie_lines,
    DASHBOARD_OPS,
    COMBINEDIO_STRFTIME_FORMAT,
    GEOIP_FIELDS,
    GEOIP_TWO_TOKEN_FIELDS,
    GEOIP_TWO_TOKEN_FORMAT,
    HEADLINE_FIELDS,
    NGINX_TIMING_FIELDS,
    NGINX_TIMING_FORMAT,
    NGINX_URI_FIELDS,
    NGINX_URI_FORMAT,
    URI_CHAIN_FIELDS,
    ZONETEXT_FIELDS,
    ZONETEXT_FORMAT,
    aggregate_edge_lines,
    combinedio_strftime_lines,
    generate_combined_lines,
    geoip_chain_lines,
    geoip_edge_lines,
    geoip_two_token_lines,
    nginx_edge_lines,
    nginx_timing_lines,
    nginx_uri_lines,
    representative_spec,
    strftime_edge_lines,
    uri_edge_lines,
    zonetext_lines,
)
from logparser_tpu_torch.tools.kernel_ab import (
    SEEDED_B,
    SEEDED_LANES_FIELDS,
    SEEDED_LANES_FORMAT,
    SEEDED_LANES_OPS,
    SPLIT_WIDTHS,
    lanes_kinds,
    seeded_ipv4_case,
    seeded_lanes_case,
    seeded_muid_case,
    seeded_reduce_case,
    seeded_split_case,
    seeded_unescape_case,
    unescape_kinds,
    window_inside,
)
from logparser_tpu_torch.tpu import kernels, pipeline, postproc
from logparser_tpu_torch.tpu.runtime import encode_batch

pytestmark = pytest.mark.cuda

FIELDS = ["IP:connection.client.host", "BYTES:response.body.bytes",
          "TIME.EPOCH:request.receive.time.epoch", "HTTP.URI:request.firstline.uri"]
_PREFIX = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200'
EDGE_LINES = [
    _PREFIX + ' 0 "x" "esc \\" quote"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /p\\" HTTP/1.0" 200 0 "x" "y"',
    _PREFIX + ' - "x" "y"',
    _PREFIX + ' 12345678901234567890 "x" "y"',
    '1.2.3.4 - - [01/jan/2024:00:00:00 -0930] "GET /x" 200 5 "x" "y"',
    '1.2.3.4 - - [29/Feb/2023:00:00:00 +1400] "GET / HTTP/1.1" 200 5 "x" "y"',
    _PREFIX + ' 0 "x" "café ☃"',
    "", '"', "completely broken line",
]


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lines(seed=5):
    rng = np.random.default_rng(seed)
    lines = generate_combined_lines(3000, seed=seed, garbage_fraction=0.05) + EDGE_LINES
    common = [ln.rsplit(' "', 2)[0] for ln in generate_combined_lines(200, seed=seed)]
    noise = [bytes(rng.integers(1, 256, size=int(rng.integers(0, 200)), dtype=np.uint8))
             .replace(b"\n", b" ") for _ in range(200)]
    return lines + common + noise


# A separator longer than one 32-bit plane word (the split kernel's
# cross-word literal shift).
LONG_SEP = "%h " + "=" * 40 + ' %u %t "%r" %>s %b'


@pytest.mark.parametrize("fmt", ["combined", "combined\ncommon", LONG_SEP])
@pytest.mark.parametrize("line_len", [0, 8191])
def test_kernels_equal_plain_versions(cuda_device, fmt, line_len):
    ex = TorchBatchParser(fmt, FIELDS, device=cuda_device).executor
    lines = _lines()
    lines += [ln.replace(" - ", " " + "=" * 40 + " ", 1).rsplit(' "', 2)[0]
              for ln in generate_combined_lines(300, seed=9)]
    buf, lengths, _ = encode_batch(lines, line_len=line_len)
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    for t in ex.unit_tables:
        got = kernels.split(t.split, buf, lengths)
        want = pipeline.compute_split(t.split.program, buf, lengths)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        starts, ends, _ = got
        comps = kernels.span_stages(t.stages, buf, starts, ends)
        assert torch.equal(comps, pipeline.span_stages_plain(
            t.stages, buf, starts, ends, torch.empty_like(comps)))
        for ts in t.ts:
            out = kernels.timestamp(ts, buf, starts, ends)
            assert torch.equal(out, pipeline.timestamp_plain(
                ts, buf, starts, ends, torch.empty_like(out)))
    cpu = TorchBatchParser(fmt, FIELDS, device="cpu").executor
    packed = ex(buf, lengths)
    torch.cuda.synchronize()
    assert np.array_equal(packed.cpu().numpy(), cpu(buf.cpu(), lengths.cpu()).numpy())


@pytest.mark.parametrize("L", [64, 1024, 8191])
def test_kernels_on_random_buffers(cuda_device, L):
    """Separator-heavy random bytes, any length in [0, L], and garbage
    past each line's length (the escape scan reads the whole row)."""
    rng = np.random.default_rng(L)
    alphabet = np.frombuffer(b' "[]\\-0123456789/:+abcGETHTP.=', dtype=np.uint8)
    buf = torch.from_numpy(rng.choice(alphabet, size=(1500, L)).astype(np.uint8))
    lengths = torch.from_numpy(rng.integers(0, L + 1, size=1500).astype(np.int32))
    for fmt in ("combined", LONG_SEP):
        gpu = TorchBatchParser(fmt, FIELDS, device=cuda_device).executor
        cpu = TorchBatchParser(fmt, FIELDS, device="cpu").executor
        packed = gpu(buf.to(cuda_device), lengths.to(cuda_device)).cpu()
        assert torch.equal(packed, cpu(buf, lengths))


def test_parse_batch_on_the_card_equals_the_cpu(cuda_device):
    lines = generate_combined_lines(5000, seed=42, garbage_fraction=0.01) + EDGE_LINES
    kernels.reset_launch_counts()
    gpu = TorchBatchParser("combined", HEADLINE_FIELDS).parse_batch(lines)
    counts = kernels.launch_counts()
    assert counts.pop("uri_split") == 0 and counts.pop("csr_split") == 0
    assert counts.pop("zone_lookup") == 0
    assert counts.pop("ipv4_spans") == 0 and counts.pop("geo_lookup") == 0
    assert all(counts.pop(k) == 0 for k in ("agg_lanes", "agg_reduce", "agg_group"))
    assert counts.pop("setcookie_split") == 0 and counts.pop("muid") == 0
    assert counts.pop("unescape") == 0 and counts.pop("geo_gather") == 0
    assert counts.pop("sp_split") == 0 and counts.pop("counters") == 0
    assert counts.pop("sp_program") == 0
    assert all(n == 1 for n in counts.values())
    cpu = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu").parse_batch(lines)
    assert gpu.to_dict() == cpu.to_dict()
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()


def test_kernel_rejects_cpu_tables_with_cuda_data(cuda_device):
    ex = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu").executor
    buf, lengths, _ = encode_batch(EDGE_LINES)
    with pytest.raises(ValueError):
        kernels.split(ex.unit_tables[0].split, torch.from_numpy(buf).to(cuda_device),
                      torch.from_numpy(lengths).to(cuda_device))


def _uri_lines(seed=53):
    return uri_edge_lines() + generate_combined_lines(3000, seed=seed, garbage_fraction=0.02)


def _grown(parser, slots):
    while parser.csr_slots < slots:
        assert parser._grow_csr_slots()
    return parser


@pytest.mark.parametrize("line_len,slots", [(0, 16), (128, 16), (0, 128), (8191, 32)])
def test_uri_kernels_equal_plain_versions(cuda_device, line_len, slots):
    """uri_split and csr_split, one group at a time, on the same input
    block as their plain versions; span_stages (with the protocol split)
    and pack_rows (with the overflow bit) under the URI chain's tables."""
    ex = _grown(TorchBatchParser("combined", URI_CHAIN_FIELDS, device=cuda_device),
                slots).executor
    lines = _uri_lines()
    if line_len == 8191:
        lines += [uri_edge_lines()[0].replace("/x/y?", "/" + "z" * 2000 + "?")]
    buf, lengths, _ = encode_batch(lines, line_len=line_len)
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    B = buf.shape[0]
    flags = torch.empty((len(ex.unit_tables), B), dtype=torch.int32, device=cuda_device)
    comps = torch.zeros((ex.n_comp, B), dtype=torch.int32, device=cuda_device)
    for ui, t in enumerate(ex.unit_tables):
        starts, ends, _ = kernels.split(t.split, buf, lengths, flags_out=flags[ui])
        block = comps[t.comp_base:t.comp_base + t.n_comp]
        a = t.stages.n_out
        out = kernels.span_stages(t.stages, buf, starts, ends, out=block[:a])
        assert torch.equal(out, pipeline.span_stages_plain(
            t.stages, buf, starts, ends, torch.empty_like(out)))
        for g, ts in enumerate(t.ts):
            kernels.timestamp(ts, buf, starts, ends, out=block[a + 4 * g:a + 4 * g + 4])
        for u in t.uri:
            want = pipeline.uri_split_plain(u, buf, starts, ends, block.clone())
            assert torch.equal(kernels.uri_split(u, buf, starts, ends, block), want)
        for c in t.csr:
            want = pipeline.csr_split_plain(c, buf, block.clone())
            assert torch.equal(kernels.csr_split(c, buf, block), want)
    packed = kernels.pack_rows(ex.pack, flags, comps)
    assert torch.equal(packed, pipeline.pack_rows_plain(ex.pack, flags, comps))
    row0 = packed[0].cpu().numpy()
    # The 20-parameter and the cap lines overflow unless the bucket cut them.
    assert ((row0 & pipeline.CSR_OVERFLOW_BIT) != 0).any() == (line_len != 128)
    cpu = _grown(TorchBatchParser("combined", URI_CHAIN_FIELDS, device="cpu"),
                 slots).executor
    assert np.array_equal(ex(buf, lengths).cpu().numpy(),
                          cpu(buf.cpu(), lengths.cpu()).numpy())


@pytest.mark.parametrize("L", [64, 512, 2048])
def test_uri_kernels_on_random_buffers(cuda_device, L):
    """URI-ish random bytes under a format that captures the whole line
    as the first line and the referer: every URI and query class, spans
    of any length, at windowed and unwindowed buckets."""
    rng = np.random.default_rng(L)
    alphabet = np.frombuffer(b'/?&=:%@#;.-+aZ09[]h {"', dtype=np.uint8)
    lines = [b"GET " + bytes(rng.choice(alphabet, size=int(rng.integers(0, L - 24))))
             + b' HTTP/1.1" "' + bytes(rng.choice(alphabet, size=int(rng.integers(0, 8))))
             for _ in range(1500)]
    fmt = '"%r" "%{Referer}i'
    fields = ["HTTP.PATH:request.firstline.uri.path",
              "HTTP.QUERYSTRING:request.firstline.uri.query",
              "STRING:request.firstline.uri.query.*",
              "HTTP.USERINFO:request.firstline.uri.userinfo",
              "HTTP.HOST:request.firstline.uri.host",
              "HTTP.PORT:request.firstline.uri.port",
              "HTTP.PROTOCOL.VERSION:request.firstline.protocol.version",
              "STRING:request.referer.query.a"]
    buf, lengths, _ = encode_batch([b'"' + ln for ln in lines], line_len=L)
    buf, lengths = torch.from_numpy(buf), torch.from_numpy(lengths)
    for slots in (16, 64):
        gpu = _grown(TorchBatchParser(fmt, fields, device=cuda_device), slots).executor
        cpu = _grown(TorchBatchParser(fmt, fields, device="cpu"), slots).executor
        packed = gpu(buf.to(cuda_device), lengths.to(cuda_device)).cpu()
        assert torch.equal(packed, cpu(buf, lengths))


def test_uri_chain_on_the_card_equals_the_cpu(cuda_device):
    """parse_batch end to end: the regrow on the card (16 -> 128 slots,
    the longest query stays on the host) and every column equal."""
    lines = _uri_lines(7)
    kernels.reset_launch_counts()
    gpu = TorchBatchParser("combined", URI_CHAIN_FIELDS).parse_batch(lines)
    counts = kernels.launch_counts()
    assert counts["uri_split"] == 2 * counts["split"] and counts["csr_split"] >= 8
    cpu = TorchBatchParser("combined", URI_CHAIN_FIELDS, device="cpu").parse_batch(lines)
    assert gpu.csr_regrows == cpu.csr_regrows == 3
    assert gpu.to_dict() == cpu.to_dict()
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()
    assert len(uri_edge_lines()) - 1 in gpu.needs_host.tolist()


STRFTIME = {
    "combinedio_strftime": (COMBINEDIO_STRFTIME_FORMAT, COMBINEDIO_STRFTIME_FIELDS,
                            combinedio_strftime_lines),
    "strftime_zonetext": (ZONETEXT_FORMAT, ZONETEXT_FIELDS, zonetext_lines),
    "full_month_12h": ('%h [%{%d/%B/%Y:%I:%M:%S %p %z}t] %>s',
                       ["TIME.EPOCH:request.receive.time.epoch"], None),
}


def _strftime_lines(name, seed=3):
    fmt, _, gen = STRFTIME[name]
    if gen is None:
        rng = np.random.default_rng(seed)
        months = ["January", "May", "september", "JULY", "Feb", "Mayo"]
        return [f"1.2.3.4 [{int(rng.integers(0, 33)):02d}/{rng.choice(months)}/2024:"
                f"{int(rng.integers(0, 14)):02d}:07:08 {rng.choice(['AM', 'pm', 'XM'])} "
                f"{rng.choice(['+0100', '-05:30', '+2400', 'Z'])}] 200" for _ in range(2000)]
    rng = np.random.default_rng(seed)
    lines = gen(3000) + strftime_edge_lines()
    for ln in gen(300):   # one byte replaced near the timestamp
        b = bytearray(ln.encode())
        at = ln.find("[") + int(rng.integers(0, 40))
        if 0 <= at < len(b):
            b[at] = int(rng.choice(list(b"0123456789:/+- ]ZzCc")))
        lines.append(bytes(b))
    return lines


@pytest.mark.parametrize("name", sorted(STRFTIME))
@pytest.mark.parametrize("line_len", [0, 8191])
def test_strftime_kernels_equal_plain_versions(cuda_device, name, line_len):
    """timestamp (every segment kind, both tails) and, for the %Z layout,
    zone_lookup on the timestamp's rows, against their plain versions;
    then the whole executor against the CPU's."""
    fmt, fields, _ = STRFTIME[name]
    ex = TorchBatchParser(fmt, fields, device=cuda_device).executor
    buf, lengths, _ = encode_batch(_strftime_lines(name), line_len=line_len)
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    B = buf.shape[0]
    (t,) = ex.unit_tables
    starts, ends, _ = kernels.split(t.split, buf, lengths)
    for ts in t.ts:
        zone = torch.empty(B, dtype=torch.int32, device=cuda_device)
        want_zone = torch.empty_like(zone)
        out = kernels.timestamp(ts, buf, starts, ends, zone_out=zone)
        want = pipeline.timestamp_plain(ts, buf, starts, ends, torch.empty_like(out),
                                        want_zone)
        assert torch.equal(out, want)
        if ts.zone is not None:
            assert torch.equal(zone, want_zone)
            got = kernels.zone_lookup(ts.zone, zone, out[2], gate=out[3])
            assert torch.equal(got, pipeline.zone_lookup_plain(
                ts.zone, zone, out[2], out[3], torch.empty_like(got)))
    cpu = TorchBatchParser(fmt, fields, device="cpu").executor
    assert np.array_equal(ex(buf, lengths).cpu().numpy(),
                          cpu(buf.cpu(), lengths.cpu()).numpy())


def test_zone_lookup_kernel_on_every_transition(cuda_device):
    table = default_zone_table()
    zones, minutes = [], []
    for key in table.keys.astype(np.int64).tolist():
        z, m = divmod(key, SPAN_MINUTES)
        zones += [z] * 3
        minutes += [m - 1, m, m + 1]
    for z, vu in enumerate(table.valid_until.tolist()):
        zones += [z] * 5
        minutes += [vu - 1, vu, -1, 0, SPAN_MINUTES]
    rng = np.random.default_rng(5)
    zones += rng.integers(0, len(table.zones), size=65536).tolist()
    minutes += rng.integers(-10, SPAN_MINUTES + 10, size=65536).tolist()
    z = torch.tensor(zones, dtype=torch.int32, device=cuda_device)
    m = torch.tensor(minutes, dtype=torch.int32, device=cuda_device)
    zt = pipeline.ZoneTables(table).to(cuda_device)
    got = kernels.zone_lookup(zt, z, m)
    want = pipeline.zone_lookup_plain(zt, z, m, None, torch.empty_like(got))
    assert torch.equal(got, want)
    # A gated call in place on the minute and gate rows, as the %Z path
    # makes it.
    gate = torch.from_numpy(rng.integers(0, 2, size=len(zones)).astype(np.int32))
    rows = torch.stack([m, gate.to(cuda_device)])
    want = pipeline.zone_lookup_plain(zt, z, rows[0], rows[1], torch.empty_like(rows))
    assert kernels.zone_lookup(zt, z, rows[0], gate=rows[1], out=rows) is rows
    assert torch.equal(rows, want)
    # A batch smaller than one block, and one larger than the persistent
    # grid's stride (132 SMs x 2,048 threads).
    for n in (37, 1 << 21):
        zs = torch.from_numpy(rng.integers(0, len(table.zones), size=n).astype(np.int32))
        ms = torch.from_numpy(rng.integers(-10, SPAN_MINUTES + 10, size=n).astype(np.int32))
        zs, ms = zs.to(cuda_device), ms.to(cuda_device)
        got = kernels.zone_lookup(zt, zs, ms)
        assert torch.equal(got, pipeline.zone_lookup_plain(zt, zs, ms, None,
                                                           torch.empty_like(got)))


@pytest.mark.parametrize("name", ["combinedio_strftime", "strftime_zonetext"])
def test_strftime_parse_on_the_card_equals_the_cpu(cuda_device, name):
    fmt, fields, gen = STRFTIME[name]
    lines = gen(5000) + strftime_edge_lines()
    kernels.reset_launch_counts()
    gpu = TorchBatchParser(fmt, fields).parse_batch(lines)
    counts = kernels.launch_counts()
    assert counts["timestamp"] == 1
    assert counts["zone_lookup"] == (1 if "%Z" in fmt else 0)
    cpu = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    assert gpu.to_dict() == cpu.to_dict()
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()


def _geo_parser(device, city=None):
    import os

    from logparser_tpu_torch.geoip import GeoIPASNDissector, GeoIPCityDissector
    from logparser_tpu_torch.tools.geoip_testdata import ensure_test_databases

    fixtures = ensure_test_databases()
    city = city or os.path.join(fixtures, "GeoIP2-City-Test.mmdb")
    return TorchBatchParser(
        "combined", GEOIP_FIELDS, device=device,
        extra_dissectors=[GeoIPCityDissector(city),
                          GeoIPASNDissector(os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb"))])


def _ip_lines(seed=6):
    """GeoIP corpus lines, edge lines, and hosts of random dotted-quad-ish
    bytes."""
    rng = np.random.default_rng(seed)
    lines = geoip_chain_lines(3000) + geoip_edge_lines()
    alpha = list("0123456789.:")
    for ln in generate_combined_lines(500, seed=seed):
        host = "".join(rng.choice(alpha, size=int(rng.integers(1, 18))))
        lines.append(host + ln[ln.index(" "):])
    return lines


@pytest.mark.parametrize("line_len", [0, 8191])
def test_geo_kernels_equal_plain_versions(cuda_device, line_len):
    ex = _geo_parser(cuda_device).executor
    buf, lengths, _ = encode_batch(_ip_lines(), line_len=line_len)
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    (t,) = ex.unit_tables
    starts, ends, _ = kernels.split(t.split, buf, lengths)
    assert len(t.geo) == 2 and len(t.ip) == 1
    (ip,) = t.ip
    rows = kernels.ipv4_spans(ip, buf, starts, ends)
    want = pipeline.ipv4_spans_plain(ip, buf, starts, ends, torch.empty_like(rows))
    assert torch.equal(rows, want)
    for g in t.geo:
        for gate in (None, rows[1]):
            got = kernels.geo_lookup(g, rows[0], gate=gate)
            assert torch.equal(got, pipeline.geo_lookup_plain(g, rows[0], gate,
                                                              torch.empty_like(got)))
    cpu = _geo_parser("cpu").executor
    assert np.array_equal(ex(buf, lengths).cpu().numpy(),
                          cpu(buf.cpu(), lengths.cpu()).numpy())


@pytest.mark.parametrize("K", [0, 1, 2, 1000, 8192, 8193, 1 << 20])
def test_geo_lookup_kernel_on_seeded_tables(cuda_device, K):
    """Disjoint ranges across the whole uint32 space (half of them above
    2^31, negative as int32): every start, end and their neighbours, 0,
    0xFFFFFFFF and random keys; gated; and batches smaller than one block
    and larger than the persistent grid's stride.  8,192 ranges are one
    splitter each (S = 1), 8,193 two (S = 2)."""
    from logparser_tpu_torch.geoip import GeoDeviceTable

    rng = np.random.default_rng(K)
    bounds = np.sort(rng.choice(1 << 32, size=2 * K, replace=False)).astype(np.uint32)
    starts, ends = bounds[0::2], bounds[1::2]
    table = GeoDeviceTable.from_ranges(starts, ends)
    g = pipeline.GeoTables(pipeline._GeoGroup("k", 0, table)).to(cuda_device)
    keys = np.concatenate([starts.astype(np.int64), ends, starts.astype(np.int64) - 1,
                           ends.astype(np.int64) + 1, [0, 0xFFFFFFFF],
                           rng.integers(0, 1 << 32, size=100000)])
    keys = torch.from_numpy((keys & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    keys = keys.to(cuda_device)
    got = kernels.geo_lookup(g, keys)
    want = pipeline.geo_lookup_plain(g, keys, None, torch.empty_like(got))
    assert torch.equal(got, want)
    if K:
        assert int((got[:K] == torch.arange(1, K + 1, device=cuda_device)).sum()) == K
    assert g.split_shift == (0 if K <= 8192 else (1 if K == 8193 else 7))
    gate = torch.from_numpy(rng.integers(0, 2, size=keys.shape[0]).astype(np.int32))
    gate = gate.to(cuda_device)
    got = kernels.geo_lookup(g, keys, gate=gate)
    assert torch.equal(got, pipeline.geo_lookup_plain(g, keys, gate, torch.empty_like(got)))
    for n in (37, 1 << 21):
        ks = torch.from_numpy(rng.integers(0, 1 << 32, size=n).astype(np.uint32).view(np.int32))
        ks = ks.to(cuda_device)
        got = kernels.geo_lookup(g, ks)
        assert torch.equal(got, pipeline.geo_lookup_plain(g, ks, None, torch.empty_like(got)))


@pytest.mark.parametrize("line_len", [0, 8191])
def test_secmillis_task_equals_plain_version(cuda_device, line_len):
    ex = TorchBatchParser(NGINX_TIMING_FORMAT, NGINX_TIMING_FIELDS, device=cuda_device).executor
    rng = np.random.default_rng(8)
    lines = nginx_timing_lines(3000) + nginx_edge_lines()
    for ln in nginx_timing_lines(500):   # one byte replaced in the last token
        b = bytearray(ln.encode())
        b[-int(rng.integers(1, 6))] = int(rng.choice(list(b"0123456789.-x ")))
        lines.append(bytes(b))
    buf, lengths, _ = encode_batch(lines, line_len=line_len)
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    (t,) = ex.unit_tables
    assert any(task[0] == pipeline.TASK_SECMILLIS for task in t.stages.tasks_py)
    starts, ends, _ = kernels.split(t.split, buf, lengths)
    got = kernels.span_stages(t.stages, buf, starts, ends)
    want = pipeline.span_stages_plain(t.stages, buf, starts, ends, torch.empty_like(got))
    assert torch.equal(got, want)
    cpu = TorchBatchParser(NGINX_TIMING_FORMAT, NGINX_TIMING_FIELDS, device="cpu").executor
    assert np.array_equal(ex(buf, lengths).cpu().numpy(),
                          cpu(buf.cpu(), lengths.cpu()).numpy())


@pytest.mark.parametrize("name", ["geoip_chain", "nginx_uri", "nginx_timing"])
def test_geo_and_nginx_parse_on_the_card_equals_the_cpu(cuda_device, name):
    if name == "geoip_chain":
        lines = geoip_chain_lines(5000) + geoip_edge_lines()
        gpu_parser, cpu_parser = _geo_parser(cuda_device), _geo_parser("cpu")
    else:
        fmt, fields, gen = {
            "nginx_uri": (NGINX_URI_FORMAT, NGINX_URI_FIELDS, nginx_uri_lines),
            "nginx_timing": (NGINX_TIMING_FORMAT, NGINX_TIMING_FIELDS, nginx_timing_lines),
        }[name]
        lines = gen(5000) + nginx_edge_lines()
        gpu_parser = TorchBatchParser(fmt, fields)
        cpu_parser = TorchBatchParser(fmt, fields, device="cpu")
    kernels.reset_launch_counts()
    gpu = gpu_parser.parse_batch(lines)
    counts = kernels.launch_counts()
    # One ipv4_spans launch per IP token (City and ASN both read %h), one
    # geo_lookup per group.
    tokens, groups = (1, 2) if name == "geoip_chain" else (0, 0)
    assert counts["ipv4_spans"] == tokens and counts["geo_lookup"] == groups
    cpu = cpu_parser.parse_batch(lines)
    assert gpu.to_dict() == cpu.to_dict()
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()


# ---------------------------------------------------------------------------
# The aggregate pushdown: agg_lanes, agg_reduce, agg_group.
# ---------------------------------------------------------------------------

QUERY_KEY_OPS = [{"op": "count_by", "field": "STRING:request.firstline.uri.query.q"},
                 {"op": "count_by", "field": "HTTP.PATH:request.firstline.uri.path"},
                 {"op": "sum", "field": "HTTP.PORT:request.referer.port"}]


def _agg_case(name, device):
    """(parser, spec, lines) of one aggregate case."""
    if name == "uri_query_key":
        parser = TorchBatchParser("combined", URI_CHAIN_FIELDS, device=device)
        lines = generate_combined_lines(3000, seed=53) + uri_edge_lines()
        return parser, AggregateSpec.parse(QUERY_KEY_OPS), lines + aggregate_edge_lines()
    parser = TorchBatchParser("combined", HEADLINE_FIELDS, device=device)
    spec = (AggregateSpec.parse(DASHBOARD_OPS) if name == "dashboard"
            else representative_spec(parser))
    lines = generate_combined_lines(5000, seed=42, garbage_fraction=0.01)
    return parser, spec, lines + aggregate_edge_lines() + EDGE_LINES


def _canonical_groups(groups, n, buf, spans):
    """{raw key bytes or bucket: count}; a key seen twice fails."""
    out = {}
    for row in groups[:int(n[0])].cpu().tolist():
        if spans:
            cnt, r, s, ln = row
            key = bytes(buf[r, s:s + ln].cpu().numpy())
        else:
            key, cnt = row
        assert key not in out, f"group {key!r} split"
        out[key] = cnt
    return out


@pytest.mark.parametrize("name", ["dashboard", "representative", "uri_query_key"])
@pytest.mark.parametrize("line_len", [0, 8191])
def test_agg_kernels_equal_plain_versions(cuda_device, name, line_len):
    parser, spec, lines = _agg_case(name, cuda_device)
    ex = parser._agg_executor(spec)
    buf, lengths, overflow = encode_batch(lines, line_len=line_len)
    kill = np.zeros(len(lines), dtype=np.uint8)
    kill[overflow] = 1
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    kill = torch.from_numpy(kill).to(cuda_device)
    packed = ex.units(buf, lengths)
    n_rows = len(lines) - 7          # the last rows are padding
    t = ex.tables
    cls, lanes = kernels.agg_lanes(t, packed, buf, n_rows, kill)
    want = agg_device.agg_lanes_plain(t, packed, buf, n_rows, kill, torch.empty_like(cls),
                                      torch.empty_like(lanes))
    assert torch.equal(cls, want[0]) and torch.equal(lanes, want[1])
    counts, tiles = kernels.agg_reduce(t, cls, lanes)
    want = agg_device.agg_reduce_plain(t, cls, lanes, torch.empty_like(counts),
                                       torch.empty_like(tiles))
    assert torch.equal(counts, want[0]) and torch.equal(tiles, want[1])
    for row, spans in t.groups_py:
        got = kernels.agg_group(lanes[row], buf, spans)
        ref = agg_device.agg_group_plain(lanes[row], buf, spans, torch.empty_like(got[0]),
                                         torch.empty_like(got[1]))
        a = _canonical_groups(*got, buf, spans)
        assert a == _canonical_groups(*ref, buf, spans)
        assert int(got[1][0]) == len(a)


@pytest.mark.parametrize("B", [1, 31, 4097])
def test_agg_group_kernel_on_seeded_lanes(cuda_device, B):
    rng = np.random.default_rng(B)
    buf = torch.from_numpy(rng.integers(0, 4, size=(B, 64), dtype=np.uint8)).to(cuda_device)
    starts = rng.integers(0, 8, size=B)
    lens = rng.integers(0, 5, size=B)
    word = np.where(rng.random(B) < 0.2, -1, starts | (lens << 13)).astype(np.int32)
    ints = np.where(rng.random(B) < 0.2, agg_device.INT32_MAX,
                    rng.integers(-3, 3, size=B)).astype(np.int32)
    for lane, spans in ((word, True), (ints, False)):
        lane = torch.from_numpy(lane).to(cuda_device)
        got = kernels.agg_group(lane, buf, spans)
        ref = agg_device.agg_group_plain(lane, buf, spans, torch.empty_like(got[0]),
                                         torch.empty_like(got[1]))
        a = _canonical_groups(*got, buf, spans)
        assert a == _canonical_groups(*ref, buf, spans)
        assert sum(a.values()) == int((lane != (-1 if spans else agg_device.INT32_MAX)).sum())


@pytest.mark.parametrize("selected", ["some", "none", "all"])
@pytest.mark.parametrize("B", SEEDED_B)
def test_agg_reduce_kernel_on_seeded_lanes(cuda_device, B, selected):
    """The 8-block clusters against the plain version: tiles around and
    past 4,096 rows, limbs at 0xFFFF / 0x10000 / 999,999, no row or every
    row selected, a histogram with an always-edge and one with 8 edges."""
    t, cls, lanes = seeded_reduce_case(B, seed=B, selected=selected)
    t = t.to(cuda_device)
    cls, lanes = cls.to(cuda_device), lanes.to(cuda_device)
    counts, tiles = kernels.agg_reduce(t, cls, lanes)
    want = agg_device.agg_reduce_plain(t, cls, lanes, torch.empty_like(counts),
                                       torch.empty_like(tiles))
    assert torch.equal(counts, want[0]) and torch.equal(tiles, want[1])
    again = kernels.agg_reduce(t, cls, lanes)   # counts zeroed on every call
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])


@pytest.mark.parametrize("name", ["dashboard", "representative", "uri_query_key"])
def test_aggregate_batch_on_the_card_equals_the_cpu(cuda_device, name):
    gpu_parser, spec, lines = _agg_case(name, cuda_device)
    cpu_parser, _, _ = _agg_case(name, "cpu")
    kernels.reset_launch_counts()
    gpu = gpu_parser.aggregate_batch(lines, spec)
    counts = kernels.launch_counts()
    assert counts["agg_lanes"] == 1 and counts["agg_reduce"] == 1
    assert counts["agg_group"] == len(gpu_parser._agg_executor(spec).tables.groups_py)
    cpu = cpu_parser.aggregate_batch(lines, spec)
    assert gpu.state == cpu.state
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()
    assert (gpu.device_rows, gpu.fold_rows) == (cpu.device_rows, cpu.fold_rows)
    # Partials only: far under the packed rows (the dashboard's groups are
    # few; the near-unique client IP ships one group a line).
    assert gpu.d2h_bytes * (10 if name == "dashboard" else 1) <= gpu.row_path_d2h_bytes


def _cookie_parser(device, slots=16):
    return _grown(TorchBatchParser(COOKIE_FORMAT, COOKIE_FIELDS, device=device,
                                   type_remappings=COOKIE_REMAPPINGS), slots)


@pytest.mark.parametrize("line_len,slots", [(0, 16), (0, 128), (8191, 32)])
def test_cookie_kernels_equal_plain_versions(cuda_device, line_len, slots):
    """setcookie_split, csr_split in cookie mode and muid, one group at a
    time, on the same input block as their plain versions."""
    ex = _cookie_parser(cuda_device, slots).executor
    (t,) = ex.unit_tables
    buf, lengths, _ = encode_batch(cookie_lines(3000, seed=51) + cookie_edge_lines(),
                                   line_len=line_len)
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    starts, ends, _ = kernels.split(t.split, buf, lengths)
    base = torch.zeros((t.n_comp, buf.shape[0]), dtype=torch.int32, device=cuda_device)
    for c in t.csr:
        got, want = base.clone(), base.clone()
        if c.mode == "setcookie":
            kernels.setcookie_split(c, buf, starts, ends, got)
            pipeline.setcookie_split_plain(c, buf, starts, ends, want)
        else:
            kernels.csr_split(c, buf, got, starts, ends)
            pipeline.csr_split_plain(c, buf, want, starts, ends)
        assert torch.equal(got, want), c.mode
    (m,) = t.muid
    got = kernels.muid(m, buf, starts, ends)
    assert torch.equal(got, pipeline.muid_plain(m, buf, starts, ends, torch.empty_like(got)))
    packed = ex(buf, lengths)
    cpu = _cookie_parser("cpu", slots).executor
    assert torch.equal(packed.cpu(), cpu(buf.cpu(), lengths.cpu()))


def test_split_on_a_nul_separated_format(cuda_device):
    """NUL separator bytes, lines ending in NULs, zero padding past each
    line: the split kernel equals its plain version."""
    rng = np.random.default_rng(6)
    alphabet = np.frombuffer(b"\x00\x00\x00ab1. -", dtype=np.uint8)
    lines = [b"1.2.3.4\x00bob\x00200", b"1.2.3.4\x00bob\x00200\x00", b"\x00\x00", b""]
    lines += [bytes(rng.choice(alphabet, size=int(rng.integers(0, 60))))
              for _ in range(3000)]
    fields = ["IP:connection.client.host", "STRING:connection.client.user",
              "STRING:request.status.last"]
    for fmt in ("%h\x00%u\x00%>s", "%h\x00\x00%u %>s\x00"):
        (t,) = TorchBatchParser(fmt, fields, device=cuda_device).executor.unit_tables
        for line_len in (0, 1024):
            buf, lengths, _ = encode_batch(lines, line_len=line_len)
            buf = torch.from_numpy(buf).to(cuda_device)
            lengths = torch.from_numpy(lengths).to(cuda_device)
            got = kernels.split(t.split, buf, lengths)
            want = pipeline.compute_split(t.split.program, buf, lengths)
            for g, w in zip(got, want):
                assert torch.equal(g, w), fmt


NUL_FIELDS = ["IP:connection.client.host", "STRING:connection.client.user",
              "STRING:request.status.last"]


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("L", SPLIT_WIDTHS)
def test_split_kernel_on_seeded_buffers(cuda_device, L, offset):
    """Every line width from 1 to 8,191 (odd ones too: the staged line's
    head and tail outside the 16-byte-aligned bulk copy), backslash runs
    that end before a quote across word and 32-word boundaries, lengths 0,
    L and between, a separator longer than a plane word and a
    NUL-separated program.  ``offset`` starts the buffer that many bytes
    past an allocation, so no line starts on 16 bytes."""
    for fmt, fields, nul in (("combined", FIELDS, False), (LONG_SEP, FIELDS, False),
                             ("%h\x00%u\x00%>s", NUL_FIELDS, True)):
        buf, lengths = seeded_split_case(1500, L, seed=L, nul=nul)
        flat = torch.zeros(buf.size + offset, dtype=torch.uint8, device=cuda_device)
        dbuf = flat[offset:].view(buf.shape)
        dbuf.copy_(torch.from_numpy(buf))
        dlen = torch.from_numpy(lengths).to(cuda_device)
        for t in TorchBatchParser(fmt, fields, device=cuda_device).executor.unit_tables:
            got = kernels.split(t.split, dbuf, dlen)
            want = pipeline.compute_split(t.split.program, dbuf, dlen)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (fmt, L, offset)


def _csr_group(mode, slots, device):
    """The CSR group of ``mode`` ("cookie": the cookies parser's Cookie
    header, "query": the URI chain's first query string) at ``slots``."""
    if mode == "cookie":
        (t,) = _cookie_parser(device, slots).executor.unit_tables
    else:
        (t,) = _grown(TorchBatchParser("combined", URI_CHAIN_FIELDS, device=device),
                      slots).executor.unit_tables
    return next(c for c in t.csr if c.mode == mode)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("L,slots", [(2048, 16), (2048, 128), (384, 16), (384, 64),
                                     (384, 128), (1024, 128), (130, 16), (8191, 32)])
@pytest.mark.parametrize("mode", ["cookie", "query"])
def test_csr_split_kernel_on_seeded_spans(cuda_device, mode, L, slots, offset):
    """csr_split against its plain version on the seeded edge cases
    (tools.kernel_ab.seeded_csr_case: separators split by the window's
    end, ';' runs, '=' first and last, empty segments, escape and high
    bytes, spans of exactly 8 * slots bytes and one more, a lone '-', a
    leading '?', spans past L, spans of 64 and 65 bytes), the spans as
    token cursors (cookie mode) or as the query's component rows with a
    random ok row (query mode), the block's other rows random.  Both of the
    kernel's paths run: the case holds 32-line tiles of spans of at most 64
    bytes (a thread a line) and tiles of longer ones (a warp a line).
    ``offset`` starts the buffer that many bytes past an allocation.  Exact
    equality."""
    from logparser_tpu_torch.tools.kernel_ab import csr_tile_kinds, seeded_csr_case

    c = _csr_group(mode, slots, cuda_device)
    assert c.slots == slots
    buf, s, e = seeded_csr_case(2000, L, slots, mode, seed=L + slots)
    n_short, n_long = csr_tile_kinds(s, e)
    assert n_short >= 30 and n_long >= 30
    B = buf.shape[0]
    flat = torch.zeros(buf.size + offset, dtype=torch.uint8, device=cuda_device)
    dbuf = flat[offset:].view(buf.shape)
    dbuf.copy_(torch.from_numpy(buf))
    rng = np.random.default_rng(L + slots)
    n_rows = max(c.words + 2 * c.slots, c.ok, c.over, *c.src) + 1
    base = torch.from_numpy(rng.integers(-9, 9, size=(n_rows, B), dtype=np.int32))
    ds, de = torch.from_numpy(s), torch.from_numpy(e)
    cursors = ()
    if c.src[0] < 0:
        starts = torch.zeros((c.token_index + 1, B), dtype=torch.int32)
        ends = torch.zeros_like(starts)
        starts[c.token_index], ends[c.token_index] = ds, de
        cursors = (starts.to(cuda_device), ends.to(cuda_device))
    else:
        base[c.src[0]], base[c.src[1]] = ds, de - ds
        base[c.src[2]] = torch.from_numpy((rng.random(B) < 0.9).astype(np.int32))
    base = base.to(cuda_device)
    got = kernels.csr_split(c, dbuf, base.clone(), *cursors)
    want = pipeline.csr_split_plain(c, dbuf, base.clone(), *cursors)
    assert torch.equal(got, want)
    assert got[c.over].any() and (got[c.ok] != 0).any()


def _offset_buffer(buf, offset, device):
    """buf on the card, ``offset`` bytes past an allocation."""
    flat = torch.zeros(buf.size + offset, dtype=torch.uint8, device=device)
    dbuf = flat[offset:].view(buf.shape)
    dbuf.copy_(torch.from_numpy(buf))
    return dbuf


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("slots", [16, 128])
@pytest.mark.parametrize("L", [384, 2048, 8191])
def test_uri_split_kernel_on_seeded_spans(cuda_device, L, slots, offset):
    """uri_split against its plain version on the seeded edge cases
    (tools.kernel_ab.seeded_uri_case: '@' and ':' in userinfo and port,
    19- and 20-digit ports, [::1], mailto:, a +.- scheme, '-', '%' and '%X'
    at the window's end, spans the window cuts, across 16-byte boundaries
    and past L), both URI groups of the URI chain (the first line's rows
    with a random ok row, the referer's token), windowed or not as the
    slots make the window.  Every tile kind the window allows runs: tiles
    whose frames are all staged in shared memory, tiles with none staged
    (longer than the staged runs), mixed tiles; a window of at most 241
    bytes stages every frame, and there the window's clamp runs (spans
    past L).  ``offset`` starts
    the buffer that many bytes past an allocation.  Exact equality."""
    from logparser_tpu_torch.tools.kernel_ab import (seeded_uri_case, uri_byte_walks,
                                                     uri_clamped, uri_tile_kinds)

    (t,) = _grown(TorchBatchParser("combined", URI_CHAIN_FIELDS, device=cuda_device),
                  slots).executor.unit_tables
    rng = np.random.default_rng(L + slots)
    for u in t.uri:
        buf, s, e = seeded_uri_case(2000, L, u.window, seed=L + slots)
        kinds = uri_tile_kinds(s, e, L, u.window, offset)
        if u.window < L and u.window <= 241:   # every frame staged, some clamped
            assert uri_byte_walks(s, e, L, u.window, offset) == 0
            assert kinds[0] >= 3 and uri_clamped(s, e, L, u.window).sum() >= 32
        else:
            assert min(kinds) >= 3 and uri_byte_walks(s, e, L, u.window, offset) >= 32
        B = buf.shape[0]
        dbuf = _offset_buffer(buf, offset, cuda_device)
        base = torch.from_numpy(rng.integers(-9, 9, size=(t.n_comp, B), dtype=np.int32))
        starts = torch.zeros((u.token_index + 1, B), dtype=torch.int32)
        ends = torch.zeros_like(starts)
        starts[u.token_index], ends[u.token_index] = torch.from_numpy(s), torch.from_numpy(e)
        if u.src[0] >= 0:
            base[u.src[0]], base[u.src[1]] = torch.from_numpy(s), torch.from_numpy(e - s)
            base[u.src[2]] = torch.from_numpy((rng.random(B) < 0.9).astype(np.int32))
        starts, ends, base = starts.to(cuda_device), ends.to(cuda_device), base.to(cuda_device)
        got = kernels.uri_split(u, dbuf, starts, ends, base.clone())
        want = pipeline.uri_split_plain(u, dbuf, starts, ends, base.clone())
        assert torch.equal(got, want), u.src
        assert got[u.over].any() == (u.window < L)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("slots", [16, 128])
@pytest.mark.parametrize("L", [384, 2048, 8191])
def test_setcookie_split_kernel_on_seeded_spans(cuda_device, L, slots, offset):
    """setcookie_split against its plain version on the seeded edge cases
    (tools.kernel_ab.seeded_setcookie_case: expires= 14 and 15 bytes
    before a part's end, a double hold, a held last part, SeT-CoOkIe
    prefixes, one read past the span, a ", " as the last two bytes, more
    parts than slots, a ", " and an expires= across a staged run's end,
    spans past L), the cookies parser's Set-Cookie group at ``slots``, the
    block's rows random.  Every tile kind runs: tiles with no byte to walk,
    tiles walked in one 128-byte round, tiles walked in more rounds.
    ``offset`` starts the buffer that many bytes past an allocation.  Exact
    equality."""
    from logparser_tpu_torch.tools.kernel_ab import (seeded_setcookie_case,
                                                     setcookie_tile_kinds)

    (t,) = _cookie_parser(cuda_device, slots).executor.unit_tables
    (c,) = [c for c in t.csr if c.mode == "setcookie"]
    assert c.slots == slots
    buf, s, e = seeded_setcookie_case(2000, L, slots, seed=L + slots)
    kinds = setcookie_tile_kinds(s, e, L, offset)
    assert min(kinds) >= 3
    B = buf.shape[0]
    dbuf = _offset_buffer(buf, offset, cuda_device)
    rng = np.random.default_rng(L + slots)
    base = torch.from_numpy(rng.integers(-9, 9, size=(t.n_comp, B), dtype=np.int32))
    starts = torch.zeros((c.token_index + 1, B), dtype=torch.int32)
    ends = torch.zeros_like(starts)
    starts[c.token_index], ends[c.token_index] = torch.from_numpy(s), torch.from_numpy(e)
    starts, ends, base = starts.to(cuda_device), ends.to(cuda_device), base.to(cuda_device)
    got = kernels.setcookie_split(c, dbuf, starts, ends, base.clone())
    want = pipeline.setcookie_split_plain(c, dbuf, starts, ends, base.clone())
    assert torch.equal(got, want)
    assert got[c.bad].any() and got[c.over].any() and (got[c.ok] == 0).any()


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("B,L", [(4095, 384), (4097, 384), (65547, 384), (4097, 64),
                                 (4097, 2048)])
def test_span_stages_kernel_on_seeded_spans(cuda_device, B, L, offset):
    """span_stages against its plain version on the seeded edge cases
    (tools.kernel_ab.seeded_span_case under seeded_stage_tables: every
    span part with prefix words, plain, CLF and zero_null longs and a
    secmillis task on a crafted token, a second first line on a random
    token; request lines with no or one space, bad versions, past 128
    bytes and past L; starts with bits above the gather mask; longs of 0,
    19, 20 and 25 digits).  ``offset`` starts the buffer that many bytes
    past an allocation.  Exact equality."""
    from logparser_tpu_torch.tools.kernel_ab import seeded_span_case, seeded_stage_tables

    buf, s, e = seeded_span_case(B, L, seed=B + L)
    stages = seeded_stage_tables(pipeline).to(cuda_device)
    dbuf = _offset_buffer(buf, offset, cuda_device)
    starts, ends = torch.from_numpy(s).to(cuda_device), torch.from_numpy(e).to(cuda_device)
    got = kernels.span_stages(stages, dbuf, starts, ends)
    want = pipeline.span_stages_plain(stages, dbuf, starts, ends, torch.empty_like(got))
    assert torch.equal(got, want)
    protocol_ok = [t[6] for t in stages.tasks_py if t[:3] == (pipeline.TASK_SPAN, 0, 3)]
    assert got[protocol_ok[0]].any() and not got[protocol_ok[0]].all()


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("B", [4095, 4097, 65547])
def test_pack_rows_kernel_on_seeded_lines(cuda_device, B, offset):
    """pack_rows against its plain version on the seeded lines of eight
    formats (tools.kernel_ab.seeded_pack_case: MAX_UNITS units, every
    line-constraint kind, contested lines, view fields that seven units
    decode), on the flags and components the executor computes on the
    card.  ``offset`` starts the components that many words past an
    allocation.  Exact equality."""
    from logparser_tpu_torch.tools.kernel_ab import (SEEDED_PACK_FIELDS, SEEDED_PACK_FORMAT,
                                                     contested_lines, seeded_pack_case)

    ex = TorchBatchParser(SEEDED_PACK_FORMAT, SEEDED_PACK_FIELDS, device=cuda_device).executor
    buf, lengths, _ = encode_batch(seeded_pack_case(B, seed=B))
    flags, comps = ex.components(torch.from_numpy(buf).to(cuda_device),
                                 torch.from_numpy(lengths).to(cuda_device))
    flat = torch.zeros(comps.numel() + offset, dtype=torch.int32, device=cuda_device)
    shifted = flat[offset:].view(comps.shape)
    shifted.copy_(comps)
    got = kernels.pack_rows(ex.pack, flags, shifted)
    want = pipeline.pack_rows_plain(ex.pack, flags, comps)
    assert torch.equal(got, want)
    assert ex.pack.U == pipeline.MAX_UNITS and contested_lines(want.cpu().numpy(), ex.pack) > 0


def test_geo_two_token_parse_on_the_card_equals_the_cpu(cuda_device):
    """City and ASN over two IP tokens: one ipv4_spans launch a token."""
    from logparser_tpu_torch.geoip import GeoIPASNDissector, GeoIPCityDissector
    from logparser_tpu_torch.tools import geoip_testdata

    fixtures = geoip_testdata.ensure_test_databases()
    parsers = [TorchBatchParser(GEOIP_TWO_TOKEN_FORMAT, GEOIP_TWO_TOKEN_FIELDS, device=d,
                                extra_dissectors=[
                                    GeoIPCityDissector(f"{fixtures}/GeoIP2-City-Test.mmdb"),
                                    GeoIPASNDissector(f"{fixtures}/GeoLite2-ASN-Test.mmdb")])
               for d in (cuda_device, "cpu")]
    lines = geoip_two_token_lines(3000)
    kernels.reset_launch_counts()
    gpu = parsers[0].parse_batch(lines)
    counts = kernels.launch_counts()
    assert counts["ipv4_spans"] == 2 and counts["geo_lookup"] == 4
    cpu = parsers[1].parse_batch(lines)
    assert gpu.to_dict() == cpu.to_dict()
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("B,L", [(4095, 64), (4097, 384), (65547, 2048), (4097, 100)])
def test_muid_kernel_on_seeded_tokens(cuda_device, B, L, offset):
    """muid against its plain version on the seeded edge cases
    (tools.kernel_ab.seeded_muid_case: a byte outside the alphabet at each
    of the 24 positions, widths 0, 23, 24 and 25, tokens running past L,
    starts past L and above the gather mask, rows of random bytes), read
    as aligned chunks and a byte at a time.  ``offset`` starts the buffer
    that many bytes past an allocation.  Exact equality."""
    buf, s, e = seeded_muid_case(B, L, seed=B + L)
    inside = window_inside(s, L, 24)
    assert inside.any() and not inside.all()
    dbuf = _offset_buffer(buf, offset, cuda_device)
    starts = torch.from_numpy(s)[None].to(cuda_device)
    ends = torch.from_numpy(e)[None].to(cuda_device)
    m = pipeline.MuidTables(pipeline._MuidGroup("seeded", 0, 0))
    got = kernels.muid(m, dbuf, starts, ends)
    want = pipeline.muid_plain(m, dbuf, starts, ends, torch.empty_like(got))
    assert torch.equal(got, want)
    assert got[5].any() and not got[5].all()


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("B,L", [(4095, 64), (4097, 384), (65547, 384), (4097, 2048)])
def test_ipv4_spans_kernel_on_seeded_spans(cuda_device, B, L, offset):
    """ipv4_spans against its plain version on the seeded edge cases
    (tools.kernel_ab.seeded_ipv4_case over two tokens: leading zeros,
    octets past 255, uint32 wraps, empty octets, ':' inside and past the
    span, every width 0 to 16, spans past L, starts above the gather
    mask).  ``offset`` starts the buffer that many bytes past an
    allocation.  Exact equality, the value row of rejected spans too."""
    buf, s, e = seeded_ipv4_case(B, L, seed=B + L)
    dbuf = _offset_buffer(buf, offset, cuda_device)
    starts, ends = torch.from_numpy(s).to(cuda_device), torch.from_numpy(e).to(cuda_device)
    for tok in (0, 1):
        ip = pipeline.IpTables(tok, 0)
        got = kernels.ipv4_spans(ip, dbuf, starts, ends)
        want = pipeline.ipv4_spans_plain(ip, dbuf, starts, ends, torch.empty_like(got))
        assert torch.equal(got, want)
        if tok == 0:
            assert got[1].any() and got[2].any() and not got[1].all()


def test_cookie_parse_on_the_card_equals_the_cpu(cuda_device):
    lines = cookie_lines(4000, seed=52) + cookie_edge_lines()
    kernels.reset_launch_counts()
    gpu_p = _cookie_parser(None)
    gpu = gpu_p.parse_batch(lines)
    counts = kernels.launch_counts()
    assert counts["setcookie_split"] >= 1 and counts["muid"] >= 1
    assert counts["csr_split"] >= 1 and gpu.csr_regrows == 3
    cpu = _cookie_parser("cpu").parse_batch(lines)
    assert gpu.to_dict() == cpu.to_dict()
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()
    assert gpu.to_arrow(strings="copy").equals(cpu.to_arrow(strings="copy"))


UNESCAPE_CASES = [b'esc \\" quote', b"a\\\\b", b'a\\\\\\"b', b'run\\\\\\\\\\"x',
                  b'\\" \\" \\"', b"plain", b"tail\\\\", b"a\\qb", b"odd\\", b"a\\nb",
                  b"\\x41z"]


@pytest.mark.parametrize("L,width", [(64, 32), (64, 64), (384, 400), (8191, 300)])
def test_unescape_kernel_equals_plain_version(cuda_device, L, width):
    """Random backslash / quote / escape-letter bytes, starts and ends
    past both edges (start bits above bit_length(L - 1) included), and
    the fuzz cases: out, out_len and exact equal the plain version."""
    from logparser_tpu_torch.tpu import postproc

    rng = np.random.default_rng(L + width)
    alpha = np.frombuffer(b'\\\\\\"abnrtvxq ', dtype=np.uint8)
    B = 5000
    buf = alpha[rng.integers(0, len(alpha), (B, L))].astype(np.uint8)
    start = rng.integers(-5, L + 3, B).astype(np.int32)
    end = (start + rng.integers(-3, min(L, 2 * width) + 5, B)).astype(np.int32)
    start[:3] += np.int32(1 << 20)
    for i, c in enumerate(UNESCAPE_CASES):
        buf[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
        start[i], end[i] = 0, len(c)
    args = [torch.from_numpy(a).to(cuda_device) for a in (buf, start, end)]
    before = kernels.unescape.launches
    got = postproc.unescape_compact_spans(*args, width)
    assert kernels.unescape.launches == before + 1
    want = postproc.unescape_compact_spans_plain(*args, width)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
def test_geo_gather_kernel_equals_plain_version(cuda_device, dtype):
    """Every row, negative rows down to -2N, rows up to 2N: the gather
    equals its plain version, in the column's dtype."""
    from logparser_tpu_torch.geoip.device import geo_gather_plain

    rng = np.random.default_rng(7)
    n = 131073
    col = (rng.standard_normal(n) * 1e3).astype(dtype)
    if dtype == np.int64:
        col[1::7] = np.int64(2) ** 40 + np.arange(len(col[1::7]))
    rows = np.concatenate([np.arange(n), rng.integers(-2 * n, 2 * n, 200000),
                           [-1, -n, -n - 1, n, n + 1, 2**31 - 1, -2**31]]).astype(np.int32)
    col_t = torch.from_numpy(col).to(cuda_device)
    rows_t = torch.from_numpy(rows).to(cuda_device)
    (got,) = kernels.geo_gather([col_t], rows_t)
    want = geo_gather_plain(col_t, rows_t)
    assert got.dtype == col_t.dtype and torch.equal(got, want)


def test_geo_gather_kernel_on_mixed_columns_and_unaligned_rows(cuda_device):
    """One launch for float32 (NaN included), int32 and int64 columns of
    one table, rows starting at offsets 0-3 of a 16-byte word (the scalar
    row loads) and B % 4 from 0 to 3 (the tail): each column bit for bit
    its plain version, in its dtype; more columns than a table has raise."""
    from logparser_tpu_torch.geoip.device import geo_gather_plain

    rng = np.random.default_rng(8)
    n = 131073
    f = rng.standard_normal(n).astype(np.float32)
    f[::5] = np.nan
    cols = [torch.from_numpy(c).to(cuda_device) for c in (
        f, rng.integers(-2**31, 2**31, n, dtype=np.int32),
        rng.integers(-2**62, 2**62, n, dtype=np.int64), f[::-1].copy())]
    big = torch.from_numpy(np.concatenate([
        rng.integers(-2 * n, 2 * n, 70000), [-1, -n, -n - 1, n, n + 1, 2**31 - 1, -2**31],
    ]).astype(np.int32)).to(cuda_device)
    for offset in range(4):
        for B in (0, 1, 2, 3, 5, 4097, 70003 - offset):
            rows = big[offset:offset + B]
            before = kernels.geo_gather.launches
            got = kernels.geo_gather(cols, rows)
            assert kernels.geo_gather.launches == before + (1 if B else 0)
            for g, c in zip(got, cols):
                w = geo_gather_plain(c, rows)
                assert g.dtype == c.dtype and g.shape == (B,)
                bits = torch.int32 if c.dtype == torch.float32 else c.dtype
                assert torch.equal(g.view(bits), w.view(bits)), (offset, B, c.dtype)
    with pytest.raises(ValueError, match="columns"):
        kernels.geo_gather(cols * 4, big)


def test_new_entry_points_on_the_card_equal_the_cpu(cuda_device):
    """run_program, parse_blob, parse_batch_stream (a mid-stream regrow,
    staged and not) and aggregate_batch_stream(depth=2) on the card equal
    the same calls on the CPU."""
    from logparser_tpu_torch.tpu import runtime

    lines = _uri_lines()
    parser = TorchBatchParser("combined", URI_CHAIN_FIELDS, device=cuda_device)
    (t,) = parser.executor.unit_tables
    buf, lengths, _ = encode_batch(lines)
    got = runtime.run_program(t.split.program, buf, lengths)
    want = runtime.run_program(t.split.program, buf, lengths, device="cpu")
    for k in ("starts", "ends", "valid"):
        assert torch.equal(got[k].cpu(), want[k]), k
    blob = ("\r\n".join(lines[:2000]) + "\n").encode()
    cpu = TorchBatchParser("combined", URI_CHAIN_FIELDS, device="cpu")
    res = parser.parse_blob(blob)
    assert res.framer == "native"
    ref = cpu.parse_blob(blob)
    assert res.to_dict() == ref.to_dict() and res.needs_host.tolist() == ref.needs_host.tolist()
    batches = [generate_combined_lines(1500, seed=s) for s in (1, 2)] + [lines[:3000]] \
        + [generate_combined_lines(1500, seed=3)]
    for depth, stage in ((1, True), (2, False)):
        gpu = TorchBatchParser("combined", URI_CHAIN_FIELDS, device=cuda_device)
        for b, r in zip(batches, gpu.parse_batch_stream(batches, depth=depth,
                                                        stage_h2d=stage)):
            w = cpu.parse_batch(b)
            assert r.to_dict() == w.to_dict()
            assert r.needs_host.tolist() == w.needs_host.tolist()
    gpu = TorchBatchParser("combined", HEADLINE_FIELDS, device=cuda_device)
    head = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    agg = [generate_combined_lines(2000, seed=s, garbage_fraction=0.02)
           + aggregate_edge_lines() for s in (8, 9, 10)]
    for b, out in zip(agg, gpu.aggregate_batch_stream(agg, DASHBOARD_OPS, depth=2)):
        assert out.state == head.aggregate_batch(b, DASHBOARD_OPS).state


@pytest.mark.parametrize("fmt,L,shape", [
    ("combined", 384, (2, 4)),
    ("combined", 16384, (1, 4)),
    ("%h - %u - %{Referer}i", 64, (1, 4)),
    ("[[[[[[[[[[%h] %u %>s", 64, (1, 8)),
    ("%h\x00%u\x00%>s", 64, (2, 4)),
])
def test_sp_split_kernel_equals_plain_version(cuda_device, monkeypatch, fmt, L, shape):
    """The SP runner with every shard on one card: one sp_program launch
    per data shard, equal to the per-op path (sp_split per op and seq
    shard), to both over their plain versions on the card, and to the
    CPU; then sp_program alone on rows that start off 16 bytes and are
    strided, with lengths past L (the last shard's halo wraps to shard
    0), against its plain version.  Exact equality."""
    from logparser_tpu_torch.httpd.apache import ApacheLogFormat
    from logparser_tpu_torch.parallel import mesh
    from logparser_tpu_torch.tools.demolog import long_combined_lines
    from logparser_tpu_torch.tpu.program import compile_device_program

    if fmt == "combined":
        lines = (long_combined_lines(64, seed=63, max_len=L - 1) if L > 8191
                 else _lines()[:3000] + EDGE_LINES[:8])
    else:
        rng = np.random.default_rng(L)
        alphabet = list(" -[]\x00ab12") if "\x00" in fmt else list(" -[]ab12")
        lines = ["".join(rng.choice(alphabet, size=int(rng.integers(0, L))))
                 for _ in range(400)]
        lines += ["a - b - c", "[[[[[[[[[[1.2.3.4] u 200", "1.2.3.4\x00u\x00200"] * 8
    buf, lengths, overflow = encode_batch(lines[:len(lines) // 8 * 8], line_len=L)
    assert not overflow
    prog = compile_device_program(ApacheLogFormat(fmt))
    m = mesh.make_mesh(*shape, devices=[cuda_device] * 8)
    run = mesh.sequence_parallel_runner(prog, m, L)
    per_op = mesh._sp_runner(prog, m, L, one_launch=False)
    kernels.reset_launch_counts()
    got = run(buf, lengths)
    counts = kernels.launch_counts()
    assert counts["sp_program"] == shape[0] and counts["sp_split"] == 0
    kernels.reset_launch_counts()
    op_path = per_op(buf, lengths)
    counts = kernels.launch_counts()
    assert counts["sp_split"] >= shape[0] * shape[1] and counts["sp_program"] == 0
    monkeypatch.setattr(kernels, "sp_program", mesh.sp_program_plain)
    monkeypatch.setattr(kernels, "sp_split", mesh.sp_split_step_plain)
    want = run(buf, lengths)
    want_op = per_op(buf, lengths)
    cpu = mesh.sequence_parallel_runner(prog, mesh.make_mesh(*shape, devices=["cpu"] * 8),
                                        L)(buf, lengths)
    for k in ("valid", "starts", "ends"):
        for other in (op_path, want, want_op):
            assert torch.equal(got[k], other[k]), k
        assert torch.equal(got[k].cpu(), cpu[k]), k
    monkeypatch.undo()
    B = buf.shape[0]
    flat = torch.zeros(B * (L + 3) + 5, dtype=torch.uint8, device=cuda_device)
    rows = flat[5:5 + B * (L + 3)].view(B, L + 3)[:, :L]
    rows.copy_(torch.from_numpy(buf))
    dlen = torch.from_numpy(lengths).to(cuda_device)
    dlen[::7] = L + 3
    tables = mesh.sp_tables(prog, rows.device)
    before = kernels.sp_program.launches
    got = kernels.sp_program(tables, rows, dlen, shape[1])
    assert kernels.sp_program.launches == before + 1
    want = mesh.sp_program_plain(tables, rows, dlen, shape[1])
    for k in ("valid", "starts", "ends"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("layout", ["seq_on_distinct_cards", "mixed"])
@pytest.mark.parametrize("fmt,L", [("combined", 384), ("%h - %u - %{Referer}i", 64)])
def test_sp_runner_on_distinct_cards_equals_one_card(cuda_device, layout, fmt, L):
    """The SP runner on a mesh of distinct cards (two or more): seq shards
    on distinct cards take the per-op path (sp_split per op and seq
    shard, the combines on the data shard's first card), a data shard
    whose seq shards share a card one sp_program launch ("mixed": data
    shard 0 on card 0, data shard 1 across cards 1 and 2).  Equal to the
    same mesh on one card and to the CPU.  Exact equality."""
    from logparser_tpu_torch.httpd.apache import ApacheLogFormat
    from logparser_tpu_torch.parallel import mesh
    from logparser_tpu_torch.tpu.program import compile_device_program

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more CUDA cards")
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    if layout == "mixed":
        shape, devices = (2, 2), [cards[0], cards[0], cards[1], cards[2 % n_cards]]
    else:
        n_seq = 4 if n_cards >= 4 else 2
        shape, devices = (1, n_seq), cards[:n_seq]
    if fmt == "combined":
        lines = _lines()[:3000] + EDGE_LINES[:8]
    else:
        rng = np.random.default_rng(L)
        lines = ["".join(rng.choice(list(" -[]ab12"), size=int(rng.integers(0, L))))
                 for _ in range(400)] + ["a - b - c"] * 8
    buf, lengths, overflow = encode_batch(lines[:len(lines) // 8 * 8], line_len=L)
    assert not overflow
    prog = compile_device_program(ApacheLogFormat(fmt))
    run = mesh.sequence_parallel_runner(prog, mesh.make_mesh(*shape, devices=devices), L)
    kernels.reset_launch_counts()
    got = run(buf, lengths)
    counts = kernels.launch_counts()
    n_steps = sum(2 if op.kind == "until_lit" else 1 for op in prog.ops)
    if layout == "mixed":
        assert counts["sp_program"] == 1 and counts["sp_split"] == 2 * n_steps
    else:
        assert counts["sp_program"] == 0 and counts["sp_split"] == shape[1] * n_steps
    one = mesh.sequence_parallel_runner(
        prog, mesh.make_mesh(*shape, devices=[cuda_device] * 4), L)(buf, lengths)
    cpu = mesh.sequence_parallel_runner(
        prog, mesh.make_mesh(*shape, devices=["cpu"] * 4), L)(buf, lengths)
    for k in ("valid", "starts", "ends"):
        assert got[k].device == devices[0]
        assert torch.equal(got[k], one[k].to(devices[0])), k
        assert torch.equal(got[k].cpu(), cpu[k]), k


@pytest.mark.parametrize("B", [0, 1, 31, 100003])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
def test_counters_kernel_equals_plain_version(cuda_device, B, dtype):
    from logparser_tpu_torch.parallel import mesh

    rng = np.random.default_rng(B)
    good = torch.from_numpy(rng.random(B) < 0.7)
    bad = ~good
    if dtype is torch.int32:
        good = torch.from_numpy(rng.integers(-5, 1 << 20, size=B, dtype=np.int32))
        bad = torch.from_numpy(rng.integers(0, 3, size=B, dtype=np.int32))
    got = kernels.counters(good.to(cuda_device), bad.to(cuda_device))
    assert torch.equal(got.cpu(), mesh.counters_plain(good, bad))
    m = mesh.make_mesh(4, devices=[cuda_device] * 4)
    g, b = mesh.aggregate_counters(m, good, bad)
    assert (int(g), int(b)) == tuple(mesh.counters_plain(good, bad).tolist())
    # One launch for the 4 x 1 one-card mesh, on masks sliced at odd
    # offsets of larger ones (good and bad at different alignments).
    big_g = torch.cat([torch.ones(7, dtype=dtype), good, torch.ones(5, dtype=dtype)])
    big_b = torch.cat([torch.ones(3, dtype=dtype), bad, torch.ones(9, dtype=dtype)])
    big_g, big_b = big_g.to(cuda_device), big_b.to(cuda_device)
    dg, db = big_g[7:7 + B], big_b[3:3 + B]
    before = kernels.counters.launches
    g, b = mesh.aggregate_counters(m, dg, db)
    assert kernels.counters.launches == before + (1 if B else 0)
    assert g.dtype == torch.int32 and g.device == dg.device
    assert (int(g), int(b)) == tuple(mesh.counters_plain(good, bad).tolist())


def test_data_parallel_parser_on_the_card_equals_the_cpu(cuda_device, monkeypatch):
    """TorchBatchParser(data_parallel=4) with four shards on one card:
    parse_batch and the dashboard aggregate equal the CPU parser's."""
    from logparser_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cuda", 0)] * 4)
    gpu = TorchBatchParser("combined", HEADLINE_FIELDS, data_parallel=4)
    assert gpu.mesh_devices == 4
    cpu = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    lines = _lines()
    kernels.reset_launch_counts()
    res = gpu.parse_batch(lines)
    assert kernels.launch_counts()["split"] == 4
    ref = cpu.parse_batch(lines)
    assert res.to_dict() == ref.to_dict() and res.needs_host.tolist() == ref.needs_host.tolist()
    agg = lines + aggregate_edge_lines()
    assert gpu.aggregate_batch(agg, DASHBOARD_OPS).state == \
        cpu.aggregate_batch(agg, DASHBOARD_OPS).state


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("L", [64, 256, 384])
def test_timestamp_kernel_on_seeded_spans(cuda_device, L, offset):
    """timestamp against its plain version on tools.kernel_ab's seeded
    spans of every seeded layout (Apache's and strftime's %z on the
    register path; %Z, full month names, am/pm, day names and an ISO tail
    interpreted):
    mixed-case names, every %Z entry and its variants, bad digits, clock
    hour 24, leap seconds, Feb 29, +HHMM against +HH:MM, spans ending at or
    clipped by L, near a power-of-two bucket's end (the row-read path) and
    with their bits above the gather mask set.  ``offset`` starts the
    buffer that many bytes past an allocation.  Exact equality, the zone
    row too."""
    from logparser_tpu_torch.tools.kernel_ab import seeded_timestamp_case
    from logparser_tpu_torch.tpu import timeparse

    for name, layout, buf, s, e in seeded_timestamp_case(4099, L, seed=L + offset):
        dl = timeparse.compile_layout_for_device(layout)
        if max(dl.windows()) > L:
            continue
        ts = pipeline.TsTables(0, dl).to(cuda_device)
        dbuf = _offset_buffer(buf, offset, cuda_device)
        starts = torch.from_numpy(s)[None].to(cuda_device)
        ends = torch.from_numpy(e)[None].to(cuda_device)
        zone = ts.zone is not None
        z = torch.empty(len(s), dtype=torch.int32, device=cuda_device) if zone else None
        got = kernels.timestamp(ts, dbuf, starts, ends, zone_out=z)
        zw = torch.empty_like(z) if zone else None
        want = pipeline.timestamp_plain(ts, dbuf, starts, ends, torch.empty_like(got), zw)
        assert torch.equal(got, want), name
        assert not zone or torch.equal(z, zw), name
        assert got[3].any() and not got[3].all(), name


@pytest.mark.parametrize("B", [31, 4095, 65547])
@pytest.mark.parametrize("distinct", [1, 4, 24, 1000, None])
def test_agg_group_kernel_on_seeded_cases(cuda_device, B, distinct):
    """agg_group against its plain version on tools.kernel_ab's seeded
    lanes (span keys of equal length and equal first 16 bytes, keys that
    run past L, the empty key; int keys with INT32_MIN and INT32_MAX - 1),
    ``distinct`` keys or one a row: equal key -> count maps, n_groups the
    number of keys, no key split."""
    from logparser_tpu_torch.tools.kernel_ab import group_map, seeded_group_case

    for selected in ("some", "all", "none"):
        buf, span_lane, int_lane = seeded_group_case(B, distinct, seed=B, selected=selected)
        dbuf = torch.from_numpy(buf).to(cuda_device)
        for lane, spans in ((span_lane, True), (int_lane, False)):
            lane = torch.from_numpy(lane).to(cuda_device)
            got = kernels.agg_group(lane, dbuf, spans)
            want = agg_device.agg_group_plain(lane, dbuf, spans, torch.empty_like(got[0]),
                                              torch.empty(1, dtype=torch.int32,
                                                          device=cuda_device))
            a = group_map(*got, buf, spans)
            assert a == group_map(*want, buf, spans)
            assert int(got[1][0]) == len(a)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("B", [4095, 65547])
def test_agg_lanes_kernel_on_seeded_lines(cuda_device, B, offset):
    """agg_lanes against its plain version on tools.kernel_ab's seeded
    lines (eight formats with contested lines, 16 lanes: a query key,
    every null mode, byte counts of 0 to 20 digits, times at the 1902-2037
    window's edges with +-14 h offsets; host_kill rows, CSR overflows,
    rows past n_rows), every row kind present; then the dashboard spec,
    whose rows fetch their words in one round.  ``offset`` starts the
    buffer that many bytes past an allocation.  Exact equality."""
    lines, n_rows, kill = seeded_lanes_case(B, seed=B)
    buf, lengths, overflow = encode_batch(lines)
    kill[np.asarray(overflow, dtype=np.int64)] = 1
    dbuf = _offset_buffer(buf, offset, cuda_device)
    dlen = torch.from_numpy(lengths).to(cuda_device)
    dkill = torch.from_numpy(kill).to(cuda_device)
    for fmt, fields, ops in ((SEEDED_LANES_FORMAT, SEEDED_LANES_FIELDS, SEEDED_LANES_OPS),
                             ("combined", HEADLINE_FIELDS, DASHBOARD_OPS)):
        ex = TorchBatchParser(fmt, fields)._agg_executor(AggregateSpec.parse(ops))
        t = ex.tables
        packed = ex.units(dbuf, dlen)
        kinds = lanes_kinds(t, packed.cpu().numpy(), n_rows, kill)
        if fmt == SEEDED_LANES_FORMAT:
            assert len(t.units_py) == 8 and len(t.lanes_py) == 16
            assert all(v for k, v in kinds.items() if k != "walked_one_round"), kinds
        else:
            assert kinds["walked_one_round"] and not kinds["walked_rounds"], kinds
        got = kernels.agg_lanes(t, packed, dbuf, n_rows, dkill)
        want = agg_device.agg_lanes_plain(
            t, packed, dbuf, n_rows, dkill, torch.empty_like(got[0]), torch.empty_like(got[1]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), fmt
        assert (got[0] == 0).any() and (got[0] == 1).any() and (got[0] == 3).any()


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("L,width,B", [(384, 121, 4097), (384, 121, 65547), (384, 16, 4095),
                                       (64, 100, 4095), (2048, 513, 4097),
                                       (8191, 512, 1027), (8191, 8191, 1027)])
def test_unescape_kernel_on_seeded_spans(cuda_device, L, width, B, offset):
    """unescape against its plain version on tools.kernel_ab's seeded
    spans (the escape bytes \\ " b n r t v x q, the reference spec's
    cases at every offset of a 16-byte chunk, spans at and past the
    window's width and the staging cap, past L, lifted above the gather
    mask), read as chunks and through Row::at, backslash-free and walked,
    the output staged (width <= 512) or written straight (above).  B is
    not a multiple of 32.  Exact equality."""
    buf, s, e = seeded_unescape_case(B, L, width, seed=B + L + width)
    kinds = unescape_kinds(buf, s, e, width)
    assert all(kinds[k] for k in ("chunks", "bytes", "backslash_free", "walked")), kinds
    dbuf = _offset_buffer(buf, offset, cuda_device)
    ds = torch.from_numpy(s).to(cuda_device)
    de = torch.from_numpy(e).to(cuda_device)
    got = kernels.unescape(dbuf, ds, de, width)
    want = postproc.unescape_compact_spans_plain(dbuf, ds, de, width)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].any() and not got[2].all()
