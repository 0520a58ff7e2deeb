"""GeoIP enrichment on the CPU against the reference package.

The port's .mmdb writer, reader and flattened ``GeoDeviceTable`` against
the reference's; the plain versions of the two kernels of the geo stage
(``parse_ipv4_spans``, the range join of ``lookup_rows``) on seeded bytes
and keys, and on ``tools.kernel_ab.seeded_ipv4_case``'s edge spans; then
the ``geoip_chain`` configuration (the reference's bench config over the
fixture City and ASN databases), ``geoip_synthetic`` (the same fields
over a seeded synthetic City database) and ``geoip_two_tokens`` (City and
ASN over NGINX's client and server addresses): packed rows bit for bit
through the harness, ``to_dict()`` and ``needs_host`` against
``TpuBatchParser(..., extra_dissectors=[...])``, and one ``ipv4_spans``
call per IP token, which every geo group over it reads.  Every comparison is
exact.  One reference parser per configuration (module-scoped): each
jit compile costs seconds.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logparser_tpu.geoip import GeoIPASNDissector as RefASN
from logparser_tpu.geoip import GeoIPCityDissector as RefCity
from logparser_tpu.geoip import GeoIPCountryDissector as RefCountry
from logparser_tpu.core.exceptions import InvalidDissectorException as RefInvalidDissector
from logparser_tpu.geoip.device import GeoDeviceTable as RefTable
from logparser_tpu.geoip.mmdb import MMDBReader as RefReader
from logparser_tpu.tools import geoip_testdata as ref_testdata
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser, UnsupportedFieldError
from logparser_tpu_torch.core.exceptions import InvalidDissectorException
from logparser_tpu_torch.geoip import (
    GeoDeviceTable,
    GeoIPASNDissector,
    GeoIPCityDissector,
    GeoIPCountryDissector,
    MMDBReader,
    lookup_rows_plain,
)
from logparser_tpu_torch.tools import demolog, geoip_testdata
from logparser_tpu_torch.tools.kernel_ab import seeded_ipv4_case, window_inside
from logparser_tpu_torch.tpu import kernels, pipeline, postproc
from logparser_tpu_torch.tpu.carry import units_from_reference
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import (
    assert_parse_matches_reference,
    assert_results_equal,
    first_mismatch,
    jax_unit_plain,
    reference_packed,
)

SYNTHETIC_NETWORKS = 2048
SYNTHETIC_SEED = 4
N_LINES = 2000


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """{name: path}: the port's fixture databases and a 2,048-network
    synthetic City database."""
    fixtures = geoip_testdata.ensure_test_databases()
    syn = geoip_testdata.ensure_synthetic_city_database(
        SYNTHETIC_NETWORKS, SYNTHETIC_SEED, str(tmp_path_factory.mktemp("synthetic")))
    return {"city": os.path.join(fixtures, "GeoIP2-City-Test.mmdb"),
            "asn": os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb"),
            "country": os.path.join(fixtures, "GeoIP2-Country-Test.mmdb"),
            "synthetic": syn}


def _config(name, dbs):
    city = dbs["city" if name == "geoip_chain" else "synthetic"]
    if name == "geoip_chain":
        lines = demolog.geoip_chain_lines(N_LINES)
    else:
        nets = geoip_testdata.synthetic_networks(SYNTHETIC_NETWORKS, SYNTHETIC_SEED)
        lines = demolog.geoip_synthetic_lines(N_LINES, nets)
    return city, dbs["asn"], lines + demolog.geoip_edge_lines()


@pytest.fixture(scope="module")
def reference(dbs):
    """{config: (TpuBatchParser, lines, its parse)}, built lazily once."""
    cache = {}

    def get(name):
        if name not in cache:
            city, asn, lines = _config(name, dbs)
            parser = TpuBatchParser("combined", list(demolog.GEOIP_FIELDS),
                                    extra_dissectors=[RefCity(city), RefASN(asn)])
            cache[name] = (parser, lines, parser.parse_batch(lines))
        return cache[name]
    return get


def _ours(name, dbs, device="cpu"):
    city, asn, _ = _config(name, dbs)
    return TorchBatchParser("combined", demolog.GEOIP_FIELDS, device=device,
                            extra_dissectors=[GeoIPCityDissector(city),
                                              GeoIPASNDissector(asn)])


def _compare(ours, ref, lines):
    return assert_results_equal(ours, ref)


# -- the plain versions of the kernels ---------------------------------------

IP_EDGES = [b"1.2.3.4", b"255.255.255.255", b"0.0.0.0", b"128.0.0.0", b"256.1.1.1",
            b"080.1.1.1", b"1..2.3", b"1.2.3", b"1.2.3.4.5", b"1.2.3.4.", b".1.2.3",
            b"1.2.3.4:80", b"123.123.123.123:8080", b"2001:980::1", b"::1",
            b"99999999999999999999", b"4294967296.1.1.1", b"1.2.3.04", b"-", b""]


def _ipv4_inputs(seed):
    rng = np.random.default_rng(seed)
    B, L = 3000, 64
    alpha = np.frombuffer(b"0123456789.:-x ", dtype=np.uint8)
    buf = alpha[rng.integers(0, len(alpha), size=(B, L))]
    buf[::3] = rng.integers(0, 256, size=buf[::3].shape)
    s = rng.integers(-5, L, size=B).astype(np.int32)
    e = (s + rng.integers(-2, 22, size=B)).astype(np.int32)
    for i, edge in enumerate(IP_EDGES):
        buf[i] = 0
        buf[i, 3:3 + len(edge)] = np.frombuffer(edge, dtype=np.uint8)
        s[i], e[i] = 3, 3 + len(edge)
    # Valid addresses at random offsets, and starts past the gather mask.
    for i in range(len(IP_EDGES), 600):
        ip = ".".join(str(x) for x in rng.integers(0, 256, size=4)).encode()
        off = int(rng.integers(0, L - 16))
        buf[i, off:off + len(ip)] = np.frombuffer(ip, dtype=np.uint8)
        s[i], e[i] = off + (64 if i % 7 == 0 else 0), off + len(ip)
    return buf, s, e


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_ipv4_spans_matches_reference(seed):
    buf, s, e = _ipv4_inputs(seed)
    want = ref_postproc.parse_ipv4_spans(jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e))
    got = postproc.parse_ipv4_spans(torch.from_numpy(buf), torch.from_numpy(s),
                                    torch.from_numpy(e))
    np.testing.assert_array_equal(np.asarray(want[0]).view(np.int32), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    ok, colon = got[1][:len(IP_EDGES)].tolist(), got[2][:len(IP_EDGES)].tolist()
    assert ok[:4] == [True] * 4 and not any(ok[4:])
    # ':' at byte 7 flags; at byte 15 it lies past the 15-byte window.
    assert colon[IP_EDGES.index(b"1.2.3.4:80")]
    assert not colon[IP_EDGES.index(b"123.123.123.123:8080")]
    assert got[0][IP_EDGES.index(b"128.0.0.0")].item() == -(1 << 31)


@pytest.mark.parametrize("L", [64, 384, 2048])
def test_seeded_ipv4_spans_match_reference(L):
    """The seeded edge spans over two tokens (leading zeros, octets of 256
    and 999, digit runs that wrap uint32, empty octets, a trailing dot,
    ':' inside and past min(width, 15), every width 0 to 16, spans past L,
    starts above the gather mask) through the port's parse_ipv4_spans and
    the reference's, bit for bit: the value row of rejected spans too."""
    buf, s, e = seeded_ipv4_case(3000, L, seed=L)
    inside = window_inside(s[0], L, postproc.MAX_IP)
    assert inside.any() and not inside.all()
    for tok in (0, 1):
        want = ref_postproc.parse_ipv4_spans(jnp.asarray(buf), jnp.asarray(s[tok]),
                                             jnp.asarray(e[tok]))
        got = postproc.parse_ipv4_spans(torch.from_numpy(buf), torch.from_numpy(s[tok]),
                                        torch.from_numpy(e[tok]))
        np.testing.assert_array_equal(np.asarray(want[0]).view(np.int32), got[0].numpy())
        np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
        np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
        if tok == 0:
            ok, colon, value = got[1].numpy(), got[2].numpy(), got[0].numpy()
            assert ok.any() and colon.any() and (~ok & ~colon).any()
            assert (value[~ok] != 0).any()   # rejected spans keep their values


def _keys_for(starts, ends, seed):
    rng = np.random.default_rng(seed)
    s64, e64 = starts.astype(np.int64), ends.astype(np.int64)
    keys = np.concatenate([s64, e64, s64 - 1, e64 + 1, [0, 0xFFFFFFFF, 1 << 31],
                           rng.integers(0, 1 << 32, size=4000)])
    return (keys & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("db", ["city", "asn", "synthetic"])
def test_lookup_rows_matches_reference(dbs, db):
    ref = RefTable(RefReader(dbs[db]), ["country.name"] if db != "asn" else ["asn.number"])
    keys = _keys_for(ref.starts, ref.ends, 3)
    want = np.asarray(ref.lookup_rows(jnp.asarray(keys)))
    got = lookup_rows_plain(torch.from_numpy(ref.starts.view(np.int32)),
                            torch.from_numpy(ref.ends.view(np.int32)),
                            torch.from_numpy(keys.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want == 0).any()


def test_ipv4_to_u32_matches_reference():
    from logparser_tpu.geoip.device import ipv4_to_u32 as ref_ipv4_to_u32
    from logparser_tpu_torch.geoip import ipv4_to_u32

    ips = [e.decode() for e in IP_EDGES] + ["80.100.47.1", "1.2.3.-4", " 1.2.3.4", None]
    for got, want in zip(ipv4_to_u32(ips), ref_ipv4_to_u32(ips)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_lookup_rows_plain_on_an_empty_table():
    keys = torch.tensor([0, 5, -1, 1 << 30], dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    assert lookup_rows_plain(empty, empty, keys).tolist() == [0, 0, 0, 0]


def test_geo_lookup_plain_gates_and_high_addresses():
    table = GeoDeviceTable.from_ranges(np.array([5, 0x80000000, 0xFFFFFF00], np.uint32),
                                       np.array([9, 0x800000FF, 0xFFFFFFFF], np.uint32))
    group = pipeline.GeoTables(pipeline._GeoGroup("k", 0, table))
    keys = torch.from_numpy(np.array([4, 5, 9, 10, 0x80000000, 0x80000100, 0xFFFFFFFF],
                                     dtype=np.uint32).view(np.int32))
    out = torch.empty(7, dtype=torch.int32)
    assert pipeline.geo_lookup_plain(group, keys, None, out).tolist() == [0, 1, 1, 0, 2, 0, 3]
    gate = torch.tensor([1, 1, 0, 1, 1, 1, 0], dtype=torch.int32)
    assert pipeline.geo_lookup_plain(group, keys, gate, out).tolist() == [0, 1, 0, 0, 2, 0, 0]


# -- the geo_lookup kernel's two-level search --------------------------------


def _two_level_rows(g, keys, gate=None, window=16):
    """The geo_lookup kernel's search in numpy, over GeoTables as a block
    reads them: the staged splitters by power-of-two steps, then from the
    key's splitter on halving steps over the starts down to a window of
    ``window`` starts, counted whole; row = the starts at or below the
    key, a hit when the key is at most that range's end (read from the
    staged image when it holds the ends)."""
    K, shift = g.starts.shape[0], g.split_shift
    k = keys.astype(np.int64)
    if K == 0:
        return np.zeros(len(k), dtype=np.int32)
    image = g.image.numpy().view(np.uint32).astype(np.int64)
    starts = g.starts.numpy().view(np.uint32).astype(np.int64)
    ends = (image[g.ends_at:g.ends_at + K] if g.ends_at >= 0
            else g.ends.numpy().view(np.uint32).astype(np.int64))
    spl = image[:g.n_split]

    def halve(v, base, n, top, stop):
        pos = np.zeros(len(k), dtype=np.int64)
        step = top
        while step >= stop:
            cand = pos + step
            at = np.where(cand <= n, base + cand - 1, 0)
            pos = np.where((cand <= n) & (v[at] <= k), cand, pos)
            step >>= 1
        return pos

    pos = halve(spl, 0, g.n_split, 1 << (g.n_split.bit_length() - 1), 1)
    if shift:
        S = 1 << shift
        base = np.where(pos > 0, (pos - 1) << shift, 0)
        n = np.where(pos > 0, np.minimum(S, K - base), 0)
        p = halve(starts, base, n, S >> 1, window)
        count = np.zeros(len(k), dtype=np.int64)
        for i in range(min(S, window)):
            inside = p + i < n
            at = np.where(inside, base + p + i, 0)
            count += inside & (starts[at] <= k)
        pos = np.where(pos > 0, base + p + count, 0)
    hit = (pos > 0) & (k <= ends[np.clip(pos - 1, 0, K - 1)])
    if gate is not None:
        hit &= gate != 0
    return np.where(hit, pos, 0).astype(np.int32)


def _reference_rows(starts, ends, keys):
    """GeoDeviceTable.lookup_rows of the reference over these ranges."""
    from types import SimpleNamespace

    ns = SimpleNamespace(starts=starts, ends=ends)
    return np.asarray(RefTable.lookup_rows(ns, jnp.asarray(keys)))


def _edge_keys(starts, ends):
    s64, e64 = starts.astype(np.int64), ends.astype(np.int64)
    keys = np.concatenate([s64, e64, s64 - 1, e64 + 1, s64 + 1, e64 - 1, [0, 0xFFFFFFFF]])
    return (keys & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("K", [0, 1, 7, 8192, 8193, 131072])
def test_two_level_search_matches_reference(K):
    """Seeded disjoint ranges over the whole uint32 space: S is the least
    power of two with ceil(K / S) <= 8,192 splitters, and the search
    gives the reference's rows on every start and end +-1, 0 and
    0xFFFFFFFF."""
    rng = np.random.default_rng(K + 7)
    bounds = np.sort(rng.choice(1 << 32, size=2 * K, replace=False)).astype(np.uint32)
    starts, ends = bounds[0::2], bounds[1::2]
    g = pipeline.GeoTables(pipeline._GeoGroup("k", 0, GeoDeviceTable.from_ranges(starts, ends)))
    S = 1 << g.split_shift
    assert g.n_split == -(-K // S) <= pipeline.GEO_SPLITTERS
    assert S == 1 or -(-K // (S // 2)) > pipeline.GEO_SPLITTERS
    image = g.image.numpy().view(np.uint32)
    assert np.array_equal(image[:g.n_split], starts[::S])
    if K and S == 1:   # the ends staged too: the whole lookup in shared memory
        assert g.ends_at == -(-K // 4) * 4 and np.array_equal(image[g.ends_at:][:K], ends)
    else:
        assert g.ends_at == -1
    assert g.smem_bytes == 4 * len(image) and g.smem_bytes % 16 == 0
    assert g.smem_bytes <= 2 * 4 * pipeline.GEO_SPLITTERS
    assert g.lockstep == (4 if S > 16 else (2 if S > 1 else 1))
    keys = _edge_keys(starts, ends)
    # The reference's gather fails on an empty table; the port's plain
    # version (held to it on every other table) misses every key there.
    want = _reference_rows(starts, ends, keys) if K else np.zeros(len(keys), np.int32)
    plain = lookup_rows_plain(g.starts, g.ends, torch.from_numpy(keys.view(np.int32)))
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(_two_level_rows(g, keys), want)
    if K:
        assert np.array_equal(want[:K], np.arange(1, K + 1))
    gate = np.random.default_rng(K).integers(0, 2, size=len(keys))
    np.testing.assert_array_equal(_two_level_rows(g, keys, gate), np.where(gate != 0, want, 0))


@pytest.mark.parametrize("db", ["city", "asn"])
def test_two_level_search_on_the_fixture_tables(dbs, db):
    columns = ["country.name"] if db != "asn" else ["asn.number"]
    ref = RefTable(RefReader(dbs[db]), columns)
    g = pipeline.GeoTables(pipeline._GeoGroup(db, 0, GeoDeviceTable(MMDBReader(dbs[db]),
                                                                     columns)))
    assert g.split_shift == 0 and g.n_split == len(ref.starts) and g.ends_at >= g.n_split
    keys = np.concatenate([_edge_keys(ref.starts, ref.ends), _keys_for(ref.starts, ref.ends, 4)])
    want = np.asarray(ref.lookup_rows(jnp.asarray(keys)))
    np.testing.assert_array_equal(_two_level_rows(g, keys), want)
    assert (want > 0).any() and (want == 0).any()


# -- the databases and the flattened table -----------------------------------

@pytest.mark.parametrize("db,columns", [
    ("city", ["continent.code", "country.name", "city.name", "location.latitude",
              "location.timezone", "postal.code"]),
    ("asn", ["asn.number", "asn.organization"]),
    ("synthetic", ["country.name", "country.iso", "city.name"]),
])
def test_geo_table_matches_reference(dbs, db, columns):
    ref = RefTable(RefReader(dbs[db]), columns)
    ours = GeoDeviceTable(MMDBReader(dbs[db]), columns)
    np.testing.assert_array_equal(ours.starts, ref.starts)
    np.testing.assert_array_equal(ours.ends, ref.ends)
    assert ours.starts.dtype == np.uint32 and ours.ends.dtype == np.uint32
    assert ours.vocabs == ref.vocabs
    for c in columns:
        np.testing.assert_array_equal(ours.arrays[c], ref.arrays[c])
        assert ours.arrays[c].dtype == ref.arrays[c].dtype
    if db == "synthetic":
        assert len(ours) == SYNTHETIC_NETWORKS
        assert np.all(ours.starts[1:] > ours.ends[:-1])


def test_writer_bytes_match_reference(tmp_path):
    ours = geoip_testdata.write_test_databases(str(tmp_path / "ours"))
    theirs = ref_testdata.write_test_databases(str(tmp_path / "theirs"))
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        with open(ours[name], "rb") as a, open(theirs[name], "rb") as b:
            assert a.read() == b.read(), name
    # The synthetic database through both writers.
    nets = geoip_testdata.synthetic_networks(256, 11)
    ref_writer, our_writer = ref_testdata.MMDBWriter("GeoIP2-City"), \
        geoip_testdata.MMDBWriter("GeoIP2-City")
    for k, net in enumerate(nets.tolist()):
        cidr = ".".join(str((net >> sh) & 255) for sh in (24, 16, 8, 0)) + "/24"
        rec = geoip_testdata.synthetic_city_record(k)
        ref_writer.insert(cidr, rec)
        our_writer.insert(cidr, rec)
    assert our_writer.to_bytes() == ref_writer.to_bytes()


def test_synthetic_networks_are_seeded_and_disjoint():
    a = geoip_testdata.synthetic_networks(4096, 4)
    assert np.array_equal(a, geoip_testdata.synthetic_networks(4096, 4))
    assert not np.array_equal(a, geoip_testdata.synthetic_networks(4096, 5))
    assert len(np.unique(a)) == 4096 and np.all(a & 0xFF == 0)
    lines = demolog.geoip_synthetic_lines(200, a)
    hosts = [ln.split(" ")[0] for ln in lines]
    assert len(hosts) == 200 and lines == demolog.geoip_synthetic_lines(200, a)


# -- the configurations end to end -------------------------------------------

CONFIGS = ["geoip_chain", "geoip_synthetic"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_reference(reference, dbs, name):
    _, lines, ref = reference(name)
    ours = _ours(name, dbs).parse_batch(lines)
    _compare(ours, ref, lines)
    country = ours.to_pylist("STRING:connection.client.host.country.name")
    assert sum(v is not None for v in country[:N_LINES]) > N_LINES // 4
    edge = demolog.geoip_edge_lines()
    host = {lines[i] for i in ours.needs_host}
    for ip in ("1.2.3.4:80", "2001:980::1", "::ffff:80.100.47.1"):
        assert next(x for x in edge if x.startswith(ip + " ")) in host, ip
    for ip in ("123.123.123.123:8080", "example.com", "080.100.47.1"):
        i = lines.index(next(x for x in edge if x.startswith(ip + " ")))
        assert ours.valid[i] and country[i] is None, ip


@pytest.mark.parametrize("name", CONFIGS)
def test_packed_rows_match_reference(reference, dbs, name):
    parser, lines, _ = reference(name)
    specs = parser._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in parser.units])
    ex = pipeline.UnitsExecutor(units, specs)
    buf, lengths, _ = encode_batch(lines[:512] + demolog.geoip_edge_lines())
    want = reference_packed(parser.units, specs, buf, lengths)
    got = ex(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(parser.units, specs, got, want) is None
    own = _ours(name, dbs).executor
    got = own(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(parser.units, specs, got, want) is None


def _two_token_parsers(dbs, device="cpu"):
    """(the port's, the reference's) parser of geoip_two_tokens."""
    ours = TorchBatchParser(demolog.GEOIP_TWO_TOKEN_FORMAT, demolog.GEOIP_TWO_TOKEN_FIELDS,
                            device=device, extra_dissectors=[GeoIPCityDissector(dbs["city"]),
                                                             GeoIPASNDissector(dbs["asn"])])
    ref = TpuBatchParser(demolog.GEOIP_TWO_TOKEN_FORMAT, list(demolog.GEOIP_TWO_TOKEN_FIELDS),
                         extra_dissectors=[RefCity(dbs["city"]), RefASN(dbs["asn"])])
    return ours, ref


@pytest.mark.parametrize("name,tokens", [("geoip_chain", 1), ("geoip_two_tokens", 2)])
def test_one_ipv4_parse_per_ip_token(reference, dbs, monkeypatch, name, tokens):
    """The executor parses each IP token once (``ipv4_spans``, its 4 rows
    shared by every geo group over the token) and looks each group up in
    its table, and the packed rows, ``to_dict()`` and ``needs_host`` still
    equal TpuBatchParser's: geoip_chain's City and ASN over ``%h`` (one
    parse), and City and ASN over each of two NGINX addresses (two)."""
    if name == "geoip_chain":
        ref, lines, ref_res = reference(name)
        ours = _ours(name, dbs)
    else:
        ours, ref = _two_token_parsers(dbs)
        lines = demolog.geoip_two_token_lines(600)
        ref_res = ref.parse_batch(lines)
    (unit,) = ours.executor.unit_tables
    assert len(unit.ip) == tokens and len(unit.geo) == 2 * tokens
    bases = {ip.token_index: ip.base for ip in unit.ip}
    assert all(g.ip == bases[g.token_index] for g in unit.geo)
    assert len({g.row for g in unit.geo}) == len(unit.geo)
    calls, launch = [], kernels.ipv4_spans

    def counted(tables, *args, **kwargs):
        calls.append(tables.token_index)
        return launch(tables, *args, **kwargs)

    monkeypatch.setattr(kernels, "ipv4_spans", counted)
    res = ours.parse_batch(lines)
    assert sorted(calls) == sorted(bases)
    _compare(res, ref_res, lines)
    if name == "geoip_chain":   # its packed rows: test_packed_rows_match_reference
        return
    specs = ref._view_specs()
    buf, lengths, _ = encode_batch(lines)
    got = ours.executor(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    want = reference_packed(ref.units, specs, buf, lengths)
    assert first_mismatch(ref.units, specs, got, want) is None


def test_widest_bucket_matches_reference(dbs):
    city, asn, lines = _config("geoip_chain", dbs)
    lines = lines[:150] + demolog.geoip_edge_lines()
    pad = 8191 - len(lines[0].encode())
    lines += [lines[0].replace('"GET ', '"GET /' + "w" * (pad - 1), 1),
              lines[0].replace('"GET ', '"GET /' + "w" * (pad + 99), 1)]
    ref = TpuBatchParser("combined", list(demolog.GEOIP_FIELDS),
                         extra_dissectors=[RefCity(city), RefASN(asn)]).parse_batch(lines)
    ours = _ours("geoip_chain", dbs).parse_batch(lines)
    assert ours.buf.shape[1] == 8191
    _compare(ours, ref, lines)
    assert len(lines) - 1 in ours.needs_host.tolist()


def test_two_dissectors_on_one_token_are_two_groups(dbs):
    parser = _ours("geoip_chain", dbs)
    (unit,) = parser.executor.unit_tables
    assert [len(g.table) for g in unit.geo] == [1, 1]
    assert len({g.key for g in unit.geo}) == 2
    plans = {p.field_id: p for p in parser.units[0].plans}
    assert plans["STRING:connection.client.host.city.name"].kind == "geo"
    assert (pipeline.geo_group_key(plans["STRING:connection.client.host.city.name"])
            == pipeline.geo_group_key(plans["STRING:connection.client.host.country.name"]))


def test_unsupported_geo_fields_name_the_host_oracle(dbs, tmp_path):
    """A GeoIP dissector whose database cannot be read fails the build, as
    in the reference (the oracle opens it); without the dissector the field
    has no producer at all."""
    missing = str(tmp_path / "missing.mmdb")
    field = "STRING:connection.client.host.country.name"
    with pytest.raises(RefInvalidDissector):
        TpuBatchParser("combined", [field], extra_dissectors=[RefCountry(missing)])
    with pytest.raises(InvalidDissectorException):
        TorchBatchParser("combined", [field], device="cpu",
                         extra_dissectors=[GeoIPCountryDissector(missing)])
    with pytest.raises(UnsupportedFieldError, match="no producer"):
        TorchBatchParser("combined", [field], device="cpu")


def test_host_geo_fields_match_reference(dbs):
    """GeoIP fields the device cannot decode are host plans, the oracle's
    values on every line the format wins, equal to the reference:
    country.getconfidence has no device table column, and country.name
    under both a City and a Country dissector has two producers (the
    oracle delivers both in graph order and the record keeps the last)."""
    lines = demolog.geoip_chain_lines(48) + demolog.geoip_edge_lines()
    fields = ["NUMBER:connection.client.host.country.getconfidence",
              "STRING:connection.client.host.country.name",
              "STRING:connection.client.host.city.name", "IP:connection.client.host"]
    ours = assert_parse_matches_reference(
        "combined", fields, lines,
        extra_dissectors=[GeoIPCityDissector(dbs["city"]),
                          GeoIPCountryDissector(dbs["country"])],
        ref_kwargs={"extra_dissectors": [RefCity(dbs["city"]), RefCountry(dbs["country"])]})
    assert ours.rescue_reasons["host_fields"] > 40
    assert any(v is not None for v in ours.to_pylist(fields[1]))
