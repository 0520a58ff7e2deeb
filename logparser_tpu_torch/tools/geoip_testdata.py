"""Self-contained GeoIP test fixtures: a MaxMind-DB *writer* + generators
(the port's own copy of the reference package's ``tools/geoip_testdata.py``,
writing the same bytes), plus a seeded synthetic City database of
realistic size.

The reference ships generated test databases
(GeoIP2-TestData/source-data/*.json rendered by write-test-data.pl); the
rebuild's GeoIP tests and bench config used that read-only checkout.  This
module removes the dependency: a minimal writer for the public MaxMind DB
file format spec v2.0 (the exact inverse of
:mod:`logparser_tpu_torch.geoip.mmdb`) plus generators for the City / Country /
ASN / ISP databases carrying the same records the test suite asserts
(the Basjes test ranges: 80.100.47.0/24, 2001:980::/29).

Writer scope: disjoint networks, record size 24, no data-section pointer
compression beyond whole-record dedup — plenty for fixtures, not a
general-purpose production writer.
"""
from __future__ import annotations

import ipaddress
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

_METADATA_MARKER = b"\xab\xcd\xefMaxMind.com"

_T_UTF8 = 2
_T_DOUBLE = 3
_T_BYTES = 4
_T_UINT16 = 5
_T_UINT32 = 6
_T_MAP = 7
_T_UINT64 = 9
_T_ARRAY = 11
_T_BOOL = 14


def _ctrl(type_num: int, size: int) -> bytes:
    """Control byte(s) for a type + payload size (spec §'Data field format')."""
    ext = b""
    if type_num > 7:
        ext = bytes([type_num - 7])
        type_num = 0
    if size < 29:
        return bytes([(type_num << 5) | size]) + ext
    if size < 29 + 256:
        return bytes([(type_num << 5) | 29]) + ext + bytes([size - 29])
    if size < 285 + 65536:
        return bytes([(type_num << 5) | 30]) + ext + (size - 285).to_bytes(2, "big")
    return bytes([(type_num << 5) | 31]) + ext + (size - 65821).to_bytes(3, "big")


def encode_value(value: Any) -> bytes:
    """Encode one Python value in the MaxMind data-section type format."""
    if isinstance(value, bool):
        # Bool stores its value in the size bits; type 14 is extended.
        return _ctrl(_T_BOOL, 1 if value else 0)
    if isinstance(value, str):
        raw = value.encode("utf-8")
        return _ctrl(_T_UTF8, len(raw)) + raw
    if isinstance(value, bytes):
        return _ctrl(_T_BYTES, len(value)) + value
    if isinstance(value, float):
        return _ctrl(_T_DOUBLE, 8) + struct.pack(">d", value)
    if isinstance(value, int):
        if value < 0:
            raise ValueError("negative ints not needed by the fixtures")
        if value < 1 << 16:
            raw = value.to_bytes((value.bit_length() + 7) // 8, "big")
            return _ctrl(_T_UINT16, len(raw)) + raw
        if value < 1 << 32:
            raw = value.to_bytes((value.bit_length() + 7) // 8, "big")
            return _ctrl(_T_UINT32, len(raw)) + raw
        raw = value.to_bytes((value.bit_length() + 7) // 8, "big")
        return _ctrl(_T_UINT64, len(raw)) + raw
    if isinstance(value, dict):
        out = _ctrl(_T_MAP, len(value))
        for k, v in value.items():
            out += encode_value(str(k)) + encode_value(v)
        return out
    if isinstance(value, (list, tuple)):
        out = _ctrl(_T_ARRAY, len(value))
        for item in value:
            out += encode_value(item)
        return out
    raise TypeError(f"unsupported fixture value type: {type(value)!r}")


class MMDBWriter:
    """Build a .mmdb byte blob from disjoint (network -> record) entries.

    IPv4 networks in an ip_version-6 database land under ``::/96`` —
    exactly where :class:`logparser_tpu_torch.geoip.mmdb.MMDBReader` (and
    MaxMind's own readers) walk 96 zero bits to find them.
    """

    def __init__(self, database_type: str, ip_version: int = 6,
                 description: str = "logparser_tpu generated test data"):
        if ip_version not in (4, 6):
            raise ValueError("ip_version must be 4 or 6")
        self.database_type = database_type
        self.ip_version = ip_version
        self.description = description
        self._entries: List[Tuple[int, int, Any]] = []  # (net, plen, data)

    def insert(self, cidr: str, data: Dict[str, Any]) -> None:
        net = ipaddress.ip_network(cidr, strict=True)
        bits = 128 if self.ip_version == 6 else 32
        native_bits = 128 if net.version == 6 else 32
        # Keep only the PREFIX bits (shift the host bits out) — the trie
        # consumes exactly plen bits from the most significant end.
        prefix = int(net.network_address) >> (native_bits - net.prefixlen)
        plen = net.prefixlen
        if net.version == 4 and self.ip_version == 6:
            plen += 96  # map into ::/96 (the leading bits are zero)
        elif net.version == 6 and self.ip_version == 4:
            raise ValueError("cannot insert IPv6 into an IPv4 database")
        if plen > bits:
            raise ValueError(cidr)
        self._entries.append((prefix, plen, data))

    def to_bytes(self) -> bytes:
        # ---- trie ------------------------------------------------------
        EMPTY = -1
        nodes: List[List[Any]] = [[EMPTY, EMPTY]]  # child index | ("data", i)

        for idx, (prefix, plen, _) in enumerate(self._entries):
            node = 0
            for depth in range(plen):
                bit = (prefix >> (plen - 1 - depth)) & 1
                child = nodes[node][bit]
                if depth == plen - 1:
                    if child != EMPTY:
                        raise ValueError(
                            "overlapping fixture networks are not supported"
                        )
                    nodes[node][bit] = ("data", idx)
                else:
                    if child == EMPTY:
                        nodes.append([EMPTY, EMPTY])
                        child = len(nodes) - 1
                        nodes[node][bit] = child
                    elif isinstance(child, tuple):
                        raise ValueError(
                            "overlapping fixture networks are not supported"
                        )
                    node = child  # always an int index here

        node_count = len(nodes)

        # ---- data section (whole-record dedup) -------------------------
        data_blob = b""
        offsets: Dict[int, int] = {}       # entry index -> offset
        by_payload: Dict[bytes, int] = {}  # encoded record -> offset
        for idx, (_, _, data) in enumerate(self._entries):
            payload = encode_value(data)
            at = by_payload.get(payload)
            if at is None:
                at = len(data_blob)
                by_payload[payload] = at
                data_blob += payload
            offsets[idx] = at

        # ---- serialize nodes (record_size 24) --------------------------
        def record_value(child: Any) -> int:
            if child == EMPTY:
                return node_count            # "no data" sentinel
            if isinstance(child, tuple):
                return node_count + 16 + offsets[child[1]]
            return child

        tree = bytearray()
        for left, right in nodes:
            lv, rv = record_value(left), record_value(right)
            if max(lv, rv) >= 1 << 24:
                raise ValueError("fixture database too large for 24-bit records")
            tree += lv.to_bytes(3, "big") + rv.to_bytes(3, "big")

        metadata = {
            "binary_format_major_version": 2,
            "binary_format_minor_version": 0,
            "build_epoch": 1700000000,
            "database_type": self.database_type,
            "description": {"en": self.description},
            "ip_version": self.ip_version,
            "languages": ["en"],
            "node_count": node_count,
            "record_size": 24,
        }
        return (
            bytes(tree)
            + b"\x00" * 16
            + data_blob
            + _METADATA_MARKER
            + encode_value(metadata)
        )

    def write(self, path: str) -> str:
        # Atomic: a concurrent reader (bench + pytest racing to generate
        # the shared fixtures) must never see a half-written file.
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(self.to_bytes())
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Fixture records: the Basjes test ranges the suite (and bench) assert on.
# ---------------------------------------------------------------------------


def _names(en: str) -> Dict[str, Any]:
    return {"names": {"en": en}}


_CITY_RECORD = {
    "city": {**_names("Amstelveen"), "confidence": 1, "geoname_id": 1234},
    "continent": {**_names("Europe"), "code": "EU", "geoname_id": 6255148},
    "country": {
        **_names("Netherlands"), "iso_code": "NL", "geoname_id": 2750405,
        "confidence": 42, "is_in_european_union": True,
    },
    "location": {
        "accuracy_radius": 4, "latitude": 52.5, "longitude": 5.75,
        "metro_code": 5, "average_income": 6, "population_density": 7,
        "time_zone": "Europe/Amsterdam",
    },
    "postal": {"code": "1187", "confidence": 2},
    "subdivisions": [
        {**_names("Noord Holland"), "iso_code": "NH", "confidence": 3},
    ],
}

_COUNTRY_RECORD = {
    "continent": _CITY_RECORD["continent"],
    "country": _CITY_RECORD["country"],
}

_ASN_RECORD_V4 = {
    "autonomous_system_number": 4444,
    "autonomous_system_organization": "Basjes Global Network",
}
_ASN_RECORD_V6 = {
    "autonomous_system_number": 6666,
    "autonomous_system_organization": "Basjes Global Network IPv6",
}
_ISP_RECORD = {
    "autonomous_system_number": 4444,
    "autonomous_system_organization": "Basjes Global Network",
    "isp": "Basjes ISP",
    "organization": "Niels Basjes",
}

V4_TEST_NET = "80.100.47.0/24"
V6_TEST_NET = "2001:980::/29"

_DATABASES = {
    "GeoIP2-City-Test.mmdb": ("GeoIP2-City", [(V4_TEST_NET, _CITY_RECORD)]),
    "GeoIP2-Country-Test.mmdb": (
        "GeoIP2-Country", [(V4_TEST_NET, _COUNTRY_RECORD)]
    ),
    "GeoLite2-ASN-Test.mmdb": (
        "GeoLite2-ASN",
        [(V4_TEST_NET, _ASN_RECORD_V4), (V6_TEST_NET, _ASN_RECORD_V6)],
    ),
    "GeoIP2-ISP-Test.mmdb": ("GeoIP2-ISP", [(V4_TEST_NET, _ISP_RECORD)]),
}


def write_test_databases(directory: str) -> Dict[str, str]:
    """Write all four fixture databases into ``directory``; returns
    {filename: path}."""
    os.makedirs(directory, exist_ok=True)
    out = {}
    for filename, (db_type, entries) in _DATABASES.items():
        writer = MMDBWriter(db_type)
        for cidr, record in entries:
            writer.insert(cidr, record)
        out[filename] = writer.write(os.path.join(directory, filename))
    return out


def _fixture_stamp() -> str:
    """Content hash of the fixture definitions: editing a record
    regenerates stale caches instead of silently serving old data."""
    import hashlib

    return hashlib.sha256(repr(sorted(
        (name, db_type, repr(entries))
        for name, (db_type, entries) in _DATABASES.items()
    )).encode()).hexdigest()[:16]


def ensure_test_databases(directory: Optional[str] = None) -> str:
    """Idempotently materialize the fixtures; returns the directory.

    Default location: ``<repo>/.geoip-fixtures-torch`` (gitignored, tiny;
    apart from the reference package's ``.geoip-fixtures`` so the two
    packages' tests never write the same files)."""
    if directory is None:
        directory = os.path.join(_REPO, ".geoip-fixtures-torch")
    stamp_path = os.path.join(directory, ".stamp")
    stamp = _fixture_stamp()
    stale = not all(
        os.path.exists(os.path.join(directory, name)) for name in _DATABASES
    )
    if not stale:
        try:
            with open(stamp_path) as f:
                stale = f.read().strip() != stamp
        except OSError:
            stale = True
    if stale:
        write_test_databases(directory)
        tmp = f"{stamp_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(stamp)
        os.replace(tmp, stamp_path)
    return directory


# ---------------------------------------------------------------------------
# A synthetic City database of realistic size, drawn from a seed.
# ---------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SYNTHETIC_NETWORKS = 131072
SYNTHETIC_CITIES = 5000
SYNTHETIC_COUNTRIES = 200


def synthetic_networks(n_networks: int, seed: int):
    """``n_networks`` distinct /24 networks drawn from ``seed``, sorted:
    their first addresses as a uint32 array (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 1 << 24, size=2 * n_networks + 64))
    picked = rng.choice(pool, size=n_networks, replace=False)
    return (np.sort(picked).astype(np.uint32) << np.uint32(8))


def synthetic_city_record(k: int) -> Dict[str, Any]:
    """City ``k`` (of SYNTHETIC_CITIES) in country ``k % SYNTHETIC_COUNTRIES``;
    every 7th name carries non-ASCII letters."""
    c = k % SYNTHETIC_COUNTRIES
    city = f"Synthville {k:04d}" + (" Sûd-Øst" if k % 7 == 0 else "")
    return {
        "city": {**_names(city), "geoname_id": 100000 + k},
        "country": {**_names(f"Country {c:03d}"),
                    "iso_code": chr(65 + c // 26 % 26) + chr(65 + c % 26)},
    }


def write_synthetic_city_database(path: str, n_networks: int, seed: int) -> str:
    """A GeoIP2-City database of ``n_networks`` disjoint /24 networks
    (``synthetic_networks``), network i assigned city ``rng`` draw of
    SYNTHETIC_CITIES names over SYNTHETIC_COUNTRIES countries."""
    import numpy as np

    nets = synthetic_networks(n_networks, seed)
    cities = np.random.default_rng(seed + 1).integers(0, SYNTHETIC_CITIES, size=n_networks)
    records = [synthetic_city_record(k) for k in range(SYNTHETIC_CITIES)]
    writer = MMDBWriter("GeoIP2-City")
    for net, k in zip(nets.tolist(), cities.tolist()):
        writer.insert(f"{str(ipaddress.IPv4Address(net))}/24", records[k])
    return writer.write(path)


def ensure_synthetic_city_database(n_networks: int = SYNTHETIC_NETWORKS, seed: int = 4,
                                   directory: Optional[str] = None) -> str:
    """The synthetic City database's path, written at first use into
    ``directory`` (default ``<repo>/.geoip-synthetic-torch``, gitignored)."""
    if directory is None:
        directory = os.path.join(_REPO, ".geoip-synthetic-torch")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"Synthetic-City-{n_networks}-s{seed}.mmdb")
    if not os.path.exists(path):
        write_synthetic_city_database(path, n_networks, seed)
    return path


def main() -> None:  # pragma: no cover - CLI convenience
    import argparse

    ap = argparse.ArgumentParser(
        description="Generate self-contained GeoIP test databases (.mmdb)"
    )
    ap.add_argument("directory", nargs="?", default=None)
    args = ap.parse_args()
    where = ensure_test_databases(args.directory)
    print(where)


if __name__ == "__main__":  # pragma: no cover
    main()
