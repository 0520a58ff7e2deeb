"""Pure-Python MaxMind-DB (.mmdb) reader (the port's own copy of the
reference package's ``geoip/mmdb.py``).

The reference uses com.maxmind.geoip2 ``DatabaseReader`` in MEMORY mode with a
CHM cache (AbstractGeoIPDissector.java:73-84).  No maxmind library is shipped
here, so this module implements the public MaxMind DB file format spec v2.0
directly: a binary search tree over IP bits, a type-tagged data section, and a
metadata map marked by ``\\xab\\xcd\\xefMaxMind.com`` at the end of the file.

Beyond per-IP lookup (the host/oracle path) the reader can *flatten* the tree
into sorted range tables (:meth:`MMDBReader.ipv4_ranges`) — the device-side
representation used by :mod:`logparser_tpu_torch.geoip.device` to run IP->geo joins
as a binary search per line on the card (the ``geo_lookup`` kernel)
instead of a per-row trie walk.
"""
from __future__ import annotations

import ipaddress
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

_METADATA_MARKER = b"\xab\xcd\xefMaxMind.com"

# Data-section type tags (MaxMind DB spec).
_T_EXTENDED = 0
_T_POINTER = 1
_T_UTF8 = 2
_T_DOUBLE = 3
_T_BYTES = 4
_T_UINT16 = 5
_T_UINT32 = 6
_T_MAP = 7
_T_INT32 = 8
_T_UINT64 = 9
_T_UINT128 = 10
_T_ARRAY = 11
_T_CONTAINER = 12
_T_END_MARKER = 13
_T_BOOL = 14
_T_FLOAT = 15


class InvalidDatabaseError(ValueError):
    pass


class _Decoder:
    """Decoder for the type-tagged data section."""

    def __init__(self, buf: bytes, base: int):
        self.buf = buf
        self.base = base  # absolute offset of the data section
        self._cache: Dict[int, Any] = {}

    def decode(self, offset: int) -> Any:
        """Decode the value at ``offset`` (relative to the data section)."""
        value, _ = self._decode(offset)
        return value

    def _decode(self, offset: int) -> Tuple[Any, int]:
        buf = self.buf
        pos = self.base + offset
        ctrl = buf[pos]
        pos += 1
        type_num = ctrl >> 5

        if type_num == _T_POINTER:
            return self._decode_pointer(ctrl, pos, offset)

        if type_num == _T_EXTENDED:
            type_num = buf[pos] + 7
            pos += 1

        size = ctrl & 0x1F
        if type_num != _T_BOOL:
            if size == 29:
                size = 29 + buf[pos]
                pos += 1
            elif size == 30:
                size = 285 + int.from_bytes(buf[pos : pos + 2], "big")
                pos += 2
            elif size == 31:
                size = 65821 + int.from_bytes(buf[pos : pos + 3], "big")
                pos += 3

        if type_num == _T_UTF8:
            value: Any = buf[pos : pos + size].decode("utf-8")
            pos += size
        elif type_num == _T_BYTES:
            value = bytes(buf[pos : pos + size])
            pos += size
        elif type_num == _T_DOUBLE:
            if size != 8:
                raise InvalidDatabaseError("double must be 8 bytes")
            value = struct.unpack_from(">d", buf, pos)[0]
            pos += 8
        elif type_num == _T_FLOAT:
            if size != 4:
                raise InvalidDatabaseError("float must be 4 bytes")
            value = struct.unpack_from(">f", buf, pos)[0]
            pos += 4
        elif type_num in (_T_UINT16, _T_UINT32, _T_UINT64, _T_UINT128, _T_INT32):
            value = int.from_bytes(buf[pos : pos + size], "big", signed=False)
            if type_num == _T_INT32 and size == 4 and value >= 1 << 31:
                value -= 1 << 32
            pos += size
        elif type_num == _T_BOOL:
            value = bool(size)
        elif type_num == _T_MAP:
            value = {}
            rel = pos - self.base
            for _ in range(size):
                key, rel = self._decode(rel)
                val, rel = self._decode(rel)
                value[key] = val
            pos = self.base + rel
        elif type_num == _T_ARRAY:
            value = []
            rel = pos - self.base
            for _ in range(size):
                item, rel = self._decode(rel)
                value.append(item)
            pos = self.base + rel
        elif type_num == _T_END_MARKER:
            value = None
        else:
            raise InvalidDatabaseError(f"unexpected type number {type_num}")

        return value, pos - self.base

    def _decode_pointer(
        self, ctrl: int, pos: int, offset: int
    ) -> Tuple[Any, int]:
        buf = self.buf
        pointer_size = (ctrl >> 3) & 0x3
        value_bits = ctrl & 0x7
        if pointer_size == 0:
            target = (value_bits << 8) | buf[pos]
            pos += 1
        elif pointer_size == 1:
            target = (value_bits << 16) | int.from_bytes(buf[pos : pos + 2], "big")
            target += 2048
            pos += 2
        elif pointer_size == 2:
            target = (value_bits << 24) | int.from_bytes(buf[pos : pos + 3], "big")
            target += 526336
            pos += 3
        else:
            target = int.from_bytes(buf[pos : pos + 4], "big")
            pos += 4
        if target in self._cache:
            value = self._cache[target]
        else:
            value, _ = self._decode(target)
            self._cache[target] = value
        return value, pos - self.base


class MMDBReader:
    """Memory-mode reader for one .mmdb file (lookup + tree flattening)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        marker_at = self.buf.rfind(_METADATA_MARKER)
        if marker_at < 0:
            raise InvalidDatabaseError(f"{path}: no MaxMind metadata marker")
        meta_decoder = _Decoder(self.buf, marker_at + len(_METADATA_MARKER))
        self.metadata: Dict[str, Any] = meta_decoder.decode(0)

        self.node_count: int = self.metadata["node_count"]
        self.record_size: int = self.metadata["record_size"]
        if self.record_size not in (24, 28, 32):
            raise InvalidDatabaseError(f"unsupported record size {self.record_size}")
        self.ip_version: int = self.metadata["ip_version"]
        self.node_bytes = self.record_size // 4  # 2 records per node
        self.tree_size = self.node_count * self.node_bytes
        # Data section starts after the tree plus a 16-byte zero separator.
        self._decoder = _Decoder(self.buf, self.tree_size + 16)
        self._ipv4_start: Optional[int] = None
        self._addr_cache: Dict[bytes, Optional[Dict[str, Any]]] = {}
        self._record_cache: Dict[int, Any] = {}

    @property
    def database_type(self) -> str:
        return self.metadata.get("database_type", "")

    # -- tree walking -------------------------------------------------------

    def _read_record(self, node: int, index: int) -> int:
        base = node * self.node_bytes
        buf = self.buf
        if self.record_size == 24:
            off = base + index * 3
            return int.from_bytes(buf[off : off + 3], "big")
        if self.record_size == 28:
            if index == 0:
                return ((buf[base + 3] & 0xF0) << 20) | int.from_bytes(
                    buf[base : base + 3], "big"
                )
            return ((buf[base + 3] & 0x0F) << 24) | int.from_bytes(
                buf[base + 4 : base + 7], "big"
            )
        off = base + index * 4
        return int.from_bytes(buf[off : off + 4], "big")

    def _ipv4_start_node(self) -> int:
        """Node reached after 96 zero bits (where IPv4 lives in a v6 tree)."""
        if self._ipv4_start is None:
            node = 0
            for _ in range(96):
                if node >= self.node_count:
                    break
                node = self._read_record(node, 0)
            self._ipv4_start = node
        return self._ipv4_start

    def lookup(self, ip: str) -> Optional[Dict[str, Any]]:
        """Look up one IP (string form); None when not found / bad input."""
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return None
        return self.lookup_address(addr)

    # Bound for the per-address result cache: real corpora repeat client
    # IPs heavily, so this converts the per-line tree walk + record decode
    # into one dict probe (the reference wraps its reader in a CHMCache
    # the same way, AbstractGeoIPDissector.java:73-84).  Crude clear-when-
    # full keeps the bound simple; refilling is one walk per address.
    _ADDR_CACHE_MAX = 65536

    def lookup_address(self, addr) -> Optional[Dict[str, Any]]:
        if addr.version == 6 and self.ip_version == 4:
            return None
        packed = addr.packed
        cache = self._addr_cache
        if packed in cache:
            return cache[packed]
        if addr.version == 4 and self.ip_version == 6:
            node = self._ipv4_start_node()
        else:
            node = 0
        bit_count = len(packed) * 8
        result: Optional[Dict[str, Any]] = None
        for i in range(bit_count):
            if node >= self.node_count:
                break
            bit = (packed[i >> 3] >> (7 - (i & 7))) & 1
            node = self._read_record(node, bit)
        if node > self.node_count:
            result = self._data_at(node)
        # node == node_count: no data; node < node_count: ran out of bits
        # inside the tree (shouldn't happen) — both cache as a miss.
        if len(cache) >= self._ADDR_CACHE_MAX:
            cache.clear()
        cache[packed] = result
        return result

    def _data_at(self, record: int) -> Any:
        # record - node_count - 16 is the offset inside the data section.
        # Distinct data records are few (shared by many ranges) — cache
        # decodes by offset, like the pointer cache inside the decoder.
        offset = record - self.node_count - 16
        if offset < 0:
            raise InvalidDatabaseError("record points into the separator")
        if offset in self._record_cache:
            return self._record_cache[offset]
        value = self._decoder.decode(offset)
        self._record_cache[offset] = value
        return value

    # -- flattening (device-side LPM tables) --------------------------------

    def networks(self) -> Iterator[Tuple[int, int, Any]]:
        """Yield ``(network_int, prefix_len, data)`` over the whole tree.

        ``network_int``/``prefix_len`` are in the tree's native bit width
        (128 for ip_version 6, 32 for 4).
        """
        total_bits = 128 if self.ip_version == 6 else 32
        stack: List[Tuple[int, int, int]] = [(0, 0, 0)]  # node, prefix, depth
        while stack:
            node, prefix, depth = stack.pop()
            if node == self.node_count:
                continue
            if node > self.node_count:
                yield prefix << (total_bits - depth) if depth else prefix, depth, (
                    self._data_at(node)
                )
                continue
            if depth >= total_bits:
                continue
            stack.append((self._read_record(node, 1), (prefix << 1) | 1, depth + 1))
            stack.append((self._read_record(node, 0), prefix << 1, depth + 1))

    def ipv4_ranges(self) -> List[Tuple[int, int, Any]]:
        """Flatten to sorted, disjoint IPv4 ``(start, end_inclusive, data)``.

        This is the LPM-free representation for the device join path: a sorted
        ``starts`` array + parallel ``ends``/row arrays, looked up per IP with
        a binary search (logparser_tpu_torch.geoip.device).
        """
        v4_mapped_prefix = 0  # v4 sits at ::/96 in a v6 tree
        out: List[Tuple[int, int, Any]] = []
        if self.ip_version == 4:
            for net, plen, data in self.networks():
                size = 1 << (32 - plen)
                out.append((net, net + size - 1, data))
        else:
            for net, plen, data in self.networks():
                if plen < 96:
                    # A shorter-than-96 prefix covering ::/96 also covers all
                    # of IPv4; clip to the v4 space if it contains it.
                    span = 1 << (128 - plen)
                    if net <= v4_mapped_prefix < net + span:
                        out.append((0, 0xFFFFFFFF, data))
                    continue
                if (net >> 32) != 0:
                    continue  # not inside ::/96
                size = 1 << (128 - plen)
                start = net & 0xFFFFFFFF
                out.append((start, start + size - 1, data))
        out.sort(key=lambda t: t[0])
        return out
