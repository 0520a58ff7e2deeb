"""Device-side IP->geo join: the flattened range table and its lookup.

The port of the reference package's ``geoip/device.py``.  The .mmdb
trie is flattened once on the host (:meth:`MMDBReader.ipv4_ranges`) into
parallel arrays

    starts[K]  uint32, sorted   range lower bounds
    ends[K]    uint32           inclusive upper bounds

plus one array per extracted column (row 0 = the miss row, row r = range
r - 1; string columns as vocabulary codes, the vocabulary stays on the
host).  A batch of IPv4 keys looks up its rows with one binary search per
key: the ``geo_lookup`` kernel on the card (``tpu/kernels.py``), and
:func:`lookup_rows_plain` -- ``torch.searchsorted`` in int64 -- as its
plain version.  The parser gathers the columns on the host at
materialization; :meth:`GeoDeviceTable.gather` is the public column
gather by looked-up row, :meth:`GeoDeviceTable.gather_columns` the same
for several columns at once (one ``geo_gather`` launch on the card,
:func:`geo_gather_plain` its plain version, column by column).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mmdb import MMDBReader

# Column extractors: path name -> fn(record dict) -> python value or None.
_EXTRACTORS: Dict[str, Callable[[Dict[str, Any]], Any]] = {
    "continent.code": lambda d: (d.get("continent") or {}).get("code"),
    "continent.name": lambda d: ((d.get("continent") or {}).get("names") or {}).get("en"),
    "country.iso": lambda d: (d.get("country") or {}).get("iso_code"),
    "country.name": lambda d: ((d.get("country") or {}).get("names") or {}).get("en"),
    "city.name": lambda d: ((d.get("city") or {}).get("names") or {}).get("en"),
    "postal.code": lambda d: (d.get("postal") or {}).get("code"),
    "location.latitude": lambda d: (d.get("location") or {}).get("latitude"),
    "location.longitude": lambda d: (d.get("location") or {}).get("longitude"),
    "location.timezone": lambda d: (d.get("location") or {}).get("time_zone"),
    "asn.number": lambda d: d.get("autonomous_system_number"),
    "asn.organization": lambda d: d.get("autonomous_system_organization"),
    "isp.name": lambda d: d.get("isp"),
    "isp.organization": lambda d: d.get("organization"),
}

_FLOAT_COLUMNS = {"location.latitude", "location.longitude"}
_INT_COLUMNS = {"asn.number"}


class GeoDeviceTable:
    """A flattened .mmdb: ``starts`` / ``ends`` (uint32 numpy) for the
    device join, and the host columns and vocabularies it indexes."""

    def __init__(self, reader: MMDBReader, columns: Sequence[str]):
        unknown = [c for c in columns if c not in _EXTRACTORS]
        if unknown:
            raise ValueError(f"unsupported geo columns: {unknown}")
        self.columns = list(columns)

        ranges = reader.ipv4_ranges()
        self.starts = np.asarray([r[0] for r in ranges], dtype=np.uint32)
        self.ends = np.asarray([r[1] for r in ranges], dtype=np.uint32)

        # Row 0 of every column array is the "miss" row.
        self.vocabs: Dict[str, List[Optional[str]]] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        for c in columns:
            values = [_EXTRACTORS[c](r[2]) for r in ranges]
            if c in _FLOAT_COLUMNS:
                self.arrays[c] = np.asarray(
                    [np.nan] + [np.nan if v is None else float(v) for v in values],
                    dtype=np.float32,
                )
            elif c in _INT_COLUMNS:
                self.arrays[c] = np.asarray(
                    [-1] + [-1 if v is None else int(v) for v in values],
                    dtype=np.int64,
                )
            else:
                vocab: List[Optional[str]] = [None]
                index: Dict[Optional[str], int] = {None: 0}
                codes = []
                for v in values:
                    if v not in index:
                        index[v] = len(vocab)
                        vocab.append(v)
                    codes.append(index[v])
                self.vocabs[c] = vocab
                self.arrays[c] = np.asarray([0] + codes, dtype=np.int32)
        # Object-array views of the vocabularies, built once: the batch
        # materializer indexes these per batch.
        self.vocab_arrays: Dict[str, np.ndarray] = {
            c: np.asarray(v, dtype=object) for c, v in self.vocabs.items()
        }
        self._device_arrays: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def gather(self, column: str, rows, device=None) -> torch.Tensor:
        """One column for looked-up rows: ``arrays[column][rows]`` [B] in
        the column's dtype (float32, int64 for ``asn.number``, int32
        vocabulary codes).  ``rows`` [B] int32 is a tensor or a numpy array
        (numpy goes to CUDA unless ``device`` says otherwise); on a CUDA
        tensor the ``geo_gather`` kernel gathers from a device copy of the
        column, made once per column and device.  Out-of-range rows follow
        the reference's rule (:func:`geo_gather_plain`)."""
        return self.gather_columns([column], rows, device)[column]

    def gather_columns(self, columns: Sequence[str], rows,
                       device=None) -> Dict[str, torch.Tensor]:
        """``{c: gather(c, rows) for c in columns}`` from one conversion of
        ``rows`` and one ``geo_gather`` launch for all the columns."""
        from ..tpu import kernels
        from ..tpu.runtime import device_tensor

        names = list(dict.fromkeys(columns))
        if not isinstance(rows, torch.Tensor):
            rows = np.asarray(rows, dtype=np.int32)
        rows = device_tensor(rows, device)
        if not names:
            return {}
        cols = []
        for c in names:
            key = (c, rows.device)
            col = self._device_arrays.get(key)
            if col is None:
                col = self._device_arrays[key] = torch.from_numpy(self.arrays[c]).to(rows.device)
            cols.append(col)
        return dict(zip(names, kernels.geo_gather(cols, rows)))

    def __getstate__(self):
        """The host arrays only: the device copies of the columns are made
        again on the host that loads a pickled parser."""
        state = self.__dict__.copy()
        state["_device_arrays"] = {}
        return state

    @classmethod
    def from_ranges(cls, starts: np.ndarray, ends: np.ndarray) -> "GeoDeviceTable":
        """A table of the ranges alone (no columns): what the device join
        reads, e.g. when a compiled parser is carried across as plain data."""
        table = cls.__new__(cls)
        table.columns = []
        table.starts = np.asarray(starts, dtype=np.uint32)
        table.ends = np.asarray(ends, dtype=np.uint32)
        table.vocabs, table.arrays, table.vocab_arrays = {}, {}, {}
        table._device_arrays = {}
        return table

    def __len__(self) -> int:
        return int(self.starts.shape[0])


def u32_bits(a: np.ndarray) -> torch.Tensor:
    """A uint32 numpy array as an int32 tensor of the same bit patterns
    (how the kernels take uint32 data)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def lookup_rows_plain(starts: torch.Tensor, ends: torch.Tensor,
                      keys: torch.Tensor) -> torch.Tensor:
    """The reference's ``GeoDeviceTable.lookup_rows`` in PyTorch: keys
    [B] (uint32 bit patterns in int32) against sorted ``starts`` / ``ends``
    [K] (the same) -> [B] int32 row, 0 = miss, row r = range r - 1.

    Compares in int64, because the keys are unsigned (an address at
    128.0.0.0 or above is negative as int32); an empty table misses every
    key."""
    K = starts.shape[0]
    if K == 0:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    mask = 0xFFFFFFFF
    s64 = starts.to(torch.int64) & mask
    e64 = ends.to(torch.int64) & mask
    k64 = keys.to(torch.int64) & mask
    pos = torch.searchsorted(s64, k64, right=True)
    idx = (pos - 1).clamp(0, K - 1)
    hit = (pos > 0) & (k64 <= e64[idx]) & (k64 >= s64[idx])
    return torch.where(hit, pos, 0).to(torch.int32)


def geo_gather_plain(column: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``column[rows]`` under the reference's gather rule: a negative row
    adds the column's length once, then every row clamps into [0, N - 1]
    (``[-1]`` reads the last entry, ``[-N - 4]`` the first, ``[N]`` the
    last)."""
    n = column.shape[0]
    idx = rows.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return column[idx]


def ipv4_to_u32(ips: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: dotted-quad strings -> (uint32 array, ok mask)."""
    out = np.zeros(len(ips), dtype=np.uint32)
    ok = np.zeros(len(ips), dtype=bool)
    for i, s in enumerate(ips):
        parts = s.split(".") if isinstance(s, str) else []
        if len(parts) == 4:
            try:
                vals = [int(p) for p in parts]
            except ValueError:
                continue
            if all(0 <= v <= 255 for v in vals):
                out[i] = (vals[0] << 24) | (vals[1] << 16) | (vals[2] << 8) | vals[3]
                ok[i] = True
    return out, ok
