"""Native host tier of the port: C++ framing and delivery passes with
numpy fallbacks.

The port's own copy of the reference package's ``native/__init__.py``.

- ``encode_blob(data)`` turns newline-delimited log bytes into the padded
  ``[B, L]`` uint8 buffer, int32 lengths and overflow rows that the split
  kernel reads; :func:`framer` names which of the two paths frames.
- The delivery passes of a fetched batch: ``gather_spans`` /
  ``gather_spans_multi`` (span columns as flat bytes + offsets),
  ``copy_spans`` / ``scatter_spans`` (flat re-layouts), ``build_views`` /
  ``views_interleave`` / ``patch_views`` (Arrow string_view structs from
  the batch buffer, from the device's view rows, or re-pointed at a side
  buffer), ``repair_spans`` and ``assemble_special`` (the URI repair of
  ``fix`` rows).  ``views_interleave``, ``repair_spans`` and
  ``assemble_special`` return None without the library (callers take
  their own numpy paths); the others fall back to numpy inside.

``logframe.cc`` (next to this file, outside ``csrc/`` so that ``nvcc``
never sees it) is compiled with ``g++`` at first use into
``_build/logframe-<digest>.so`` and bound with ctypes; without a compiler
the numpy fallbacks give the same bytes, slower.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "logframe.cc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_OVERFLOW_BIT = 1 << 30
_DEFAULT_THREADS = min(8, os.cpu_count() or 1)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_build_seconds: Optional[float] = None


def _compile_lib() -> Optional[str]:
    """The library's path, compiling it when this source's build is
    missing; None when ``g++`` is missing or fails."""
    global _build_seconds
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"logframe-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    t0 = time.perf_counter()
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    except (OSError, subprocess.SubprocessError):
        return None
    _build_seconds = time.perf_counter() - t0
    return so_path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded framing library, compiled on first use; None when it
    cannot be built or loaded (callers take the numpy fallback)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so_path = _compile_lib()
        try:
            lib = ctypes.CDLL(so_path) if so_path else None
        except OSError:
            lib = None
        if lib is None:
            _lib_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.lp_scan.argtypes = [u8p, ctypes.c_int64, i64p, i64p]
        lib.lp_scan.restype = None
        lib.lp_frame.argtypes = [u8p, ctypes.c_int64, i64p, i32p, ctypes.c_int64]
        lib.lp_frame.restype = ctypes.c_int64
        lib.lp_pack.argtypes = [u8p, i64p, i32p, ctypes.c_int64, u8p, i32p,
                                ctypes.c_int64, ctypes.c_int32]
        lib.lp_pack.restype = None
        lib.lp_frame_pack.argtypes = [u8p, ctypes.c_int64, u8p, i32p,
                                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
        lib.lp_frame_pack.restype = ctypes.c_int64
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        sigs = {
            "lp_gather_spans": [u8p, i64, i64, i32p, i64p, u8p, i32],
            "lp_gather_spans_multi": [u8p, i64, i64, i32p, i64p, u8p, i64, i32],
            "lp_copy_spans": [u8p, i64p, u8p, i64p, i64, i32],
            "lp_scatter_spans": [u8p, i64p, i64p, u8p, i64p, i64, i32],
            "lp_build_views": [u8p, i64, i64, i32p, i32p, u8p, i64, i32],
            "lp_patch_views": [u8p, i64p, i64p, i64, i32, u8p],
            "lp_views_interleave": [i32p, i64, i64p, i64, i64, i64, u8p, i32],
            "lp_special_scan": [u8p, i64, i32p, i64p, i64p, u8p, u8p, i64, i32,
                                u8p, i64p, u8p, i32],
            "lp_special_write": [u8p, i64, i32p, i64p, i64p, u8p, u8p, i64, i32,
                                 u8p, i64p, u8p, u8p, u8p, i32, i32],
            "lp_repair_scan": [u8p, i64p, i64, i32, u8p, i64p, u8p, i32],
            "lp_repair_write": [u8p, i64p, i64, i32, u8p, i64p, u8p, u8p, i32],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def framer() -> str:
    """``"native"`` when the C++ framer is in use, else ``"numpy"``."""
    return "native" if native_available() else "numpy"


def build_seconds() -> Optional[float]:
    """Wall seconds of this process's ``g++`` build of the framer (None
    when it found a build already made, or none could be made)."""
    return _build_seconds


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8_or_one(arr: np.ndarray):
    """``_u8`` of ``arr``, or of a one-byte placeholder when it is empty
    (ctypes wants a real pointer)."""
    return _u8(arr if len(arr) else np.zeros(1, np.uint8))


def _default_threads() -> int:
    return _DEFAULT_THREADS


def _bucket(max_len: int, min_bucket: int, cap: int) -> int:
    """The one bucket rule (``tpu.runtime.bucket_length`` calls it): the
    smallest bucket >= max_len (>= min_bucket, <= cap) among powers of two
    up to 128, multiples of 128 up to 512, multiples of 256 up to 1024,
    then powers of two up to cap."""
    if max_len <= min_bucket:
        return min_bucket
    if max_len <= 128:
        return 128 if min_bucket < 128 else min_bucket
    if max_len <= 512:
        size = -(-max_len // 128) * 128
    elif max_len <= 1024:
        size = -(-max_len // 256) * 256
    else:
        size = 2048
        while size < max_len:
            size *= 2
    return min(size, cap)


def _count_lines(chunk: bytes) -> int:
    """``encode_blob``'s line count without framing: a trailing newline
    ends the last line, it never starts a new one."""
    if not chunk:
        return 0
    n = chunk.count(b"\n")
    return n if chunk.endswith(b"\n") else n + 1


def encode_blob(
    data: bytes,
    line_len: int = 0,
    min_bucket: int = 64,
    cap: int = 8191,  # tpu.runtime.DEFAULT_MAX_LINE_LEN (13-bit span slots)
    threads: int = 0,
    alloc=None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Newline-delimited bytes -> (buf [B, L] uint8, lengths [B] int32,
    overflow row indices).  L is the bucket of the longest line (<= cap)
    unless ``line_len`` pins it.

    ``alloc(n, L) -> (buf [n, L] uint8, lengths [n] int32)`` supplies the
    destination arrays (the parser frames straight into pinned host
    memory).  The native path writes every byte of rows [0, n), so the
    destination needs no zeroing; only the empty blob's placeholder row is
    cleared.  The overflow bit is stripped from the lengths in place."""
    blob = np.frombuffer(data, dtype=np.uint8)
    lib = get_lib()
    if lib is None:
        return _encode_blob_numpy(data, line_len, min_bucket, cap, alloc)
    n_lines = ctypes.c_int64()
    max_len = ctypes.c_int64()
    lib.lp_scan(_u8(blob), blob.size, ctypes.byref(n_lines), ctypes.byref(max_len))
    n = n_lines.value
    L = _bucket(max_len.value, min_bucket, cap) if line_len <= 0 else line_len
    if alloc is not None:
        buf, lengths = alloc(max(n, 1), L)
        if n == 0:  # the placeholder row lp_pack never touches
            buf[:] = 0
            lengths[:] = 0
    else:
        buf = np.zeros((max(n, 1), L), dtype=np.uint8)
        lengths = np.zeros(max(n, 1), dtype=np.int32)
    if n:
        lib.lp_frame_pack(_u8(blob), blob.size, _u8(buf),
                          lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          n, L, threads or _DEFAULT_THREADS)
    overflow = np.nonzero(lengths & _OVERFLOW_BIT)[0]
    lengths &= ~_OVERFLOW_BIT
    return buf[:n], lengths[:n], [int(i) for i in overflow if i < n]


def _encode_blob_numpy(
    data: bytes, line_len: int, min_bucket: int, cap: int, alloc=None
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """The numpy fallback, with the same semantics."""
    lines = bytes(data).split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    lines = [ln[:-1] if ln.endswith(b"\r") else ln for ln in lines]
    max_len = max((len(r) for r in lines), default=1)
    L = _bucket(max_len, min_bucket, cap) if line_len <= 0 else line_len
    if alloc is not None:
        buf, lengths = alloc(max(len(lines), 1), L)
        buf[:] = 0
        lengths[:] = 0
    else:
        buf = np.zeros((max(len(lines), 1), L), dtype=np.uint8)
        lengths = np.zeros(max(len(lines), 1), dtype=np.int32)
    overflow: List[int] = []
    for i, r in enumerate(lines):
        if len(r) > L:
            overflow.append(i)
            r = r[:L]
        buf[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
        lengths[i] = len(r)
    return buf[: len(lines)], lengths[: len(lines)], overflow


# ---------------------------------------------------------------------------
# Delivery passes over a fetched batch (BatchResult.span_bytes[_many] and
# tpu/arrow_bridge.py).
# ---------------------------------------------------------------------------


def gather_spans(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row spans of a [B, L] buffer as one flat byte array: (data,
    offsets int64 [B+1]); row r's bytes are ``data[offsets[r]:offsets[r+1]]``
    and rows with ``lens[r] == 0`` are empty.  The library's threaded
    memcpy fan-out, else a numpy repeat-index gather."""
    B, L = buf.shape
    lens64 = np.asarray(lens, dtype=np.int64)
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(lens64, out=offsets[1:])
    total = int(offsets[-1])
    starts32 = np.ascontiguousarray(starts, dtype=np.int32)
    buf_c = np.ascontiguousarray(buf)
    lib = get_lib()
    if lib is not None:
        data = np.empty(total, dtype=np.uint8)
        lib.lp_gather_spans(_u8(buf_c), B, L, _i32p(starts32), _i64p(offsets),
                            _u8(data), threads or _DEFAULT_THREADS)
        return data, offsets
    row_base = np.arange(B, dtype=np.int64) * L + starts32
    idx = np.repeat(row_base - offsets[:-1], lens64) + np.arange(total, dtype=np.int64)
    return buf_c.reshape(-1)[idx], offsets


def gather_spans_multi(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                       threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """K span columns of one [B, L] buffer in one call.  ``starts`` and
    ``lens`` are [K, B]; returns (data, offsets int64 [K*B+1]): column k's
    offsets are ``offsets[k*B : k*B+B+1]`` (less ``offsets[k*B]`` for
    column-local ones) and its bytes the matching contiguous slice of
    ``data``.  One threaded fan-out covers every column."""
    K, B = starts.shape
    L = buf.shape[1]
    lens64 = np.asarray(lens, dtype=np.int64).reshape(-1)
    offsets = np.zeros(K * B + 1, dtype=np.int64)
    np.cumsum(lens64, out=offsets[1:])
    total = int(offsets[-1])
    starts32 = np.ascontiguousarray(starts, dtype=np.int32).reshape(-1)
    buf_c = np.ascontiguousarray(buf)
    lib = get_lib()
    if lib is not None:
        data = np.empty(total, dtype=np.uint8)
        lib.lp_gather_spans_multi(_u8(buf_c), B, L, _i32p(starts32), _i64p(offsets),
                                  _u8(data), K, threads or _DEFAULT_THREADS)
        return data, offsets
    row_base = np.tile(np.arange(B, dtype=np.int64) * L, K) + starts32
    idx = np.repeat(row_base - offsets[:-1], lens64) + np.arange(total, dtype=np.int64)
    return buf_c.reshape(-1)[idx], offsets


def copy_spans(src: np.ndarray, src_off: np.ndarray, dst_off: np.ndarray,
               threads: int = 0) -> np.ndarray:
    """Per-row flat re-layout: ``out[dst_off[r]:dst_off[r+1]] ==
    src[src_off[r]:src_off[r] + len_r]``, the lengths from ``dst_off``."""
    if src.dtype != np.uint8:
        raise TypeError(f"copy_spans needs uint8 src, got {src.dtype}")
    n = len(dst_off) - 1
    total = int(dst_off[-1])
    src_off64 = np.ascontiguousarray(src_off, dtype=np.int64)
    dst_off64 = np.ascontiguousarray(dst_off, dtype=np.int64)
    src_c = np.ascontiguousarray(src)
    lib = get_lib()
    if lib is not None:
        out = np.empty(total, dtype=np.uint8)
        lib.lp_copy_spans(_u8_or_one(src_c), _i64p(src_off64), _u8_or_one(out),
                          _i64p(dst_off64), n, threads or _DEFAULT_THREADS)
        return out
    lens = np.diff(dst_off64)
    idx = np.repeat(src_off64 - dst_off64[:-1], lens) + np.arange(total, dtype=np.int64)
    return src_c[idx]


def scatter_spans(src: np.ndarray, src_off: np.ndarray, lens: np.ndarray,
                  out: np.ndarray, dst_off: np.ndarray, threads: int = 0) -> None:
    """``out[dst_off[r]:dst_off[r] + lens[r]] = src[src_off[r]:...]`` into a
    caller's flat buffer: explicit lengths, and ``dst_off`` need not be
    contiguous, so row subsets interleave into one side buffer."""
    if src.dtype != np.uint8 or out.dtype != np.uint8:
        raise TypeError("scatter_spans needs uint8 src/out")
    n = len(lens)
    if n == 0:
        return
    src_off64 = np.ascontiguousarray(src_off, dtype=np.int64)
    dst_off64 = np.ascontiguousarray(dst_off, dtype=np.int64)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    src_c = np.ascontiguousarray(src)
    lib = get_lib()
    if lib is not None:
        lib.lp_scatter_spans(_u8_or_one(src_c), _i64p(src_off64), _i64p(lens64),
                             _u8_or_one(out), _i64p(dst_off64), n,
                             threads or _DEFAULT_THREADS)
        return
    live = lens64 > 0
    if not live.any():
        return
    sl = lens64[live]
    src_idx = np.repeat(src_off64[live], sl) + _ramp(sl)
    dst_idx = np.repeat(dst_off64[live], sl) + _ramp(sl)
    out[dst_idx] = src_c[src_idx]


def _ramp(lens: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] for positive lens."""
    total = int(lens.sum())
    ends = np.cumsum(lens)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)


def build_views(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                threads: int = 0) -> np.ndarray:
    """Arrow string_view structs of K span columns of a [B, L] buffer.

    ``starts`` / ``lens`` are [K, B] (``lens < 0``: a null row, zeroed
    view).  Returns [K, B, 16] uint8: a string of <= 12 bytes is inline,
    a longer one references the flattened buffer at ``r*L + start``
    (buffer index 0), so no value byte is copied.  B*L must be < 2^31."""
    starts2 = np.ascontiguousarray(starts, dtype=np.int32)
    K, B = starts2.shape
    L = buf.shape[1]
    if B * L >= 2**31:
        raise ValueError("buffer too large for int32 view offsets")
    lens2 = np.ascontiguousarray(lens, dtype=np.int32)
    buf_c = np.ascontiguousarray(buf)
    views = _pooled_empty_u8(K * B * 16)
    lib = get_lib()
    if lib is not None:
        lib.lp_build_views(_u8_or_one(buf_c.reshape(-1)), B, L, _i32p(starts2),
                           _i32p(lens2), _u8_or_one(views), K,
                           threads or _DEFAULT_THREADS)
        return views.reshape(K, B, 16)
    views = views.reshape(K * B, 16)
    views[:] = 0
    flat = buf_c.reshape(-1)
    sf = starts2.reshape(-1).astype(np.int64)
    lf = lens2.reshape(-1).astype(np.int64)
    live = lf >= 0
    ln = np.where(live, lf, 0)
    vi32 = views.view(np.int32).reshape(K * B, 4)
    vi32[live, 0] = ln[live].astype(np.int32)
    abs_off = np.tile(np.arange(B, dtype=np.int64) * L, K) + sf
    if flat.size:
        idx = np.minimum(abs_off[:, None] + np.arange(12), flat.size - 1)
        first12 = flat[idx]
        mask = np.arange(12)[None, :] < np.minimum(ln, 12)[:, None]
        views[:, 4:16] = np.where(mask & live[:, None], first12, 0)
    long_rows = live & (lf > 12)
    vi32[long_rows, 2] = 0
    vi32[long_rows, 3] = abs_off[long_rows].astype(np.int32)
    return views.reshape(K, B, 16)


def patch_views(views: np.ndarray, rows: np.ndarray, side: np.ndarray,
                side_off: np.ndarray, buffer_index: int) -> None:
    """Re-point rows of a [B, 16] view array at a side buffer (repaired
    or overridden values): entry j is ``side[side_off[j]:side_off[j+1]]``
    for row ``rows[j]``, referenced as data buffer ``buffer_index``."""
    n = rows.size
    if n == 0:
        return
    lib = get_lib()
    if lib is not None:
        rows64 = np.ascontiguousarray(rows, dtype=np.int64)
        side_c = np.ascontiguousarray(side)
        off64 = np.ascontiguousarray(side_off, dtype=np.int64)
        lib.lp_patch_views(_u8_or_one(side_c), _i64p(off64), _i64p(rows64), n,
                           buffer_index, _u8(views))
        return
    lens = np.diff(side_off).astype(np.int64)
    sub = np.zeros((n, 16), dtype=np.uint8)
    v32 = sub.view(np.int32).reshape(n, 4)
    v32[:, 0] = lens.astype(np.int32)
    if len(side):
        idx = np.minimum(side_off[:-1, None] + np.arange(12), len(side) - 1)
        first12 = side[idx]
        mask = np.arange(12)[None, :] < np.minimum(lens, 12)[:, None]
        sub[:, 4:16] = np.where(mask, first12, 0)
    long_rows = lens > 12
    v32[long_rows, 2] = buffer_index
    v32[long_rows, 3] = side_off[:-1][long_rows].astype(np.int32)
    views[rows] = sub


def repair_spans(seg: np.ndarray, seg_off: np.ndarray, escape_mode: bool,
                 enc_table: np.ndarray, threads: int = 0):
    """The URI repair of n concatenated segments: (out_flat, out_lens
    int64 [n], py_flags bool [n]).  A py-flagged row (a byte >= 0x80, or
    in decode mode an escape decoding to one) is empty in ``out_flat``
    and must be repaired in Python.  None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(seg_off) - 1
    seg_c = np.ascontiguousarray(seg)
    off64 = np.ascontiguousarray(seg_off, dtype=np.int64)
    enc_c = np.ascontiguousarray(enc_table, dtype=np.uint8)
    out_lens = np.empty(n, dtype=np.int64)
    py_flags = np.empty(n, dtype=np.uint8)
    mode = 1 if escape_mode else 0
    nthreads = threads or _DEFAULT_THREADS
    lib.lp_repair_scan(_u8_or_one(seg_c), _i64p(off64), n, mode, _u8(enc_c),
                       _i64p(out_lens), _u8_or_one(py_flags), nthreads)
    out_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_lens, out=out_off[1:])
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    lib.lp_repair_write(_u8_or_one(seg_c), _i64p(off64), n, mode, _u8(enc_c),
                        _i64p(out_off), _u8_or_one(py_flags), _u8_or_one(out),
                        nthreads)
    return out, out_lens, py_flags.astype(bool)


# Output-buffer pool for the fixed-size per-batch view arrays: a fresh
# np.empty of a few MB pays its page faults on every call.  An entry is
# reused only when nothing else holds it -- an Arrow buffer built on a
# pooled array keeps a reference, so a live table blocks reuse (the
# refcount check).  The exact refcount assumes GIL-serialized counting:
# on a free-threaded build the pool is off and every call allocates.
_BUF_POOL: Dict[int, np.ndarray] = {}
_BUF_POOL_MAX = 16
_BUF_POOL_ENABLED = getattr(sys, "_is_gil_enabled", lambda: True)()


def _pooled_empty_u8(n: int) -> np.ndarray:
    if not _BUF_POOL_ENABLED:
        return np.empty(n, dtype=np.uint8)
    arr = _BUF_POOL.get(n)
    # 3 == the dict entry + the local binding + getrefcount's argument.
    if arr is not None and sys.getrefcount(arr) == 3:
        return arr
    if len(_BUF_POOL) >= _BUF_POOL_MAX:
        _BUF_POOL.clear()
    arr = np.empty(n, dtype=np.uint8)
    _BUF_POOL[n] = arr
    return arr


def views_interleave(packed: np.ndarray, field_rows: np.ndarray, B: int, L: int,
                     threads: int = 0):
    """The device's view rows -> [F, B, 16] Arrow string_view structs.

    ``packed`` is a fetched [R, stride] int32 block; ``field_rows`` holds,
    per span field, the row of its merged span word (start | len << 13 |
    live << 26); the next three rows carry the span's first 12 bytes,
    little-endian.  None without the library, for a non-contiguous or
    non-int32 block, or where B*L would wrap the int32 offsets (callers
    then build the views on the host)."""
    lib = get_lib()
    if lib is None:
        return None
    if packed.dtype != np.int32 or not packed.flags.c_contiguous:
        return None
    if B * L >= 2**31:
        return None
    F = field_rows.size
    rows64 = np.ascontiguousarray(field_rows, dtype=np.int64)
    out = _pooled_empty_u8(F * B * 16)
    lib.lp_views_interleave(_i32p(packed), packed.shape[1], _i64p(rows64), F, B, L,
                            _u8_or_one(out), threads or _DEFAULT_THREADS)
    return out.reshape(F, B, 16)


def assemble_special(buf: np.ndarray, starts: np.ndarray, rows: np.ndarray,
                     span_lens: np.ndarray, fix_flags: np.ndarray,
                     amp_flags: np.ndarray, mode: int, enc_table: np.ndarray,
                     views: np.ndarray, buffer_index: int, threads: int = 0):
    """The side buffer of a view column's special rows (URI-repair ``fix``
    and ``amp`` query normalization) built and patched into ``views``
    ([B, 16], in place) in one scan + write pass from the [B, L] buffer.

    Returns (side, side_off, py_flags): py-flagged rows (exact Python UTF-8
    semantics) are empty in ``side`` and not patched -- the caller repairs
    and patches them.  ``"overflow"`` when the side buffer would pass the
    int32 view offsets; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n = rows.size
    L = buf.shape[1]
    buf_c = np.ascontiguousarray(buf)
    starts32 = np.ascontiguousarray(starts, dtype=np.int32)
    rows64 = np.ascontiguousarray(rows, dtype=np.int64)
    lens64 = np.ascontiguousarray(span_lens, dtype=np.int64)
    fix_u8 = np.ascontiguousarray(fix_flags, dtype=np.uint8)
    amp_u8 = np.ascontiguousarray(amp_flags, dtype=np.uint8)
    enc_c = np.ascontiguousarray(enc_table, dtype=np.uint8)
    out_lens = np.empty(n, dtype=np.int64)
    py_flags = np.empty(n, dtype=np.uint8)
    nthreads = threads or _DEFAULT_THREADS
    lib.lp_special_scan(_u8_or_one(buf_c.reshape(-1)), L, _i32p(starts32),
                        _i64p(rows64), _i64p(lens64), _u8_or_one(fix_u8),
                        _u8_or_one(amp_u8), n, mode, _u8(enc_c), _i64p(out_lens),
                        _u8_or_one(py_flags), nthreads)
    side_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_lens, out=side_off[1:])
    if int(side_off[-1]) >= 2**31:
        return "overflow"
    side = np.empty(int(side_off[-1]), dtype=np.uint8)
    lib.lp_special_write(_u8_or_one(buf_c.reshape(-1)), L, _i32p(starts32),
                         _i64p(rows64), _i64p(lens64), _u8_or_one(fix_u8),
                         _u8_or_one(amp_u8), n, mode, _u8(enc_c), _i64p(side_off),
                         _u8_or_one(py_flags), _u8_or_one(side), _u8(views),
                         buffer_index, nthreads)
    return side, side_off, py_flags.astype(bool)
