"""Native host tier of the port: C++ line framing with a numpy fallback.

The port's own copy of the framing part of the reference package's
``native/__init__.py``.  ``encode_blob(data)`` turns newline-delimited
log bytes into the padded ``[B, L]`` uint8 buffer, int32 lengths and
overflow rows that the split kernel reads.  ``logframe.cc`` (next to this
file, outside ``csrc/`` so that ``nvcc`` never sees it) is compiled with
``g++`` at first use into ``_build/logframe-<digest>.so`` and bound with
ctypes; without a compiler the numpy fallback gives the same bytes,
slower.  :func:`framer` names which of the two frames.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional, Tuple

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
