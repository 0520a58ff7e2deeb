"""The compile cache: the kernels' shared libraries as durable,
shareable artifacts.

The port has no per-shape executables: one shared library per kernel
(``nvcc`` for ``sm_90a``, ``tpu/kernels.py``) serves every batch size and
line bucket, so what costs set-up time is the ``nvcc`` run, and what this
module stores is its output.

- :class:`CompileCache` is the content-addressed on-disk store (the
  ``LOGPARSER_TPU_COMPILE_CACHE`` directory).  An entry's key
  (:func:`library_key`) hashes the sources' digest
  (``kernels.source_digest()``), the kernel, and the backend
  (:func:`backend_fingerprint`: ``sm_90a``, the ``nvcc`` version, the
  torch and CUDA runtime versions, the card's name) -- a mismatch on any
  of them is a miss and a fresh build, never a wrong library.  A read
  checks magic, header, key, backend and payload digest; a refused entry
  counts ``compile_cache_errors_total{kind}`` and warns once.  A write
  that fails degrades to no cache.
- ``kernels.build()`` resolves each library from the process, then
  ``csrc/_build/<digest>/``, then this cache, then ``nvcc``, and writes
  what ``nvcc`` built back here.
- Artifacts (``TorchBatchParser.to_bytes``) embed the libraries with their
  backend, so a host that loads one runs its first batch without ``nvcc``.
- :func:`stable_hash` / :func:`code_fingerprint` give the parser's
  content fingerprint (``TorchBatchParser.executor_fingerprint``), stable
  across processes.

The entry magic differs from the reference package's, so neither package
ever reads the other's entries.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import time
from dataclasses import is_dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

ENV_CACHE_DIR = "LOGPARSER_TPU_COMPILE_CACHE"

# Entry format version: bump when the on-disk layout changes.  Old entries
# then simply miss (refused by magic), they are never misread.
_ENTRY_MAGIC = b"LPTORCH-KLIB-v1\n"

#: The architecture every kernel is built for.
ARCH = "sm_90a"

# Batch sizes ``TorchBatchParser.prewarm`` runs by default: the sizes
# serving traffic hits (service chunks, feeder chunks, coalesced
# batches).
DEFAULT_BUCKET_LADDER = (64, 256, 1024)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

_TPU = Path(__file__).resolve().parent
_CSRC = _TPU.parent / "csrc"
_code_fp: Optional[str] = None
_code_fp_lock = threading.Lock()


def code_fingerprint() -> str:
    """Content hash of the device pipeline's sources (``tpu/*.py`` and the
    kernels' ``csrc``).  Any edit to the code that shapes the device
    pass changes every fingerprint -- coarse, but it never reuses a
    stale plan."""
    global _code_fp
    if _code_fp is None:
        with _code_fp_lock:
            if _code_fp is None:
                h = hashlib.blake2b(digest_size=12)
                paths = sorted(_TPU.glob("*.py")) + sorted(_CSRC.glob("*.cu*"))
                for path in paths:
                    h.update(path.name.encode())
                    h.update(path.read_bytes())
                _code_fp = h.hexdigest()
    return _code_fp


def nvcc_path() -> Optional[str]:
    """The ``nvcc`` the kernels build with: ``$CUDA_HOME/bin/nvcc``
    (``/usr/local/cuda`` without ``CUDA_HOME``), else the first on
    ``PATH``; None where there is none."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else shutil.which("nvcc")


_NVCC_VERSION: Dict[Optional[str], Optional[str]] = {}


def nvcc_version() -> Optional[str]:
    """The release line of ``nvcc --version`` (``V12.4.131``), or None
    where there is no ``nvcc``."""
    path = nvcc_path()
    if path not in _NVCC_VERSION:
        version = None
        if path is not None:
            try:
                out = subprocess.run([path, "--version"], capture_output=True,
                                     text=True, timeout=60).stdout
                lines = [ln for ln in out.splitlines() if "release" in ln]
                version = (lines[-1].rsplit(",", 1)[-1].strip() if lines
                           else out.strip().splitlines()[-1] if out.strip() else "unknown")
            except (OSError, subprocess.SubprocessError):
                version = "unknown"
        _NVCC_VERSION[path] = version
    return _NVCC_VERSION[path]


def backend_components() -> Dict[str, Optional[str]]:
    """What a built library is only valid for: the architecture, the
    ``nvcc`` that built it, the torch and CUDA runtime versions, and the
    card's name ("none" without a card).  Touches no card where CUDA is
    absent."""
    import torch

    device = "none"
    if torch.cuda.is_available():
        device = torch.cuda.get_device_name(0)
    return {"arch": ARCH, "nvcc": nvcc_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "device": device}


def backend_fingerprint(components: Optional[Dict[str, Optional[str]]] = None) -> str:
    c = backend_components() if components is None else components
    return ";".join(f"{k}={c.get(k)}" for k in ("arch", "nvcc", "torch", "cuda", "device"))


def cuda_driver_version() -> Optional[Tuple[int, int]]:
    """The CUDA version the installed driver supports (``cuDriverGetVersion``
    of ``libcuda``), as (major, minor); None where there is no driver."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
        out = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(out)) != 0:
            return None
    except (OSError, AttributeError):
        return None
    return out.value // 1000, (out.value % 1000) // 10


def nvcc_release(version: Optional[str]) -> Optional[Tuple[int, int]]:
    """``V12.4.131`` -> (12, 4); None for anything else."""
    m = re.match(r"V?(\d+)\.(\d+)", version or "")
    return (int(m.group(1)), int(m.group(2))) if m else None


def backend_matches(recorded: Dict[str, Optional[str]]) -> bool:
    """May a library built under ``recorded`` run here?  Every component
    must equal this host's.  On a host with no ``nvcc`` (which could build
    no other library) the recorded ``nvcc`` is held to what the library
    needs of the host instead: a driver that supports that toolkit's CUDA
    release.  An unknown release, or no driver, is a mismatch."""
    here = backend_components()
    for key, value in here.items():
        if key == "nvcc" and value is None:
            needs, driver = nvcc_release(recorded.get("nvcc")), cuda_driver_version()
            if needs is None or driver is None or needs > driver:
                return False
        elif recorded.get(key) != value:
            return False
    return True


def library_key(digest: str, kernel: str,
                components: Optional[Dict[str, Optional[str]]] = None) -> str:
    """The cache key of one kernel's library: its sources' digest, its
    name and the backend."""
    raw = f"{digest}|{kernel}|{backend_fingerprint(components)}"
    return hashlib.blake2b(raw.encode(), digest_size=20).hexdigest()


def _tensor_bytes(x: Any) -> Optional[bytes]:
    """A torch tensor's dtype, shape and bytes (wherever it lives), or
    None for anything else."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(x, torch.Tensor):
        return None
    t = x.detach().cpu().contiguous().reshape(-1)
    return (f"tensor:{t.dtype}:{tuple(x.shape)}:".encode()
            + t.view(torch.uint8).numpy().tobytes())


def _slot_names(x: Any) -> tuple:
    """All ``__slots__`` names across the MRO (``__slots__`` may be a
    bare string), minus the pseudo-slots."""
    names = []
    for klass in type(x).__mro__:
        slots = klass.__dict__.get("__slots__", ())
        if isinstance(slots, str):
            slots = (slots,)
        names.extend(s for s in slots if s not in ("__dict__", "__weakref__"))
    return tuple(names)


def stable_hash(obj: Any, digest_size: int = 16) -> str:
    """Deterministic cross-process content hash of a (mostly) pure-data
    object graph: primitives, containers, numpy arrays, dataclasses and
    plain ``__dict__``/``__slots__`` objects, and torch tensors by dtype,
    shape and bytes.  Sets are sorted by repr;
    anything opaque hashes by type name + repr — possibly
    process-unstable, which can only cost a cache miss, never a wrong
    hit."""
    h = hashlib.blake2b(digest_size=digest_size)

    def feed(x: Any, depth: int = 0) -> None:
        if depth > 24:
            h.update(b"<deep>")
            return
        if x is None or isinstance(x, (bool, int, float, str, bytes)):
            h.update(repr(x).encode())
        elif isinstance(x, np.ndarray):
            h.update(f"nd:{x.dtype}:{x.shape}".encode())
            if x.dtype == object:
                # An object array's bytes are pointers: hash its items.
                feed(x.tolist(), depth + 1)
            else:
                h.update(np.ascontiguousarray(x).tobytes())
        elif _tensor_bytes(x) is not None:
            # By content, wherever it lives (a table on the card hashes
            # like its host copy).
            h.update(_tensor_bytes(x))
        elif isinstance(x, np.generic):
            h.update(repr(x.item()).encode())
        elif isinstance(x, (list, tuple)):
            h.update(f"seq{len(x)}(".encode())
            for item in x:
                feed(item, depth + 1)
                h.update(b",")
            h.update(b")")
        elif isinstance(x, dict):
            h.update(f"map{len(x)}(".encode())
            for k in sorted(x, key=repr):
                feed(k, depth + 1)
                h.update(b"=")
                feed(x[k], depth + 1)
                h.update(b",")
            h.update(b")")
        elif isinstance(x, (set, frozenset)):
            h.update(f"set{len(x)}(".encode())
            for item in sorted(x, key=repr):
                feed(item, depth + 1)
                h.update(b",")
            h.update(b")")
        elif is_dataclass(x) or hasattr(x, "__dict__") or _slot_names(x):
            # __slots__ classes have no __dict__; without this branch
            # they would fall through to the default repr, whose memory
            # address makes the fingerprint process-unique (locale
            # tables under TIME fields are such objects).
            h.update(type(x).__name__.encode())
            custom = type(x).__getstate__ is not object.__getstate__
            got = x.__getstate__() if custom else None
            # A class's own __getstate__ says what its content is (device
            # caches left out).
            state = dict(got if isinstance(got, dict) else getattr(x, "__dict__", {}))
            for slot in _slot_names(x):
                if hasattr(x, slot):
                    state[slot] = getattr(x, slot)
            feed(state, depth + 1)
        else:
            h.update(f"{type(x).__name__}:{x!r}".encode())

    feed(obj)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the on-disk store
# ---------------------------------------------------------------------------


def _metrics():
    from ..observability import metrics

    return metrics()


def _warn_once(message: str) -> None:
    from ..observability import log_warning_once

    log_warning_once(logger, message)


class CompileCache:
    """Content-addressed store of the kernels' shared libraries: one file
    per key (:func:`library_key`: the sources' digest, the kernel and the
    backend) under the cache root.  Writes are atomic (tmp + rename);
    reads verify magic, header, key, backend and payload digest -- a
    corrupted, renamed or drifted entry is refused (a miss, a warning
    once, ``compile_cache_errors_total{kind}``), never loaded."""

    def __init__(self, root: Optional[str]) -> None:
        self.root = root or None

    @classmethod
    def from_env(cls) -> "CompileCache":
        return cls(os.environ.get(ENV_CACHE_DIR) or None)

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def _path(self, key: str) -> str:
        assert self.root is not None
        return os.path.join(self.root, key[:2], f"{key}.so.entry")

    # -- read ------------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        """The library bytes stored under ``key``, or None.  Every failure
        mode (missing, corrupt, drift) is a miss."""
        if not self.enabled:
            return None
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except OSError as exc:
            _metrics().increment("compile_cache_errors_total",
                                 labels={"kind": "io"})
            _warn_once(f"compile cache read failed ({path}): {exc}")
            return None
        entry = self._decode(blob, key, path)
        return entry

    def _decode(self, blob: bytes, key: str, path: str) -> Optional[bytes]:
        reg = _metrics()
        if not blob.startswith(_ENTRY_MAGIC):
            reg.increment("compile_cache_errors_total",
                          labels={"kind": "magic"})
            _warn_once(f"compile cache entry refused (bad magic): {path}")
            return None
        try:
            off = len(_ENTRY_MAGIC)
            (hlen,) = struct.unpack("<I", blob[off:off + 4])
            header = json.loads(blob[off + 4:off + 4 + hlen])
            payload = blob[off + 4 + hlen:]
        except Exception:
            reg.increment("compile_cache_errors_total",
                          labels={"kind": "corrupt"})
            _warn_once(f"compile cache entry refused (corrupt): {path}")
            return None
        if header.get("key") != key:
            reg.increment("compile_cache_errors_total",
                          labels={"kind": "key_mismatch"})
            _warn_once(f"compile cache entry refused (key mismatch): {path}")
            return None
        if header.get("backend") != backend_fingerprint():
            # The backend is hashed into the key, so this only trips when
            # a file was copied around -- refuse it like any corruption.
            reg.increment("compile_cache_errors_total",
                          labels={"kind": "backend"})
            _warn_once(f"compile cache entry refused (backend drift): {path}")
            return None
        digest = hashlib.blake2b(payload, digest_size=16).hexdigest()
        if header.get("digest") != digest:
            reg.increment("compile_cache_errors_total",
                          labels={"kind": "digest"})
            _warn_once(f"compile cache entry refused (payload digest): {path}")
            return None
        return payload

    # -- write -----------------------------------------------------------

    def put(self, key: str, payload: bytes,
            meta: Optional[Dict[str, Any]] = None) -> bool:
        """Store a library.  IO failures are swallowed with a warning once
        (the cache saves a build; it is never needed for correctness)."""
        if not self.enabled:
            return False
        path = self._path(key)
        header = dict(meta or {})
        header.update({
            "key": key,
            "backend": backend_fingerprint(),
            "digest": hashlib.blake2b(payload, digest_size=16).hexdigest(),
            "created": time.time(),
        })
        hdr = json.dumps(header, sort_keys=True).encode()
        blob = _ENTRY_MAGIC + struct.pack("<I", len(hdr)) + hdr + payload
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)  # atomic: readers see old or new, whole
            _metrics().increment("compile_cache_writes_total")
            return True
        except OSError as exc:
            _metrics().increment("compile_cache_errors_total",
                                 labels={"kind": "io"})
            _warn_once(f"compile cache write failed ({path}): {exc}")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
