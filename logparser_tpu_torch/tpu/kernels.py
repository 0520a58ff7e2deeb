"""The four CUDA kernels of the main path: build, bind, launch.

Sources live in ``logparser_tpu_torch/csrc``; at first use on a CUDA
tensor they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library per source (all four ``nvcc`` processes run at once) under
``csrc/_build/<hash of the sources>/`` and loaded with ``ctypes``.  The
C entry points take raw device pointers and PyTorch's current stream, and
return ``cudaGetLastError()`` after the launch.

Each wrapper (``split``, ``span_stages``, ``timestamp``, ``pack_rows``):

- on a CUDA tensor checks device, dtype, shape and contiguity, allocates
  its outputs with ``torch.empty`` (or fills the ``out`` it is given),
  launches the kernel on the current stream, raises on a launch error,
  and adds one to its ``launches`` count;
- on a CPU tensor runs the kernel's plain PyTorch version (the tests do
  this); any other device raises.  A CUDA tensor never falls back.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from . import pipeline, timeparse
from .pipeline import PackTables, SplitTables, StageTables, TsTables

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("split", "span_stages", "timestamp", "pack_rows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Line buckets the kernels take: the widest window a stage gathers (the
# 27-byte timestamp) must fit, and span fields hold 13 bits.
MIN_LINE_LEN = 32
MAX_LINE_LEN = 8191

_I32 = torch.int32
_P = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "split": [_P, _P, _INT, _INT, _P, _P, _INT, _P, _INT, _INT, _INT, _INT,
              _P, _P, _P, _P],
    "span_stages": [_P, _INT, _INT, _P, _P, _P, _INT, _P, _P],
    "timestamp": [_P, _INT, _INT, _P, _P, _P, _INT, _P, _P, _INT, _INT, _INT,
                  _INT, _P, _P],
    "pack_rows": [_INT, _INT, _P, _P, _P, _P, _P, _INT, _P, _P, _INT, _INT,
                  _P, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class _Build:
    """The compiled libraries of this checkout's sources (one per process)."""

    def __init__(self) -> None:
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.seconds: Optional[float] = None
        self.ptxas: Dict[str, str] = {}


_BUILD = _Build()


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise KernelBuildError("nvcc not found (CUDA_HOME or PATH)")
    return found


def build() -> Dict[str, Path]:
    """Compile every kernel whose library is missing (all at once) and
    return {kernel: library path}.  Records the wall seconds and ptxas's
    register / shared-memory report in ``build_info()``."""
    out_dir = CSRC / "_build" / source_digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {k: out_dir / f"lib{k}.so" for k in KERNELS}
    t0 = time.perf_counter()
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        missing = [k for k in KERNELS if not paths[k].exists()]
        if missing:
            nvcc = _nvcc()
            procs: List[Tuple[str, Path, subprocess.Popen]] = []
            for k in missing:
                tmp = out_dir / f"lib{k}.so.tmp{os.getpid()}"
                procs.append((k, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                     str(CSRC / f"{k}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )))
            failed = []
            for k, tmp, proc in procs:
                log, _ = proc.communicate()
                _BUILD.ptxas[k] = log
                if proc.returncode != 0:
                    failed.append(f"{k}.cu (exit {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, paths[k])
            if failed:
                raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    _BUILD.seconds = time.perf_counter() - t0
    return paths


def build_info() -> Dict[str, object]:
    return {"seconds": _BUILD.seconds, "ptxas": dict(_BUILD.ptxas)}


def _lib(name: str) -> ctypes.CDLL:
    lib = _BUILD.libs.get(name)
    if lib is None:
        for k, path in build().items():
            if k not in _BUILD.libs:
                dll = ctypes.CDLL(str(path))
                fn = getattr(dll, f"lp_{k}")
                fn.argtypes = _SIGNATURES[k]
                fn.restype = ctypes.c_int
                err = getattr(dll, f"lp_{k}_error")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _BUILD.libs[k] = dll
        lib = _BUILD.libs[name]
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch on ``device``'s current stream (appended as the last
    argument) with ``device`` current; raise on a launch error."""
    lib = _lib(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, f"lp_{name}")(*args, stream)
    if code != 0:
        msg = getattr(lib, f"lp_{name}_error")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(buf: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if buf.is_cuda:
        return True
    if buf.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {buf.device}")


def _check_buf(buf: torch.Tensor) -> Tuple[int, int]:
    if buf.dim() != 2:
        raise ValueError(f"buf must be [B, L], got {tuple(buf.shape)}")
    B, L = buf.shape
    _check("buf", buf, torch.uint8, (B, L), buf.device)
    if not MIN_LINE_LEN <= L <= MAX_LINE_LEN:
        raise ValueError(f"line bucket {L} outside [{MIN_LINE_LEN}, {MAX_LINE_LEN}]")
    return B, L


def _check_tables(tables: torch.nn.Module, device: torch.device) -> None:
    for name, t in tables.named_buffers(recurse=False):
        _check(f"table {name}", t, _I32, t.shape, device)


def _out(out: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=_I32, device=device)
    _check("out", out, _I32, shape, device)
    return out


def split(
    tables: SplitTables, buf: torch.Tensor, lengths: torch.Tensor,
    flags_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 1: (starts [T, B], ends [T, B], flags [B]) int32; flags bits
    are pipeline.SPLIT_VALID / SPLIT_PLAUSIBLE / SPLIT_ESC_HIT.  Requires
    lengths <= L (encode_batch guarantees it)."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check("lengths", lengths, _I32, (B,), dev)
    _check_tables(tables, dev)
    flags = _out(flags_out, (B,), dev)
    if not _route(buf):
        starts, ends, f = pipeline.compute_split(tables.program, buf, lengths)
        flags.copy_(f)
        return starts, ends, flags
    starts = torch.empty((tables.n_tok, B), dtype=_I32, device=dev)
    ends = torch.empty((tables.n_tok, B), dtype=_I32, device=dev)
    if B:
        _launch("split", dev, _ptr(buf), _ptr(lengths), B, L, _ptr(tables.cls),
                _ptr(tables.ops), tables.ops.shape[0], _ptr(tables.lits),
                tables.lit_width, tables.n_planes, int(tables.has_esc),
                tables.n_tok, _ptr(starts), _ptr(ends), _ptr(flags))
        split.launches += 1
    return starts, ends, flags


def _check_cursors(tables_tok: int, buf, starts, ends) -> None:
    B = buf.shape[0]
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dim() != 2 or t.shape[1] != B or t.shape[0] <= tables_tok:
            raise ValueError(f"{name} must be [T > {tables_tok}, {B}], got {tuple(t.shape)}")
        _check(name, t, _I32, t.shape, buf.device)


def span_stages(
    tables: StageTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 2: the unit's span / long components, [n_out, B] int32."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    max_tok = max((t[1] for t in tables.tasks_py), default=0)
    _check_cursors(max_tok, buf, starts, ends)
    out = _out(out, (tables.n_out, B), dev)
    if not _route(buf):
        return pipeline.span_stages_plain(tables, buf, starts, ends, out)
    if B and tables.n_out:
        _launch("span_stages", dev, _ptr(buf), B, L, _ptr(starts), _ptr(ends),
                _ptr(tables.tasks), tables.tasks.shape[0], _ptr(out))
        span_stages.launches += 1
    return out


def timestamp(
    tables: TsTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 3: one timestamp group's (c1, c2, off, ok), [4, B] int32."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    _check_cursors(tables.token_index, buf, starts, ends)
    if tables.seg_w + timeparse.TAIL_WIDTH > L:
        raise ValueError(f"line bucket {L} narrower than the timestamp window")
    out = _out(out, (4, B), dev)
    if not _route(buf):
        return pipeline.timestamp_plain(tables, buf, starts, ends, out)
    if B:
        _launch("timestamp", dev, _ptr(buf), B, L, _ptr(starts[tables.token_index]),
                _ptr(ends[tables.token_index]), _ptr(tables.items),
                tables.items.shape[0], _ptr(tables.text), _ptr(tables.names),
                tables.names.shape[0], tables.name_width, tables.seg_w,
                tables.layout.min_prefix, _ptr(out))
        timestamp.launches += 1
    return out


def pack_rows(
    tables: PackTables, flags: torch.Tensor, comps: torch.Tensor,
) -> torch.Tensor:
    """Kernel 4: the packed [K + 4V, B] int32 output."""
    if comps.dim() != 2:
        raise ValueError(f"comps must be [n_comp, B], got {tuple(comps.shape)}")
    B = comps.shape[1]
    dev = comps.device
    _check("comps", comps, _I32, comps.shape, dev)
    _check("flags", flags, _I32, (tables.U, B), dev)
    _check_tables(tables, dev)
    need = max([c for c, _, _ in tables.slots_py] + tables.cons_py
               + [p + 2 for *_, p in tables.views_py], default=-1)
    if comps.shape[0] <= need:
        raise ValueError(f"comps has {comps.shape[0]} rows, tables read row {need}")
    if not _route(comps):
        return pipeline.pack_rows_plain(tables, flags, comps)
    out = torch.empty((tables.K + pipeline.VIEW_ROWS_PER_FIELD * tables.V, B),
                      dtype=_I32, device=dev)
    if B:
        _launch("pack_rows", dev, B, tables.U, _ptr(flags), _ptr(comps),
                _ptr(tables.units), _ptr(tables.cons), _ptr(tables.rows),
                tables.K, _ptr(tables.slots), _ptr(tables.views),
                tables.n_views, tables.V, _ptr(out))
        pack_rows.launches += 1
    return out


for _fn in (split, span_stages, timestamp, pack_rows):
    _fn.launches = 0
WRAPPERS = {"split": split, "span_stages": span_stages,
            "timestamp": timestamp, "pack_rows": pack_rows}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
