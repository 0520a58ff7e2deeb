"""The CUDA kernels of the port: build, bind, launch.

Sources live in ``logparser_tpu_torch/csrc``; at first use on a CUDA
tensor they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library per source (all ``nvcc`` processes run at once) under
``csrc/_build/<hash of the sources>/`` and loaded with ``ctypes``.  The
C entry points take raw device pointers and PyTorch's current stream, and
return ``cudaGetLastError()`` after the launch.

Each wrapper (``split``, ``span_stages``, ``timestamp``, ``zone_lookup``,
``uri_split``, ``csr_split``, ``ipv4_spans``, ``geo_lookup``,
``pack_rows``, the aggregate pushdown's ``agg_lanes``, ``agg_reduce``
and ``agg_group``, ``setcookie_split`` and ``muid``, the two public
utilities' ``unescape`` and ``geo_gather``, and the mesh's ``sp_split``,
``sp_program`` and ``counters``):

- on a CUDA tensor checks device, dtype, shape and contiguity, allocates
  its outputs with ``torch.empty`` (or fills the ``out`` it is given),
  launches the kernel on the current stream, raises on a launch error,
  and adds one to its ``launches`` count;
- on a CPU tensor runs the kernel's plain PyTorch version (the tests do
  this); any other device raises.  A CUDA tensor never falls back.
"""
from __future__ import annotations

import array
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..analytics import device as agg_device
from ..analytics.device import AggTables
from ..geoip.device import geo_gather_plain
from ..parallel import mesh
from ..parallel.mesh import SP_BYTES, SP_CHARSET, SP_FIND, SP_MAX_LIT, SpTables
from . import pipeline, postproc
from .pipeline import (
    CONS_NEVER,
    CSR_SLOTS_MAX,
    CsrTables,
    GeoTables,
    IpTables,
    MuidTables,
    PackTables,
    SplitTables,
    StageTables,
    TsTables,
    UriTables,
    ZoneTables,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("split", "span_stages", "timestamp", "zone_lookup", "uri_split",
           "csr_split", "ipv4_spans", "geo_lookup", "pack_rows", "agg_lanes",
           "agg_reduce", "agg_group", "setcookie_split", "muid", "unescape",
           "geo_gather", "sp_split", "sp_program", "counters")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Line buckets the kernels take: the widest window a stage gathers (the
# 31-byte %Z zone window) must fit, and span fields hold 13 bits.  The
# split gathers no window: it takes any L from 1.
MIN_LINE_LEN = 32
MAX_LINE_LEN = 8191

_I32 = torch.int32
_P = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "split": [_P, _P, _INT, _INT, _P, _P, _INT, _P, _INT, _INT, _INT, _INT,
              _INT, _P, _P, _P, _P],
    "span_stages": [_P, _INT, _INT, _P, _P, _P, _INT, _P, _P],
    "timestamp": [_P, _INT, _INT, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT,
                  _INT, _INT, _P, _P, _P],
    "zone_lookup": [_INT, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                    _P, _P, _P],
    "uri_split": [_P, _INT, _INT, _P, _P, _P, _INT, _INT, _INT, _INT, _INT,
                  _INT, _P, _INT, _INT, _INT, _P],
    "csr_split": [_P, _INT, _INT, _P, _P, _P, _INT, _INT, _INT, _P, _INT, _INT,
                  _INT, _INT, _INT, _INT, _INT, _INT, _P],
    "setcookie_split": [_P, _INT, _INT, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _P],
    "muid": [_P, _INT, _INT, _P, _P, _P, _P],
    "pack_rows": [_INT, _INT, _P, _P, _P, _P, _P, _INT, _P, _P, _INT, _INT,
                  _P, _INT, _P, _P],
    "ipv4_spans": [_P, _INT, _INT, _P, _P, _P, _P],
    "geo_lookup": [_INT, _P, _P, _P, _P, _INT, _P, _INT, _INT, _INT, _INT, _INT, _P,
                   _P],
    "agg_lanes": [_INT, _INT, _INT, _P, _INT, _P, _P, _INT, _P, _P, _INT, _P, _P,
                  _INT, _P, _P, _P, _P],
    "agg_reduce": [_INT, _P, _P, _P, _INT, _P, _INT, _P, _INT, _P, _P, _INT, _INT,
                   _P],
    "agg_group": [_INT, _INT, _P, _P, _INT, _INT, _P, _P, _P, _P, _P],
    "unescape": [_P, _INT, _INT, _P, _P, _INT, _P, _P, _P, _P],
    "geo_gather": [_P, _INT, _INT, _P, _INT, _P],
    "sp_split": [_INT, _P, _INT, _INT, _INT, _P, _P, _P, _INT, _P, _INT, _INT, _P,
                 _P, _P],
    "sp_program": [_P, _INT, _INT, _INT, _INT, _P, _P, _INT, _P, _INT, _P, _INT, _INT,
                   _P, _P, _P, _P],
    "counters": [_P, _P, _INT, _INT, _P, _P],
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


def csrc_constant(kernel: str, name: str) -> int:
    """A kernel's design constant, ``constexpr int NAME = N;`` in its
    source: the one place that value lives, for the tools that say which
    path a row takes."""
    m = re.search(rf"\bconstexpr int {name} = (\d+);", (CSRC / f"{kernel}.cu").read_text())
    if m is None:
        raise KeyError(f"{kernel}.cu has no constexpr int {name}")
    return int(m.group(1))


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


def _check_buf(buf: torch.Tensor, min_len: int = MIN_LINE_LEN) -> Tuple[int, int]:
    if buf.dim() != 2:
        raise ValueError(f"buf must be [B, L], got {tuple(buf.shape)}")
    B, L = buf.shape
    _check("buf", buf, torch.uint8, (B, L), buf.device)
    if not min_len <= L <= MAX_LINE_LEN:
        raise ValueError(f"line bucket {L} outside [{min_len}, {MAX_LINE_LEN}]")
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
    lengths <= L (encode_batch guarantees it); any L from 1 to 8191."""
    B, L = _check_buf(buf, 1)
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
                tables.lit_width, tables.lits.shape[0], tables.n_planes,
                int(tables.has_esc),
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
    zone_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 3: one timestamp group's (c1, c2, off, ok), [4, B] int32.
    For a %Z layout rows 2 and 3 hold the wall minute and the verdict so
    far, and ``zone_out`` [B] (allocated when not given) the zone index:
    :func:`zone_lookup` finishes the bundle."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    _check_cursors(tables.token_index, buf, starts, ends)
    dl = tables.layout
    if any(w > L for w in dl.windows()):
        raise ValueError(f"line bucket {L} narrower than a timestamp segment")
    out = _out(out, (4, B), dev)
    zone = tables.zone is not None
    if zone:
        zone_out = _out(zone_out, (B,), dev)
    if not _route(buf):
        return pipeline.timestamp_plain(tables, buf, starts, ends, out, zone_out)
    if B:
        _launch("timestamp", dev, _ptr(buf), B, L, _ptr(starts[tables.token_index]),
                _ptr(ends[tables.token_index]), _ptr(tables.index), tables.index.shape[0],
                tables.window, tables.fixed, tables.tail, int(dl.one_shot(L)),
                dl.default_offset_seconds, dl.min_prefix, int(zone), _ptr(out),
                _ptr(zone_out) if zone else None)
        timestamp.launches += 1
    return out


def zone_lookup(
    tables: ZoneTables, zone_idx: torch.Tensor, minutes: torch.Tensor,
    gate: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 7: (zone index, wall minute) -> (offset seconds, ok), [2, B]
    int32, through the tzdata tables (``tables.image``, staged into each
    block's shared memory: ``tables.smem_bytes``, about 74 KB).  With
    ``gate`` (a %Z timestamp bundle's verdict so far) ok becomes the
    bundle's final verdict.  ``out`` may be the rows ``minutes`` and
    ``gate`` lie in (each line reads its inputs before it writes)."""
    if minutes.dim() != 1:
        raise ValueError(f"minutes must be [B], got {tuple(minutes.shape)}")
    B = minutes.shape[0]
    dev = minutes.device
    _check("minutes", minutes, _I32, (B,), dev)
    _check("zone_idx", zone_idx, _I32, (B,), dev)
    if gate is not None:
        _check("gate", gate, _I32, (B,), dev)
    _check_tables(tables, dev)
    out = _out(out, (2, B), dev)
    if not _route(minutes):
        return pipeline.zone_lookup_plain(tables, zone_idx, minutes, gate, out)
    if B:
        _launch("zone_lookup", dev, B, _ptr(zone_idx), _ptr(minutes),
                _ptr(gate) if gate is not None else None, _ptr(tables.image),
                tables.smem_bytes, tables.n_zones, tables.n_transitions, tables.chain,
                tables.index_bits, tables.packed_at, tables.valid_at, _ptr(out[0]),
                _ptr(out[1]))
        zone_lookup.launches += 1
    return out


def _check_block(comps: torch.Tensor, B: int, need: int, device: torch.device) -> None:
    if comps.dim() != 2 or comps.shape[1] != B or comps.shape[0] <= need:
        raise ValueError(f"comps must be [n > {need}, {B}], got {tuple(comps.shape)}")
    _check("comps", comps, _I32, comps.shape, device)


def uri_split(
    tables: UriTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, comps: torch.Tensor,
) -> torch.Tensor:
    """Kernel 5: one URI group's rows of the unit component block
    ``comps`` [n, B] int32, filled in place (its input span is the token
    or three rows of the same block)."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    _check_cursors(tables.token_index, buf, starts, ends)
    need = max([tables.cons, tables.over, *tables.src]
               + [v for p in tables.parts_py for v in p[2:-1]]
               + [p[-1] + 2 for p in tables.parts_py])
    _check_block(comps, B, need, dev)
    if not _route(buf):
        return pipeline.uri_split_plain(tables, buf, starts, ends, comps)
    if B:
        src = tables.src
        _launch("uri_split", dev, _ptr(buf), B, L, _ptr(starts[tables.token_index]),
                _ptr(ends[tables.token_index]), _ptr(comps), src[0], src[1], src[2],
                int(tables.dash), int(tables.need_authority), tables.window,
                _ptr(tables.parts), len(tables.parts_py), tables.cons, tables.over)
        uri_split.launches += 1
    return comps


def csr_split(
    tables: CsrTables, buf: torch.Tensor, comps: torch.Tensor,
    starts: Optional[torch.Tensor] = None, ends: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 6: one query-string or cookie group's rows (2 packed words
    per slot, ok, overflow) of the unit component block ``comps`` [n, B]
    int32, filled in place from the query span rows of the same block or,
    for a group over a token, from the token cursors ``starts`` /
    ``ends``."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    if tables.mode == "setcookie":
        raise ValueError("a Set-Cookie group runs setcookie_split")
    if not 1 <= tables.slots <= CSR_SLOTS_MAX:
        raise ValueError(f"{tables.slots} slots outside [1, {CSR_SLOTS_MAX}]")
    need = max(tables.words + 2 * tables.slots - 1, tables.ok, tables.over, *tables.src)
    _check_block(comps, B, need, dev)
    direct = tables.src[0] < 0
    if direct:
        _check_cursors(tables.token_index, buf, starts, ends)
    if not _route(buf):
        return pipeline.csr_split_plain(tables, buf, comps, starts, ends)
    if B:
        src, sep = tables.src, tables.sep
        _launch("csr_split", dev, _ptr(buf), B, L, _ptr(comps),
                _ptr(starts[tables.token_index]) if direct else None,
                _ptr(ends[tables.token_index]) if direct else None,
                src[0], src[1], src[2], _ptr(tables.cls), len(sep), sep[0],
                sep[1] if len(sep) > 1 else -1, tables.slots, tables.window,
                tables.words, tables.ok, tables.over)
        csr_split.launches += 1
    return comps


def setcookie_split(
    tables: CsrTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, comps: torch.Tensor,
) -> torch.Tensor:
    """Kernel 13: one Set-Cookie group's rows (2 packed words per slot,
    ok, overflow, bad) of the unit component block ``comps`` [n, B]
    int32, filled in place from its token's cursors."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    if tables.mode != "setcookie":
        raise ValueError(f"a {tables.mode} group runs csr_split")
    _check_cursors(tables.token_index, buf, starts, ends)
    need = max(tables.words + 2 * tables.slots - 1, tables.ok, tables.over, tables.bad)
    _check_block(comps, B, need, dev)
    if not _route(buf):
        return pipeline.setcookie_split_plain(tables, buf, starts, ends, comps)
    if B:
        _launch("setcookie_split", dev, _ptr(buf), B, L,
                _ptr(starts[tables.token_index]), _ptr(ends[tables.token_index]),
                _ptr(comps), tables.slots, tables.words, tables.ok, tables.bad,
                tables.over)
        setcookie_split.launches += 1
    return comps


def muid(
    tables: MuidTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 14: one mod_unique_id group's token decoded, [6, B] int32
    rows (pipeline.MUID_ROWS: time, ip, pid, thread as uint32 bit
    patterns, counter, ok)."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    _check_cursors(tables.token_index, buf, starts, ends)
    out = _out(out, (6, B), dev)
    if not _route(buf):
        return pipeline.muid_plain(tables, buf, starts, ends, out)
    if B:
        _launch("muid", dev, _ptr(buf), B, L, _ptr(starts[tables.token_index]),
                _ptr(ends[tables.token_index]), _ptr(out))
        muid.launches += 1
    return out


def ipv4_spans(
    tables: IpTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 8: the dotted-quad parse of one IP token, which every geo
    group over the token reads: [4, B] int32 rows (value as the uint32 bit
    pattern, ok, has_colon, chain_ok)."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check_tables(tables, dev)
    _check_cursors(tables.token_index, buf, starts, ends)
    out = _out(out, (4, B), dev)
    if not _route(buf):
        return pipeline.ipv4_spans_plain(tables, buf, starts, ends, out)
    if B:
        _launch("ipv4_spans", dev, _ptr(buf), B, L, _ptr(starts[tables.token_index]),
                _ptr(ends[tables.token_index]), _ptr(out))
        ipv4_spans.launches += 1
    return out


def geo_lookup(
    tables: GeoTables, keys: torch.Tensor, gate: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 9: each key's row in the group's flattened GeoIP table, [B]
    int32 (0 = miss, row r = range r - 1); keys are uint32 bit patterns
    in int32.  With ``gate`` a key whose gate is 0 gets row 0.  Each
    block stages ``tables.image`` (the splitters, at most 32 KB, and up
    to 8,192 ranges the ends too) into shared memory."""
    if keys.dim() != 1:
        raise ValueError(f"keys must be [B], got {tuple(keys.shape)}")
    B = keys.shape[0]
    dev = keys.device
    _check("keys", keys, _I32, (B,), dev)
    if gate is not None:
        _check("gate", gate, _I32, (B,), dev)
    _check_tables(tables, dev)
    K = tables.starts.shape[0]
    if tables.ends.shape[0] != K:
        raise ValueError(f"starts has {K} entries, ends {tables.ends.shape[0]}")
    if 4 * tables.image.shape[0] != tables.smem_bytes:
        raise ValueError(f"a {4 * tables.image.shape[0]}-byte image, "
                         f"{tables.smem_bytes} bytes to stage")
    out = _out(out, (B,), dev)
    if not _route(keys):
        return pipeline.geo_lookup_plain(tables, keys, gate, out)
    if B:
        _launch("geo_lookup", dev, B, _ptr(keys),
                _ptr(gate) if gate is not None else None, _ptr(tables.starts),
                _ptr(tables.ends), K, _ptr(tables.image), tables.n_split,
                tables.split_shift, tables.ends_at, tables.smem_bytes, tables.lockstep,
                _ptr(out))
        geo_lookup.launches += 1
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
    need = max([c for c, _, _ in tables.slots_py]
               + [c for c, kind in tables.cons_py if kind != CONS_NEVER]
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
                tables.n_views, tables.V, _ptr(out), len(tables.slots_py),
                _ptr(tables.view_of))
        pack_rows.launches += 1
    return out


def agg_lanes(
    tables: AggTables, packed: torch.Tensor, buf: torch.Tensor, n_rows: int,
    host_kill: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10: the aggregate's per-row pass over the packed rows: (cls
    [B] uint8, lanes [n_lane_rows, B] int32); rows at or past ``n_rows``
    are padding, ``host_kill`` [B] uint8 marks truncated lines."""
    B, L = _check_buf(buf)
    dev = buf.device
    if packed.dim() != 2 or packed.shape[1] != B:
        raise ValueError(f"packed must be [R, {B}], got {tuple(packed.shape)}")
    _check("packed", packed, _I32, packed.shape, dev)
    if packed.shape[0] <= tables.max_row:
        raise ValueError(f"packed has {packed.shape[0]} rows, tables read row "
                         f"{tables.max_row}")
    _check("host_kill", host_kill, torch.uint8, (B,), dev)
    _check_tables(tables, dev)
    cls = torch.empty(B, dtype=torch.uint8, device=dev)
    lanes = torch.empty((tables.n_lane_rows, B), dtype=_I32, device=dev)
    if not _route(buf):
        return agg_device.agg_lanes_plain(tables, packed, buf, n_rows, host_kill,
                                          cls, lanes)
    if B:
        _launch("agg_lanes", dev, B, L, min(n_rows, B), _ptr(packed), packed.shape[0],
                _ptr(buf), _ptr(host_kill), len(tables.units_py), _ptr(tables.units),
                _ptr(tables.lanes), len(tables.lanes_py), _ptr(tables.udesc),
                _ptr(tables.ovf), len(tables.ovf_py), _ptr(tables.keys), _ptr(cls),
                _ptr(lanes))
        agg_lanes.launches += 1
    return cls, lanes


def agg_reduce(
    tables: AggTables, cls: torch.Tensor, lanes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 11: (counts [1 + n_bins] int32: n_device then every
    histogram's bins, tiles [n_sums, ntiles, 3, 2] int32: per 4096-row
    tile and limb the sums of the low and high 16 bits) over the class
    plane and the lanes."""
    if cls.dim() != 1:
        raise ValueError(f"cls must be [B], got {tuple(cls.shape)}")
    B = cls.shape[0]
    dev = cls.device
    _check("cls", cls, torch.uint8, (B,), dev)
    _check("lanes", lanes, _I32, (tables.n_lane_rows, B), dev)
    _check_tables(tables, dev)
    tile, ntiles = agg_device.sum_tiling(B)
    counts = torch.empty(1 + tables.n_bins, dtype=_I32, device=dev)
    tiles = torch.empty((len(tables.sums_py), ntiles, 3, 2), dtype=_I32, device=dev)
    if not _route(cls):
        return agg_device.agg_reduce_plain(tables, cls, lanes, counts, tiles)
    _launch("agg_reduce", dev, B, _ptr(cls), _ptr(lanes), _ptr(tables.sums),
            len(tables.sums_py), _ptr(tables.hists), len(tables.hists_py),
            _ptr(tables.edges), counts.shape[0], _ptr(counts), _ptr(tiles), tile,
            ntiles)
    agg_reduce.launches += 1
    return counts, tiles


def group_capacity(B: int) -> int:
    """agg_group's global hash-table slots: the least power of two >= 2B."""
    cap = 2
    while cap < 2 * B:
        cap *= 2
    return cap


def agg_group(
    lane: torch.Tensor, buf: torch.Tensor, spans: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 12: distinct-value grouping of one lane row: (groups [B, 4]
    (count, rep_row, rep_start, rep_len) for a span lane or [B, 2]
    (bucket, count) for a time lane, the first n rows filled in no
    particular order; n_groups [1]) int32."""
    B, L = _check_buf(buf)
    dev = buf.device
    _check("lane", lane, _I32, (B,), dev)
    groups = torch.empty((B, 4 if spans else 2), dtype=_I32, device=dev)
    if not _route(buf):
        return agg_device.agg_group_plain(lane, buf, spans, groups,
                                          torch.empty(1, dtype=_I32, device=dev))
    cap = group_capacity(B)
    # The table's 64-bit keys, its group indices and n_groups, zeroed in one fill.
    scratch = torch.zeros(3 * cap + 1, dtype=_I32, device=dev)
    n_groups = scratch[3 * cap:]
    _launch("agg_group", dev, B, L, _ptr(lane), _ptr(buf), int(spans), cap,
            _ptr(scratch), _ptr(scratch[2 * cap:]), _ptr(groups), _ptr(n_groups))
    agg_group.launches += 1
    return groups, n_groups


def unescape(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 15: the byte-dropping unescape of the spans [start, end):
    (out [B, min(width, L)] uint8, out_len [B] int32, exact [B] bool), as
    ``postproc.unescape_compact_spans_plain`` defines them."""
    if buf.dim() != 2:
        raise ValueError(f"buf must be [B, L], got {tuple(buf.shape)}")
    B, L = buf.shape
    dev = buf.device
    _check("buf", buf, torch.uint8, (B, L), dev)
    _check("start", start, _I32, (B,), dev)
    _check("end", end, _I32, (B,), dev)
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    if not _route(buf):
        return postproc.unescape_compact_spans_plain(buf, start, end, width)
    width = min(width, L)
    out = torch.empty((B, width), dtype=torch.uint8, device=dev)
    out_len = torch.empty(B, dtype=_I32, device=dev)
    exact = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _launch("unescape", dev, _ptr(buf), B, L, _ptr(start), _ptr(end), width,
                _ptr(out), _ptr(out_len), _ptr(exact))
        unescape.launches += 1
    return out, out_len, exact


_GATHER_DTYPES = (torch.float32, torch.int32, torch.int64)
# The columns one geo_gather launch takes: a GeoIP table's 13 extractors.
GATHER_MAX_COLUMNS = csrc_constant("geo_gather", "MAX_COLS")


def geo_gather(columns: Sequence[torch.Tensor], rows: torch.Tensor) -> List[torch.Tensor]:
    """Kernel 16: ``[column[rows] for column in columns]``, each [B] in its
    column's dtype (float32, int32 or int64), for the columns of one GeoIP
    table (every one [N]) under the reference's index rule
    (``geo_gather_plain``): one launch for all of them."""
    if not 1 <= len(columns) <= GATHER_MAX_COLUMNS:
        raise ValueError(f"geo_gather takes 1 to {GATHER_MAX_COLUMNS} columns, "
                         f"got {len(columns)}")
    if rows.dim() != 1:
        raise ValueError(f"rows must be [B], got {tuple(rows.shape)}")
    dev = rows.device
    n = columns[0].shape[0] if columns[0].dim() == 1 else 0
    for column in columns:
        if column.dim() != 1 or column.shape[0] == 0 or column.shape[0] != n:
            raise ValueError(f"columns must all be [N > 0] of one N, got "
                             f"{[tuple(c.shape) for c in columns]}")
        if column.dtype not in _GATHER_DTYPES:
            raise TypeError(f"column has dtype {column.dtype}, expected one of {_GATHER_DTYPES}")
        _check("column", column, column.dtype, column.shape, dev)
    _check("rows", rows, _I32, rows.shape, dev)
    if not _route(rows):
        return [geo_gather_plain(column, rows) for column in columns]
    B = rows.shape[0]
    outs = [torch.empty(B, dtype=column.dtype, device=dev) for column in columns]
    if B:
        # The C side's descriptor: (column, out, element size) a column.
        desc = array.array("q", [v for column, out in zip(columns, outs)
                                 for v in (_ptr(column), _ptr(out), column.element_size())])
        _launch("geo_gather", dev, desc.buffer_info()[0], len(columns), n, _ptr(rows), B)
        geo_gather.launches += 1
    return outs


def sp_split(
    tables: SpTables, op_index: int, mode: int, buf: torch.Tensor, offset: int,
    lo: torch.Tensor, hi: Optional[torch.Tensor] = None,
    halo: Optional[torch.Tensor] = None, l_total: int = 0,
) -> torch.Tensor:
    """Kernel 17: op ``op_index``'s shard-local step of the
    sequence-parallel split on one seq shard's slice ``buf`` [B, Lc] uint8
    (global columns ``offset`` ..), as ``mesh.sp_split_plain`` defines
    it: SP_FIND (an ``until_lit``; lo = cursor, hi = lengths, ``halo``
    [B, H >= len(lit) - 1] uint8 the next shard's first bytes) -> [B]
    int32, SP_BYTES (a ``lit``; lo = cursor) -> [len(lit), B] int32,
    SP_CHARSET (an ``until_lit`` or ``to_end``; [lo, hi) the span) -> [B]
    int32.  Any slice width: SP emits no packed spans."""
    if buf.dim() != 2:
        raise ValueError(f"buf must be [B, Lc], got {tuple(buf.shape)}")
    B, Lc = buf.shape
    dev = buf.device
    _check("buf", buf, torch.uint8, (B, Lc), dev)
    _check_tables(tables, dev)
    op = tables.program.ops[op_index]
    _check("lo", lo, _I32, (B,), dev)
    H = 0
    if mode == SP_FIND:
        if op.kind != "until_lit":
            raise ValueError(f"SP_FIND runs an until_lit op, op {op_index} is {op.kind}")
        _check("hi", hi, _I32, (B,), dev)
        if halo is not None:
            H = halo.shape[1] if halo.dim() == 2 else -1
            _check("halo", halo, torch.uint8, (B, H), dev)
        if len(op.lit) - 1 > H:
            raise ValueError(f"a {len(op.lit)}-byte separator needs a halo of "
                             f"{len(op.lit) - 1} bytes, got {H}")
        shape: Tuple[int, ...] = (B,)
    elif mode == SP_BYTES:
        if op.kind != "lit":
            raise ValueError(f"SP_BYTES runs a lit op, op {op_index} is {op.kind}")
        shape = (len(op.lit), B)
    elif mode == SP_CHARSET:
        if op.kind == "lit":
            raise ValueError(f"SP_CHARSET runs a token op, op {op_index} is a lit")
        _check("hi", hi, _I32, (B,), dev)
        shape = (B,)
    else:
        raise ValueError(f"unknown sp_split mode {mode}")
    if not _route(buf):
        return mesh.sp_split_step_plain(tables, op_index, mode, buf, offset, lo, hi,
                                        halo, l_total)
    cs = tables.cs_of_op[op_index]
    out = torch.empty(shape, dtype=_I32, device=dev)
    if B:
        _launch("sp_split", dev, mode, _ptr(buf), B, Lc, offset, _ptr(lo),
                _ptr(hi) if hi is not None else None, _ptr(tables.lits[op_index]),
                len(op.lit), _ptr(halo) if H else None, H, l_total,
                _ptr(tables.charsets[cs]), _ptr(out))
        sp_split.launches += 1
    return out


def sp_program(
    tables: SpTables, buf: torch.Tensor, lengths: torch.Tensor, n_seq: int,
) -> Dict[str, torch.Tensor]:
    """Kernel 19: the whole sequence-parallel split program over one data
    shard whose ``n_seq`` seq shards share a device, as
    ``mesh.sp_program_plain`` defines it: ``buf`` [Bd, n_seq * Lc] uint8
    is the data shard's rows (rows may be strided, bytes within a row
    not), shard s's slice its columns [s * Lc, (s + 1) * Lc); ``lengths``
    [Bd] int32.  Returns {starts, ends [T, Bd] int32, valid [Bd] bool}."""
    if buf.dim() != 2:
        raise ValueError(f"buf must be [Bd, L], got {tuple(buf.shape)}")
    Bd, L = buf.shape
    dev = buf.device
    if buf.dtype != torch.uint8:
        raise TypeError(f"buf has dtype {buf.dtype}, expected torch.uint8")
    if buf.stride(1) != 1 or (Bd > 1 and buf.stride(0) < L):
        raise ValueError(f"buf's rows must be runs of bytes, strides {buf.stride()}")
    _check("lengths", lengths, _I32, (Bd,), dev)
    _check_tables(tables, dev)
    program = tables.program
    if n_seq < 1 or L % n_seq:
        raise ValueError(f"line bucket {L} does not split evenly over {n_seq} seq shards")
    Lc = L // n_seq
    H = mesh.sp_halo_width(program)
    if H > Lc:
        raise ValueError(f"a {H + 1}-byte separator needs a {H}-byte halo, wider than "
                         f"the {Lc}-byte seq shard")
    if tables.lits.shape[1] > SP_MAX_LIT:
        raise ValueError(f"a {tables.lits.shape[1]}-byte literal (max {SP_MAX_LIT})")
    if not _route(buf):
        return mesh.sp_program_plain(tables, buf, lengths, n_seq)
    n_tok = len(program.tokens)
    starts = torch.empty((n_tok, Bd), dtype=_I32, device=dev)
    ends = torch.empty((n_tok, Bd), dtype=_I32, device=dev)
    valid = torch.empty(Bd, dtype=torch.bool, device=dev)
    if Bd:
        _launch("sp_program", dev, _ptr(buf), Bd, buf.stride(0), n_seq, Lc,
                _ptr(lengths), _ptr(tables.ops), len(program.ops), _ptr(tables.lits),
                tables.lits.shape[1], _ptr(tables.charsets), tables.charsets.shape[0],
                n_tok, _ptr(starts), _ptr(ends), _ptr(valid))
        sp_program.launches += 1
    return {"starts": starts, "ends": ends, "valid": valid}


def counters(good: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """Kernel 18: [2] int32, the sums of the [B] ``good`` and ``bad``
    masks (both bool or both int32; 32-bit wrapping sums): one launch,
    which writes both elements of its output (none for B = 0)."""
    if good.dim() != 1:
        raise ValueError(f"good must be [B], got {tuple(good.shape)}")
    if good.dtype not in (torch.bool, _I32):
        raise TypeError(f"good has dtype {good.dtype}, expected bool or int32")
    B = good.shape[0]
    dev = good.device
    _check("good", good, good.dtype, (B,), dev)
    _check("bad", bad, good.dtype, (B,), dev)
    if not _route(good):
        return mesh.counters_plain(good, bad)
    if not B:
        return torch.zeros(2, dtype=_I32, device=dev)
    out = torch.empty(2, dtype=_I32, device=dev)   # the kernel writes both
    _launch("counters", dev, _ptr(good), _ptr(bad), B, good.element_size(), _ptr(out))
    counters.launches += 1
    return out


WRAPPERS = {"split": split, "span_stages": span_stages, "timestamp": timestamp,
            "zone_lookup": zone_lookup, "uri_split": uri_split,
            "csr_split": csr_split, "ipv4_spans": ipv4_spans,
            "geo_lookup": geo_lookup, "pack_rows": pack_rows,
            "agg_lanes": agg_lanes, "agg_reduce": agg_reduce,
            "agg_group": agg_group, "setcookie_split": setcookie_split,
            "muid": muid, "unescape": unescape, "geo_gather": geo_gather,
            "sp_split": sp_split, "sp_program": sp_program, "counters": counters}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
