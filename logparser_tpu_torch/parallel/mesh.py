"""Device meshes, and the data-parallel and sequence-parallel runners.

The port of the reference package's ``parallel/mesh.py``.  A
:class:`DeviceMesh` is an ``[n_data, n_seq]`` grid of ``torch.device``
with the axes ``("data", "seq")``.  A device may appear more than once:
one card (or the CPU) can then hold every shard of a mesh and run each
per-shard kernel and each cross-shard combine, as the reference's virtual
CPU devices do.  :func:`local_devices` lists the devices a mesh takes by
default; tests and ``chip_smoke.py`` replace it to stand in for several.

- **DP** (:func:`dp_shardings`, :func:`data_parallel_runner`,
  :func:`batch_parallel_runner`, :class:`ShardedUnits`): the batch rows
  split into ``n_data`` equal shards, each run on its data shard's device
  (the ``split`` kernel, or the full fused step of one ``UnitsExecutor``
  per distinct device), and each shard's ``[K, B_i]`` copied into its
  column slice of one ``[K, B]`` tensor on the home device
  (``mesh.home``).
- **SP** (:func:`sequence_parallel_runner`): the line axis L split into
  ``n_seq`` shards.  Where every seq shard of a data shard lies on one
  device, that data shard is one launch of the ``sp_program`` kernel:
  the whole op program per line over the shards' slices (strided views of
  the batch's rows, each shard's halo read from the next shard's slice),
  the reference's ``lax.pmin`` (the first separator) and ``lax.psum`` (the
  owned bytes of a literal, the charset violations) inside it; its plain
  version :func:`sp_program_plain` runs the per-op loop over
  :func:`sp_split_plain`.  Where the seq shards lie on distinct devices,
  each op runs the ``sp_split`` kernel on each shard's slice on its device
  and the data shard's first device combines the shards' ``[B_i]``
  vectors (:func:`sp_per_op`); the halo -- the next shard's first ``max
  len(lit) - 1`` bytes, the last shard taking shard 0's as ``ppermute``'s
  ring does -- is copied once a batch.  The runner picks one path or the
  other from the mesh's devices; ``_sp_runner(..., one_launch=False)``
  takes the per-op path on any mesh (the yardstick the one-launch path is
  held to).  As in the reference there is no escape parity on this path,
  and any L that ``n_seq`` divides is taken, past the 8,191-byte span cap
  of the packed rows (SP emits cursors, not packed rows).
- :func:`aggregate_counters`: one ``counters`` launch over the rows of
  each stretch of data shards that share a device (:func:`counter_runs`;
  one launch for a mesh on one card), the partials added on the home
  device where there are several.

A cross-device copy is PyTorch's ``copy_``, which runs after the source
device's current stream and makes the destination device's current
stream wait for it (a two-way event barrier); so a combine on the home
device reads every shard's finished result.  With a repeated device the
one stream orders everything.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..tpu.pipeline import UnitsExecutor
from ..tpu.program import DeviceProgram
from ..tpu.runtime import run_program

AXES = ("data", "seq")

# sp_split modes (csrc/sp_split.cu).
SP_FIND, SP_BYTES, SP_CHARSET = 0, 1, 2
# sp_program op kinds (csrc/sp_program.cu) and its longest literal.
SP_OP_KINDS = {"lit": 0, "until_lit": 1, "to_end": 2}
SP_MAX_LIT = 512

Shard = Tuple[torch.device, int, int]   # (device, first row, end row)


def local_devices() -> List[torch.device]:
    """The devices a mesh takes by default: ``cuda:0`` .. ``cuda:k-1``
    (none without CUDA).  The stand-in for several devices is a
    replacement of this function (pytest's ``monkeypatch`` on
    ``logparser_tpu_torch.parallel.mesh.local_devices``)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """An ``[n_data, n_seq]`` grid of devices, axes ``("data", "seq")``."""

    axis_names = AXES

    def __init__(self, devices: Sequence[Sequence]):
        rows = [[_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a mesh needs a non-empty rectangular grid, got {rows}")
        if len({d.type for r in rows for d in r}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {rows}")
        self.devices = rows

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def home(self) -> torch.device:
        """Where outputs are assembled: ``devices[0][0]``."""
        return self.devices[0][0]

    @property
    def data_devices(self) -> List[torch.device]:
        """Each data shard's first device (where its rows are combined)."""
        return [row[0] for row in self.devices]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.devices})"


def make_mesh(n_data: int, n_seq: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """The first ``n_data * n_seq`` of ``devices`` (default
    :func:`local_devices`) as an ``[n_data, n_seq]`` mesh."""
    if n_data < 1 or n_seq < 1:
        raise ValueError(f"mesh shape ({n_data}, {n_seq}) must be positive")
    devices = list(local_devices() if devices is None else devices)
    n = n_data * n_seq
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return DeviceMesh([devices[i * n_seq:(i + 1) * n_seq] for i in range(n_data)])


def dp_device_count(requested: Optional[int] = None) -> int:
    """The data-parallel width a parser mesh uses: the largest power of
    two <= min(requested, the number of :func:`local_devices`); 1 when
    none fits (the reference's rule)."""
    avail = len(local_devices())
    n = avail if requested is None else min(int(requested), avail)
    if n < 1:
        return 1
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def dp_shardings(mesh: DeviceMesh, B: int) -> List[Shard]:
    """The one definition of the data-parallel batch split: each data
    shard's (device, first row, end row) over ``B`` rows, in order.  A
    ``B`` that ``n_data`` does not divide raises (the reference's
    ``in_shardings`` refuse it); the parser pads its batch first."""
    n = mesh.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split evenly over {n} data shards")
    w = B // n
    return [(dev, i * w, (i + 1) * w) for i, dev in enumerate(mesh.data_devices)]


def padded_rows(mesh: DeviceMesh, B: int) -> int:
    """``B`` rounded up to a multiple of the data width."""
    n = mesh.shape[0]
    return -(-B // n) * n


def scatter_rows(x: torch.Tensor, shards: Sequence[Shard], n: int,
                 non_blocking: bool = False) -> List[torch.Tensor]:
    """Each shard's rows of ``x`` on its device; rows at or past ``n``
    (padding) read zero."""
    out = []
    for dev, r0, r1 in shards:
        real = max(0, min(r1, n) - r0)
        if real == r1 - r0:
            out.append(x[r0:r1].to(dev, non_blocking=non_blocking))
            continue
        part = torch.zeros((r1 - r0, *x.shape[1:]), dtype=x.dtype, device=dev)
        if real:
            part[:real].copy_(x[r0:r0 + real], non_blocking=non_blocking)
        out.append(part)
    return out


def gather_columns(parts: Sequence[torch.Tensor], n: int,
                   home: torch.device) -> torch.Tensor:
    """The shards' ``[..., B_i]`` outputs side by side in one ``[..., n]``
    tensor on ``home`` (columns at or past ``n`` are padding and
    dropped); a lone part that covers ``n`` on ``home`` is itself."""
    if len(parts) == 1 and parts[0].shape[-1] == n and parts[0].device == home:
        return parts[0]
    out = torch.empty((*parts[0].shape[:-1], n), dtype=parts[0].dtype, device=home)
    c = 0
    for p in parts:
        k = min(p.shape[-1], n - c)
        if k > 0:
            out[..., c:c + k].copy_(p[..., :k])
        c += p.shape[-1]
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Data-parallel execution: shard B, replicate the program.
# ---------------------------------------------------------------------------


def data_parallel_runner(program: DeviceProgram, mesh: DeviceMesh):
    """fn(buf [B, L], lengths [B]) -> {starts, ends [T, B] int32, valid
    [B] bool} on the home device: ``run_program`` (the ``split`` kernel)
    on each data shard's rows on its device.  Inputs are tensors or numpy
    arrays."""

    def run(buf, lengths) -> Dict[str, torch.Tensor]:
        buf, lengths = _as_tensor(buf), _as_tensor(lengths)
        B = buf.shape[0]
        shards = dp_shardings(mesh, B)
        outs = [run_program(program, b, ln) for b, ln in
                zip(scatter_rows(buf, shards, B), scatter_rows(lengths, shards, B))]
        return {k: gather_columns([o[k] for o in outs], B, mesh.home)
                for k in ("starts", "ends", "valid")}

    return run


class ShardedUnits:
    """The full fused parse step over a mesh's data axis: one
    ``UnitsExecutor`` per distinct device; each shard's rows run through
    the executor on its device, and the packed ``[K (+4V), B_i]`` outputs
    are assembled on the home device -- bit for bit what one executor
    gives over the whole batch."""

    def __init__(self, units, mesh: DeviceMesh, view_specs=()):
        self.mesh = mesh
        self.executors: Dict[torch.device, UnitsExecutor] = {}
        for dev in mesh.data_devices:
            if dev not in self.executors:
                self.executors[dev] = UnitsExecutor(units, view_specs).to(dev)

    def __call__(self, bufs: Sequence[torch.Tensor], lengths: Sequence[torch.Tensor],
                 n: int) -> torch.Tensor:
        """The shards' rows (as :func:`scatter_rows` gives them) -> the
        packed ``[K (+4V), n]`` int32 on the home device."""
        parts = [self.executors[b.device](b, ln) for b, ln in zip(bufs, lengths)]
        return gather_columns(parts, n, self.mesh.home)


def batch_parallel_runner(units, mesh: DeviceMesh, view_specs=None):
    """fn(buf [B, L], lengths [B]) -> packed ``[K (+4V), B]`` int32 on the
    home device: the full fused step (split, the chained stages, CSR,
    timestamps, GeoIP joins, and the view rows of ``view_specs``) with
    the batch sharded over ``data`` (:class:`ShardedUnits`)."""
    step = ShardedUnits(units, mesh, view_specs or ())

    def run(buf, lengths) -> torch.Tensor:
        buf, lengths = _as_tensor(buf), _as_tensor(lengths)
        B = buf.shape[0]
        shards = dp_shardings(mesh, B)
        return step(scatter_rows(buf, shards, B), scatter_rows(lengths, shards, B), B)

    return run


# ---------------------------------------------------------------------------
# Sequence-parallel execution: shard L over 'seq'.
# ---------------------------------------------------------------------------


class SpTables(nn.Module):
    """One program's tables for the ``sp_split`` and ``sp_program``
    kernels: ``lits`` [n_ops, W] int32 (op i's literal bytes,
    zero-padded), ``charsets`` [n_charsets, 256] int32 (1 = byte allowed)
    and ``ops`` [n_ops, 6] int32 (kind as in ``SP_OP_KINDS``, literal
    length, charset, token, min_len, max_len)."""

    def __init__(self, program: DeviceProgram):
        super().__init__()
        self.program = program
        width = max([len(op.lit) for op in program.ops] + [1])
        lits = np.zeros((len(program.ops), width), dtype=np.int32)
        for i, op in enumerate(program.ops):
            lits[i, :len(op.lit)] = list(op.lit)
        self.cs_of_op = [program.charset_ids[op.charset] for op in program.ops]
        ops = [(SP_OP_KINDS[op.kind], len(op.lit), cs, op.token_index, op.min_len,
                op.max_len or 0) for op, cs in zip(program.ops, self.cs_of_op)]
        self.register_buffer("lits", torch.from_numpy(lits))
        self.register_buffer("ops", torch.tensor(ops or [[0] * 6], dtype=torch.int32))
        self.register_buffer("charsets", torch.from_numpy(
            np.asarray(program.charset_table, dtype=np.int32)))


def sp_tables(program: DeviceProgram, device: torch.device) -> SpTables:
    """The program's :class:`SpTables` on ``device``, built once per
    program object and device."""
    cache = program.__dict__.setdefault("_sp_tables", {})
    tables = cache.get(device)
    if tables is None:
        tables = cache[device] = SpTables(program).to(device)
    return tables


def sp_split_plain(mode: int, buf: torch.Tensor, offset: int, lo: torch.Tensor,
                   hi: Optional[torch.Tensor], lit: bytes,
                   halo: Optional[torch.Tensor], l_total: int,
                   allowed: torch.Tensor) -> torch.Tensor:
    """The plain version of the ``sp_split`` kernel on one seq shard's
    slice ``buf`` [B, Lc] (global columns ``offset`` ..): the shard-local
    halves of the reference's ``_sp_find_literal`` (SP_FIND: lo = cursor,
    hi = lengths -> [B] candidate or ``l_total``), ``_sp_byte_at`` for
    every byte of a literal (SP_BYTES: lo = cursor -> [len(lit), B]) and
    ``_sp_charset_ok`` (SP_CHARSET: [lo, hi) = the span, ``allowed`` [256]
    bool -> [B] violation count), each before its collective."""
    B, Lc = buf.shape
    dev = buf.device
    pos = torch.arange(Lc, dtype=torch.int32, device=dev)[None, :] + offset
    if mode == SP_FIND:
        n = len(lit)
        ext = torch.cat([buf, halo[:, :n - 1]], dim=1) if n > 1 else buf
        match = torch.ones((B, Lc), dtype=torch.bool, device=dev)
        for k, byte in enumerate(lit):
            match = match & (ext[:, k:k + Lc] == byte)
        usable = match & (pos + n <= hi[:, None]) & (pos >= lo[:, None])
        cand = torch.where(usable, pos, torch.tensor(l_total, dtype=torch.int32, device=dev))
        return cand.amin(dim=1)
    if mode == SP_BYTES:
        k = torch.arange(len(lit), dtype=torch.int64, device=dev)[:, None]
        local = lo[None, :].to(torch.int64) + k - offset
        in_range = (local >= 0) & (local < Lc)
        b = torch.gather(buf, 1, local.clamp(0, Lc - 1).T).T
        return torch.where(in_range, b.to(torch.int32), 0)
    if mode == SP_CHARSET:
        in_span = (pos >= lo[:, None]) & (pos < hi[:, None])
        bad = in_span & ~allowed[buf.to(torch.int64)]
        return bad.sum(dim=1, dtype=torch.int32)
    raise ValueError(f"unknown sp_split mode {mode}")


def sp_halo_width(program: DeviceProgram) -> int:
    """Bytes of the next shard an ``until_lit`` may read: the longest
    separator less one."""
    return max([len(op.lit) - 1 for op in program.ops if op.kind == "until_lit"] + [0])


def sp_split_step_plain(tables: SpTables, op_index: int, mode: int, buf: torch.Tensor,
                        offset: int, lo: torch.Tensor, hi: Optional[torch.Tensor] = None,
                        halo: Optional[torch.Tensor] = None,
                        l_total: int = 0) -> torch.Tensor:
    """``kernels.sp_split``'s signature over :func:`sp_split_plain`."""
    op = tables.program.ops[op_index]
    return sp_split_plain(mode, buf, offset, lo, hi, op.lit,
                          halo if mode == SP_FIND else None, l_total,
                          tables.charsets[tables.cs_of_op[op_index]] != 0)


def sp_per_op(tables: Sequence[SpTables], l_total: int, parts: Sequence[torch.Tensor],
              lens: Sequence[torch.Tensor], H: int, step) -> Dict[str, torch.Tensor]:
    """One data shard through the program, op by op: ``parts`` are its
    seq shards' slices (``lens`` its lengths, ``tables`` the program's
    tables) on their devices; ``step`` (``kernels.sp_split`` or
    :func:`sp_split_step_plain`) gives one shard's value of one op, and
    the combines and the outputs live on the first shard's device (the
    reference's ``_sp_program_body`` with its collectives)."""
    program = tables[0].program
    n_seq = len(parts)
    home = parts[0].device
    Bd, Lc = parts[0].shape
    offsets = [s * Lc for s in range(n_seq)]
    devs = [p.device for p in parts]
    halos = [parts[(s + 1) % n_seq][:, :H].contiguous().to(devs[s]) if H else None
             for s in range(n_seq)]
    length = lens[0]
    cursor = torch.zeros(Bd, dtype=torch.int32, device=home)
    valid = torch.ones(Bd, dtype=torch.bool, device=home)
    n_tok = len(program.tokens)
    starts = torch.zeros((n_tok, Bd), dtype=torch.int32, device=home)
    ends = torch.zeros((n_tok, Bd), dtype=torch.int32, device=home)

    def values(i, mode, lo, hi=None):
        """Every seq shard's value of op i, stacked on home."""
        return torch.stack([
            step(tables[s], i, mode, parts[s], offsets[s], lo.to(devs[s]),
                 None if hi is None else hi.to(devs[s]), halo=halos[s],
                 l_total=l_total).to(home)
            for s in range(n_seq)])

    for i, op in enumerate(program.ops):
        n_lit = len(op.lit)
        if op.kind == "lit":
            got = values(i, SP_BYTES, cursor).sum(dim=0)    # psum of owned bytes
            want = tables[0].lits[i, :n_lit, None]
            ok = (got == want).all(dim=0) & (cursor + n_lit <= length)
            valid = valid & ok
            cursor = cursor + n_lit
            continue
        if op.kind == "until_lit":
            found = values(i, SP_FIND, cursor, length).amin(dim=0)   # pmin
            token_valid = found < l_total
            start, end = cursor, torch.where(token_valid, found, cursor)
            valid = valid & token_valid
            next_cursor = end + n_lit
        elif op.kind == "to_end":
            start, end = cursor, length
            next_cursor = end
        else:  # pragma: no cover
            raise AssertionError(op.kind)
        bad = values(i, SP_CHARSET, start, end).sum(dim=0)             # psum
        valid = valid & (bad == 0) & ((end - start) >= op.min_len)
        if op.max_len:
            valid = valid & ((end - start) <= op.max_len)
        starts[op.token_index] = start
        ends[op.token_index] = end
        cursor = next_cursor
    valid = valid & (cursor == length)
    return {"starts": starts, "ends": ends, "valid": valid}


def sp_program_plain(tables: SpTables, buf: torch.Tensor, lengths: torch.Tensor,
                     n_seq: int) -> Dict[str, torch.Tensor]:
    """The plain version of the ``sp_program`` kernel: one data shard's
    rows ``buf`` [Bd, n_seq * Lc] (a view of the batch) split into its seq
    shards' slices, through :func:`sp_per_op` over :func:`sp_split_plain`
    on ``buf``'s device."""
    Lc = buf.shape[1] // n_seq
    parts = [buf[:, s * Lc:(s + 1) * Lc] for s in range(n_seq)]
    return sp_per_op([tables] * n_seq, n_seq * Lc, parts, [lengths] * n_seq,
                     sp_halo_width(tables.program), sp_split_step_plain)


def _sp_runner(program: DeviceProgram, mesh: DeviceMesh, l_total: int, one_launch: bool):
    """The SP runner; ``one_launch=False`` puts every data shard on the
    per-op path whatever its devices (the yardstick the one-launch path is
    held to)."""
    n_seq = mesh.shape[1]
    if l_total % n_seq:
        raise ValueError(f"line bucket {l_total} does not split evenly over "
                         f"{n_seq} seq shards")
    Lc = l_total // n_seq
    H = sp_halo_width(program)
    if H > Lc:
        raise ValueError(f"a {H + 1}-byte separator needs a {H}-byte halo, wider "
                         f"than the {Lc}-byte seq shard")

    def data_shard(row: List[torch.device], rows: torch.Tensor,
                   lens: torch.Tensor) -> Dict[str, torch.Tensor]:
        from ..tpu import kernels

        if one_launch and all(dev == row[0] for dev in row):
            dev = row[0]
            return kernels.sp_program(sp_tables(program, dev), rows.to(dev), lens.to(dev),
                                      n_seq)
        parts = [rows[:, s * Lc:(s + 1) * Lc].contiguous().to(dev)
                 for s, dev in enumerate(row)]
        return sp_per_op([sp_tables(program, dev) for dev in row], l_total, parts,
                         [lens.to(dev) for dev in row], H, kernels.sp_split)

    def run(buf, lengths) -> Dict[str, torch.Tensor]:
        buf, lengths = _as_tensor(buf), _as_tensor(lengths)
        B, L = buf.shape
        if L != l_total:
            raise ValueError(f"buf has {L} columns, the runner was built for {l_total}")
        outs = [data_shard(mesh.devices[d], buf[r0:r1], lengths[r0:r1])
                for d, (_, r0, r1) in enumerate(dp_shardings(mesh, B))]
        return {k: gather_columns([o[k] for o in outs], B, mesh.home)
                for k in ("starts", "ends", "valid")}

    return run


def sequence_parallel_runner(program: DeviceProgram, mesh: DeviceMesh, l_total: int):
    """fn(buf [B, l_total], lengths [B]) -> {starts, ends [T, B] int32,
    valid [B] bool} on the home device, with B sharded over ``data`` and
    L over ``seq``: a data shard whose seq shards share one device is one
    ``sp_program`` launch there; one whose seq shards lie on distinct
    devices runs the ``sp_split`` kernel per op and seq shard, the
    combines on its first device.  Raises ValueError when ``n_seq`` does
    not divide ``l_total`` or a separator's halo is wider than a shard
    (the reference fails on both)."""
    return _sp_runner(program, mesh, l_total, one_launch=True)


# ---------------------------------------------------------------------------
# The good / bad line counters.
# ---------------------------------------------------------------------------


def counters_plain(good: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """The plain version of the ``counters`` kernel: [2] int32 (the sums
    of ``good`` and ``bad``, wrapping at 32 bits)."""
    return torch.stack([good.sum(), bad.sum()]).to(torch.int32)


def counter_runs(mesh: DeviceMesh, B: int) -> List[Shard]:
    """The ``counters`` launches of :func:`aggregate_counters` over ``B``
    rows: one (device, first row, end row) per maximal stretch of
    consecutive data shards on one device, cut at ``B`` (the padding rows
    are zero and add nothing; a stretch of padding alone is dropped)."""
    runs: List[Shard] = []
    for dev, r0, r1 in dp_shardings(mesh, padded_rows(mesh, B)):
        if runs and runs[-1][0] == dev:
            runs[-1] = (dev, runs[-1][1], r1)
        else:
            runs.append((dev, r0, r1))
    return [(dev, r0, min(r1, B)) for dev, r0, r1 in runs if r0 < B]


def aggregate_counters(mesh: DeviceMesh, good, bad) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global good / bad line counters over the data axis (the
    reference's Hadoop counters, RecordReader.java:118-120): one
    ``counters`` launch per :func:`counter_runs` stretch, over its rows of
    the masks in place (copied to its device only where they lie
    elsewhere), the stretches' counters added on the home device where
    there are several.  ``good`` / ``bad`` are [B] bool or int32 (tensors
    or numpy arrays), any B; returns two int32 scalars on the home device."""
    from ..tpu import kernels

    good, bad = _as_tensor(good), _as_tensor(bad)
    parts = [kernels.counters(good[r0:r1].to(dev), bad[r0:r1].to(dev))
             for dev, r0, r1 in counter_runs(mesh, good.shape[0])]
    if len(parts) == 1 and parts[0].device == mesh.home:
        total = parts[0]
    elif parts:
        total = torch.stack([p.to(mesh.home) for p in parts]).sum(dim=0, dtype=torch.int32)
    else:
        total = torch.zeros(2, dtype=torch.int32, device=mesh.home)
    return total[0], total[1]


__all__ = [
    "AXES", "DeviceMesh", "ShardedUnits", "SpTables", "aggregate_counters",
    "batch_parallel_runner", "counter_runs", "counters_plain", "data_parallel_runner",
    "dp_device_count", "dp_shardings", "gather_columns", "local_devices",
    "make_mesh", "padded_rows", "scatter_rows", "sequence_parallel_runner",
    "sp_halo_width", "sp_per_op", "sp_program_plain", "sp_split_plain",
    "sp_split_step_plain", "sp_tables", "SP_FIND", "SP_BYTES", "SP_CHARSET",
    "SP_MAX_LIT", "SP_OP_KINDS",
]
