#!/usr/bin/env python3
"""On-card smoke test of logparser_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for sm_90a), ``nvcc`` (CUDA_HOME or
/usr/local/cuda) and this checkout.  It drives the port's main path --
Apache ``combined`` with the headline fields, 65,536 generated lines
(seed 42, 1% garbage) plus crafted edge lines -- and fails (non-zero
exit, no result line) on the first phase that fails:

1. card    -- name and power limit (nvidia-smi), CUDA present;
2. build   -- the four kernels from logparser_tpu_torch/csrc, in parallel;
3. corpus  -- the generated lines + edge lines;
4. one phase per kernel (split, span_stages, timestamp, pack_rows): the
   kernel and its plain PyTorch version on the same CUDA tensors must be
   equal (exact integers, tolerance 0); median kernel time over 25
   launches with the L2 cache flushed before each, CUDA events;
5. end to end -- TorchBatchParser(...).parse_batch on the card, with the
   launch counts zeroed just before and read just after, compared with
   the same parser on the CPU (to_dict and needs_host); then a small batch
   at the widest line bucket (8191 bytes, one line past it);
6. the kernels line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.
"""
import json
import statistics
import subprocess
import sys
import time

H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_CUDA_CORE_OPS_PER_S = 67e12   # fp32 non-tensor rate; integer ALU work is counted against it
N_LINES = 65536
KERNEL_REPS = 25
PLAIN_REPS = 5
REPLACES = {
    "split": "logparser_tpu/tpu/pipeline.py:470",
    "span_stages": "logparser_tpu/tpu/postproc.py:1027",
    "timestamp": "logparser_tpu/tpu/timeparse.py:255",
    "pack_rows": "logparser_tpu/tpu/pipeline.py:888",
}
SOURCES = {k: f"logparser_tpu_torch/csrc/{k}.cu" for k in REPLACES}
EDGE_PREFIX = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 0'
EDGE_LINES = [
    EDGE_PREFIX + ' "x" "esc \\" quote"',                 # \" in the UA: final op, exact
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /p\\" HTTP/1.0" 200 0 "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 - "x" "y"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 '
    '12345678901234567890 "x" "y"',                        # 20-digit %b: big
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 '
    '9223372036854775808 "x" "y"',                         # 19 digits > Long.MAX
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /x" 200 5 "x" "y"',
    '1.2.3.4 - - [01/jan/2024:00:00:00 -0930] "GET / HTTP/1.1" 200 5 "x" "y"',
    '1.2.3.4 - - [31/Dec/2024:23:59:60 +1400] "GET / HTTP/1.1" 200 5 "x" "y"',
    '1.2.3.4 - - [29/Feb/2023:00:00:00 +0000] "GET / HTTP/1.1" 200 5 "x" "y"',
    EDGE_PREFIX + ' "x" "café ☃ UTF-8"',
    "",
    "completely broken line",
]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = out.stdout.strip().splitlines()
    if not lines:
        fail("nvidia-smi printed no card")
    return lines[0].strip()


def time_kernel(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() over reps launches, each after an L2
    flush (the 50 MB L2 would otherwise hold the 32 MB batch)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_abs_err(torch, a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def require_equal(torch, name, got, want) -> None:
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [(got, want)]
    for i, (g, w) in enumerate(pairs):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()
            fail(f"{name} output {i} differs from its plain version at "
                 f"{bad.shape[0]} places, first {bad[:3].tolist()}")


def main() -> int:
    import torch

    # ---- 1. card -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "torch_device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from logparser_tpu_torch import TorchBatchParser
    from logparser_tpu_torch.tools.demolog import HEADLINE_FIELDS, generate_combined_lines
    from logparser_tpu_torch.tpu import kernels, pipeline, runtime

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    info = kernels.build_info()
    regs = {k: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for k, log in info["ptxas"].items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": regs})

    # ---- 3. corpus -----------------------------------------------------
    lines = generate_combined_lines(N_LINES, seed=42, garbage_fraction=0.01)
    lines += EDGE_LINES
    L = runtime.bucket_length(max(len(x.encode()) for x in lines))
    pad = L - len((EDGE_PREFIX + ' "x" ""').encode())
    lines.append(EDGE_PREFIX + ' "x" "' + "u" * pad + '"')  # exactly L bytes
    buf, lengths, overflow = runtime.encode_batch(lines)
    B = len(lines)
    if buf.shape[1] != L or overflow:
        fail(f"corpus bucket {buf.shape[1]} != {L} or overflow {overflow}")
    emit({"phase": "corpus", "B": B, "L": L, "bytes": int(buf.nbytes)})

    gpu = TorchBatchParser("combined", HEADLINE_FIELDS)
    ex = gpu.executor
    unit = ex.unit_tables[0]
    dbuf = torch.from_numpy(buf).cuda()
    dlen = torch.from_numpy(lengths).cuda()

    # ---- 4. one phase per kernel ---------------------------------------
    rows = {}

    def phase(name, run_kernel, run_plain, bytes_moved, ops):
        got = run_kernel()
        want = run_plain()
        torch.cuda.synchronize()
        require_equal(torch, name, got, want)
        err = max_abs_err(torch, got, want)
        ms = time_kernel(torch, run_kernel, KERNEL_REPS)
        plain_ms = time_kernel(torch, run_plain, PLAIN_REPS)
        bound_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
        bound_ops = ops / H100_CUDA_CORE_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None,
        }
        emit({"phase": name, "equal": True, "B": B, "L": L, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": rows[name]["bound_ms"],
              "bytes": bytes_moved, "card": smi})
        return got

    T = unit.split.n_tok
    n_planes = unit.split.n_planes + int(unit.split.has_esc)
    C = (L + 31) // 32
    starts, ends, flags = phase(
        "split",
        lambda: kernels.split(unit.split, dbuf, dlen),
        lambda: pipeline.compute_split(unit.split.program, dbuf, dlen),
        bytes_moved=B * L + 4 * B + 2 * T * 4 * B + 4 * B,
        ops=B * C * 32 * (n_planes + 2),
    )

    stages = unit.stages
    toks = sorted({t[1] for t in stages.tasks_py})
    span_bytes = 0
    for t in stages.tasks_py:
        n = (ends[t[1]] - starts[t[1]]).clamp(0, L).to(torch.int64)
        if t[0] == pipeline.TASK_LONG:
            span_bytes += int(n.clamp(max=19).sum())
        elif t[2] == pipeline.PART_DIRECT:
            span_bytes += B + (int(n.clamp(max=12).sum()) if t[11] >= 0 else 0)
    fl_toks = {t[1] for t in stages.tasks_py if t[0] == pipeline.TASK_SPAN and t[2]}
    for tok in fl_toks:
        span_bytes += int((ends[tok] - starts[tok]).clamp(0, L).to(torch.int64).sum())
    comps = phase(
        "span_stages",
        lambda: kernels.span_stages(stages, dbuf, starts, ends),
        lambda: pipeline.span_stages_plain(
            stages, dbuf, starts, ends,
            torch.empty((stages.n_out, B), dtype=torch.int32, device="cuda")),
        bytes_moved=span_bytes + 2 * 4 * B * len(toks) + 4 * B * stages.n_out,
        ops=4 * span_bytes,
    )

    ts = unit.ts[0]
    window = ts.seg_w + 6   # the segment + the ZZ offset tail
    ts_out = phase(
        "timestamp",
        lambda: kernels.timestamp(ts, dbuf, starts, ends),
        lambda: pipeline.timestamp_plain(
            ts, dbuf, starts, ends,
            torch.empty((4, B), dtype=torch.int32, device="cuda")),
        bytes_moved=B * (window + 8 + 16),
        ops=4 * B * window,
    )

    all_comps = torch.cat([comps, ts_out]).contiguous()
    flags_u = flags[None, :].contiguous()
    pack = ex.pack
    n_slots = len(pack.slots_py)
    phase(
        "pack_rows",
        lambda: kernels.pack_rows(pack, flags_u, all_comps),
        lambda: pipeline.pack_rows_plain(pack, flags_u, all_comps),
        bytes_moved=4 * B * (all_comps.shape[0] + 1 + ex.n_out_rows),
        ops=3 * B * (n_slots + 8 * pack.V),
    )

    # ---- 5. end to end -------------------------------------------------
    gpu.parse_batch(lines[:4096])  # warm the caching allocator
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = gpu.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
        rows[name]["launches"] = n
    cpu = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    ref = cpu.parse_batch(lines)
    if not (res.needs_host.tolist() == ref.needs_host.tolist()):
        fail(f"needs_host differs: {res.needs_host[:10]} vs {ref.needs_host[:10]}")
    got_d, want_d = res.to_dict(), ref.to_dict()
    for fid in want_d:
        if got_d[fid] != want_d[fid]:
            i = next(i for i, (a, b) in enumerate(zip(got_d[fid], want_d[fid])) if a != b)
            fail(f"end to end: {fid} row {i}: {got_d[fid][i]!r} != {want_d[fid][i]!r}")
    n_valid = int(res.valid.sum())
    if n_valid < 0.98 * N_LINES:
        fail(f"only {n_valid} of {B} lines valid on device")
    emit({"phase": "end_to_end", "B": B, "L": L, "equal_to_cpu": True,
          "valid": n_valid, "needs_host": len(res.needs_host),
          "stage_seconds": res.stage_seconds, "wall_seconds": wall,
          "lines_per_s": B / wall,
          "device_lines_per_s": B / res.stage_seconds["kernels"],
          "d2h_bytes": res.d2h_bytes, "launches": launches, "card": smi})

    wide = generate_combined_lines(256, seed=7, garbage_fraction=0.05)
    wide.append(EDGE_PREFIX + ' "x" "' + "w" * (8191 - len(EDGE_PREFIX) - 7) + '"')
    wide.append(EDGE_PREFIX + ' "x" "' + "v" * 9000 + '"')   # past the cap: host
    res_w = gpu.parse_batch(wide)
    ref_w = cpu.parse_batch(wide)
    if res_w.buf.shape[1] != 8191 or res_w.to_dict() != ref_w.to_dict() \
            or res_w.needs_host.tolist() != ref_w.needs_host.tolist():
        fail("the 8191-byte bucket batch differs from the CPU run")
    if len(wide) - 1 not in res_w.needs_host.tolist():
        fail("the over-long line was not routed to the host")
    emit({"phase": "wide_bucket", "B": len(wide), "L": 8191,
          "equal_to_cpu": True, "needs_host": res_w.needs_host.tolist()})

    # ---- 6. result -----------------------------------------------------
    print(smi, flush=True)
    emit({"kernels": [rows[k] for k in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
