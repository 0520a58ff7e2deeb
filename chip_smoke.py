#!/usr/bin/env python3
"""On-card smoke test of logparser_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for sm_90a), ``nvcc`` (CUDA_HOME or
/usr/local/cuda) and this checkout.  It drives the port's eight paths --
Apache ``combined`` with the headline fields (65,536 generated lines,
seed 42, 1% garbage, plus crafted edge lines), the URI chain
(``URI_CHAIN_FIELDS``: path, query parameters, the protocol split, the
referer's authority; 65,536 generated lines, seed 53, plus the URI edge
lines), and the two strftime configurations (``combinedio_strftime``:
``%{%d/%b/%Y:%H:%M:%S %z}t`` with %I / %O, seed 43; ``strftime_zonetext``:
``%Z`` zone names, seed 48; 65,536 generated lines each plus the strftime
edge lines), GeoIP enrichment (``geoip_chain``: country, city and ASN of
the client over the fixture databases, seed 45; ``geoip_synthetic``: the
same over a synthetic City database of 131,072 networks written at first
use, seed 46) and NGINX (``nginx_uri``, seed 44; ``nginx_timing``: $msec
and $request_time, seed 49) -- then the analytics pushdown (the dashboard
aggregate over the headline fields, 65,536 lines, seed 42, plus crafted
fold lines) and ``cookies_uniqueid`` (request cookies, Set-Cookie lists
and mod_unique_id tokens, seed 50) and the other entry points (run_program,
parse_blob, aggregate_blob, the two streams, the unescape and GeoIP
gather utilities), and fails (non-zero exit, no result line) on the
first phase that fails:

1. card    -- name and power limit (nvidia-smi), CUDA present;
2. build   -- the nineteen kernels from logparser_tpu_torch/csrc, in parallel
   (ptxas's register and stack-frame lines of each in the phase line),
   and beside them the g++ line framer (logparser_tpu_torch/native), which
   must build: the blob and stream phases fail on a numpy framing;
   2b. timing -- the yardstick (DeviceClock): a kernel's or a library
   call's time is device time with the host out of the window -- each of
   25 reps flushes L2, enqueues a GPU busy wait (torch.cuda._sleep) of
   twice the call's host enqueue time plus 0.02 ms, then records start,
   calls, records stop; the phase prints the busy wait's calibration and
   the time of an empty window behind it, which must be under 0.005 ms;
3. corpus  -- the generated lines + edge lines;
4. one phase per kernel (split, span_stages, timestamp, pack_rows): the
   kernel and its plain PyTorch version on the same CUDA tensors must be
   equal (exact integers, tolerance 0); the kernel's median device time
   (``ms``) beside its host enqueue (``enqueue_ms``), the library call's
   the same way (``library_ms``, ``library_enqueue_ms``), the plain
   version's median over 5 runs, each after an L2 flush, events around
   the enqueue as well (``plain_ms``);
   4b. ``span_stages_seeded`` and ``pack_rows_seeded``: the two kernels
   on tools/kernel_ab.py's seeded edge cases (seeded_span_case under
   seeded_stage_tables; seeded_pack_case's lines of eight formats), equal
   to their plain versions;
5. end to end -- TorchBatchParser(...).parse_batch on the card, with the
   launch counts zeroed just before and read just after, compared with
   the same parser on the CPU (to_dict, valid, reject_reasons and
   needs_host -- the rows the host oracle rescued -- equal); then a small
   batch at the widest line bucket (8191 bytes, one line past it, which
   the host oracle must return valid with the CPU's values);
   5b. runtime.run_program (the split-only entry) on the headline batch
   against compute_split; the unescape utility (postproc.
   unescape_compact_spans) over the user-agent spans of 65,536 headline
   lines with 5% escaped quotes, against its plain version, then on
   tools.kernel_ab's seeded spans (``unescape_seeded``: L = 384, width
   121, B = 65,547; ``unescape_seeded_8191`` at width 8,191, the direct
   path, and ``unescape_seeded_cap`` at width 512, the widest staged one,
   B = 4,107 each; every read and walk kind present), and the spec's
   fuzz cases; parse_blob of the headline batch as one blob (CRLF on some
   lines, a trailing newline), equal to the CPU's parse_batch of the same
   lines, with its encode seconds beside parse_batch's;
6. the URI chain: split (``split_uri``), span_stages (with the protocol
   split), uri_split and csr_split (one launch per group, two groups
   each) and pack_rows (with
   the overflow bit) against their plain versions under its tables at
   16 slots, timed the same way; then parse_batch end to end, which
   regrows the query-string slots on the card (16 -> 128: one edge line
   has more parameters than the cap) and must equal the CPU, then the
   same batch again at the grown slots; then the 8191-byte bucket;
7. the strftime configurations: split, span_stages, timestamp (one
   fixed segment with the %z tail; a fixed segment and the %Z zone
   segment), zone_lookup (gated, on the %Z timestamp's rows; and alone
   on every transition key +-1 minute, each zone's window edges and
   65,536 random pairs) and pack_rows under each configuration's tables
   against their plain versions, timed the same way; parse_batch end to
   end for each, equal to the CPU, with no generated timestamp line in
   needs_host; then the zone-text 8191-byte bucket.  Each end-to-end
   line carries its path's bound: the sum of its kernels' bounds;
8. GeoIP: ipv4_spans (one launch for the IP token that both groups, City
   and ASN, read), geo_lookup (one a group) and pack_rows (the IPv6
   constraint) against their plain versions on the geoip_chain batch;
   ipv4_spans on tools.kernel_ab's seeded spans over two tokens
   (``ipv4_spans_seeded``); geo_lookup alone on a seeded table of 4,194,304
   ranges (262,146 keys: the start, end and both neighbours of every 64th
   range, 0 and 0xFFFFFFFF; its bound counts the 32-byte sectors of starts
   a host simulation of the same search touches) beside
   torch.searchsorted, and on an empty table; parse_batch end to end on
   both GeoIP configurations, each with exactly one ipv4_spans launch per
   IP token (the synthetic one also reports the seconds
   to write the database and to build its table), geo_lookup on the
   synthetic City table (``geo_lookup_synthetic``),
   GeoDeviceTable.gather_columns of every synthetic City column by the
   batch's looked-up rows and crafted out-of-range ones in one launch,
   timed for one column (``geo_gather``) and the whole table
   (``geo_gather_table``) beside torch.index_select, the
   8191-byte bucket, City and ASN over two IP tokens
   (``end_to_end_geo_two_tokens``: two ipv4_spans launches, card = CPU),
   and ``host_fields``: 4,096 geoip_chain lines with country.name under
   both the City and the Country dissector (two producers: a host field),
   split launched, every row equal to the CPU, every device-valid row
   rescued by the host oracle (rescue_reasons["host_fields"]), with the
   oracle's lines per second;
9. NGINX: span_stages (the secmillis tasks) and pack_rows under the
   nginx_timing tables against their plain versions; parse_batch end to
   end on both NGINX configurations and the 8191-byte bucket;
10. the analytics pushdown: agg_lanes (cls and lanes), agg_reduce
   (n_device, sum tiles, histogram bins; beside a reshaped sum of the tile
   halves) and agg_group (one launch per grouping lane; groups compared as
   {key bytes: count} with no key split; the int lane beside
   torch.unique) against their plain versions on the dashboard batch,
   timed the same way; then the dashboard aggregate end to end (counts
   zeroed just before, read just after), equal to the CPU's
   AggregateState, needs_host and row accounting, with at least 10x fewer
   D2H bytes than parse_batch on the same batch and the crafted lines
   folded, then aggregate and parse_batch in turns for lines/s, then
   aggregate_blob of the same lines equal to the CPU's state.  Each of
   sections 5 to 9 also runs its configuration's representative_spec
   (the reference bench's parity sweep) on the card against the CPU
   (phases ``agg_parity_*``), and the URI chain a count_by over the query
   key ``q`` passed as an AggregateSpec (phase ``agg_query_key``) and
   agg_lanes on QUERY_KEY_OPS' query-key lane over its batch against the
   plain version (``agg_lanes_query_key``);
11. cookies, Set-Cookie and mod_unique_id (``cookies_uniqueid``: 65,536
   generated lines, seed 50, plus the cookie edge lines): parse_batch end
   to end on a fresh parser, which regrows 16 -> 128 slots on the card,
   equal to the CPU (phase ``end_to_end_cookies``, then
   ``end_to_end_cookies_grown``); under the grown tables split
   (``split_cookies``), setcookie_split, csr_split in cookie mode
   (``csr_split_cookie``) and muid against their
   plain versions, timed the same way, and muid on tools.kernel_ab's
   seeded tokens at L = 2,048 and 64 (``muid_seeded``, ``muid_seeded_64``); split on a NUL-separated format
   (``split_nul``, then ``end_to_end_nul``); small legs, card = CPU only:
   a multi-format parser with a plausibility-only probe unit, NGINX
   upstream-list elements, BYTESCLF over ``%B``, the cookie path's
   8191-byte bucket.  Every end-to-end comparison in sections 5 to 11
   holds needs_host (the oracle's rows), valid, reject_reasons, to_dict()
   and to_arrow(strings="copy") equal, and every end-to-end phase line
   carries the oracle's share: oracle_rows, rescue_reasons, rescue_wall_s;
12. streams: parse_batch_stream over six batches of 65,536 lines
   (headline, the URI chain regrowing 16 -> 128 mid-stream, headline),
   each equal to its parse_batch on the card, the stream wall beside the
   serial walls; aggregate_batch_stream(depth=2) over three dashboard
   batches, each state equal to aggregate_batch's;
   12b. columnar delivery (``arrow_delivery_<path>``, then
   ``arrow_delivery``) on the headline, URI chain, cookies_uniqueid and
   geoip_chain batches: a fresh parse on the card, then to_arrow() (every
   view field interleaved from the card's view rows by
   native.views_interleave, the count printed), to_arrow(strings="copy"),
   span_bytes_many, the to_pylist walk and parse_to_ipc, each timed, each
   table equal to the CPU's; a view table held across the next batch's
   parse keeps its values; the native library must be built;
13. the device mesh, each phase over ``parallel.mesh.local_devices``
   replaced with ``[cuda:0] * 4`` (one card holds every shard; restored
   after): ``mesh_dp`` (the headline batch, padded with 3 empty rows to
   B = 65,552, through data_parallel_runner and batch_parallel_runner with
   view rows on a 4 x 1 mesh, equal to run_program / the executor bit for
   bit, timed beside them); ``mesh_dp_uri`` (the URI chain under
   data_parallel=4: the edge lines that force 16 -> 128 lie in one shard,
   the whole batch regrows, equal to the unsharded card parser);
   ``parser_dp`` (the headline parser with data_parallel=4: parse_batch,
   parse_blob, a 3-batch parse_batch_stream and the dashboard
   aggregate_batch equal to the unsharded parser, to_arrow and IPC bytes
   included); ``sp_split`` (the padded headline batch on a 2 x 4 mesh,
   shard width 96: the runner makes one sp_program launch per data shard
   and no sp_split launch; equal to the runner over sp_program's plain
   version, to the per-op path -- sp_split per op, mode and seq shard,
   the combines in PyTorch, as on distinct cards -- and to run_program on
   every row without ``\\"``; sp_program's launches against their plain
   version, the per-op path's launches against theirs, both timed);
   ``sp_long`` (8,192 lines of 8,192 to 32,000 bytes, seed 63, L = 32,768
   on 1 x 4: one sp_program launch, equal to its plain version and to the
   per-op path, every non-garbage row valid, both paths timed, lines/s);
   ``counters`` (valid and ~valid of the headline parse over 4 shards
   on one card: one launch, = valid.sum(); the kernel timed beside
   torch.stack((good, bad)).sum(1)), ``counters_runner`` (the whole
   aggregate_counters call's wall, the host included);
   ``mesh_multi_card`` (mesh_dp, parser_dp and sp_split again on
   distinct cards when the machine has two or more -- SP there takes the
   per-op path: sp_split launched, sp_program not -- each equal to one
   card, else a line saying it was skipped);
14. the kernels line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.
"""
import json
import statistics
import subprocess
import sys
import threading
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
    "uri_split": "logparser_tpu/tpu/postproc.py:210",
    "csr_split": "logparser_tpu/tpu/postproc.py:640",
    "zone_lookup": "logparser_tpu/dissectors/tztable.py:344",
    "ipv4_spans": "logparser_tpu/tpu/postproc.py:557",
    "geo_lookup": "logparser_tpu/geoip/device.py:102",
    "agg_lanes": "logparser_tpu/analytics/device.py:374",
    "agg_reduce": "logparser_tpu/analytics/device.py:352",
    "agg_group": "logparser_tpu/analytics/device.py:233",
    "setcookie_split": "logparser_tpu/tpu/postproc.py:843",
    "muid": "logparser_tpu/tpu/postproc.py:957",
    "unescape": "logparser_tpu/tpu/postproc.py:1131",
    "geo_gather": "logparser_tpu/geoip/device.py:114",
    "sp_split": "logparser_tpu/parallel/mesh.py:224",
    "sp_program": "logparser_tpu/parallel/mesh.py:173",
    "counters": "logparser_tpu/parallel/mesh.py:243",
}
SOURCES = {k: f"logparser_tpu_torch/csrc/{k}.cu" for k in REPLACES}
# Section 12b's batches: path -> (card parser, CPU parser, lines, the CPU's
# result), kept by each path's end-to-end phase.
DELIVERY = {}
DELIVERY_PATHS = ("headline", "uri_chain", "cookies_uniqueid", "geoip_chain")
CPU_IPC_PATHS = ("headline", "geoip_chain")
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def rescue(res) -> dict:
    """The host oracle's share of one result (a BatchResult, or an
    AggregateOutcome's fold replay): rows it visited, why, its wall."""
    return {"oracle_rows": res.oracle_rows, "rescue_reasons": res.rescue_reasons,
            "rescue_wall_s": res.rescue_wall_s}


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
    flush (the 50 MB L2 would otherwise hold the 32 MB batch).  The events
    bracket the host's enqueue too: where fn's Python outlasts the flush,
    the card idles inside the window.  For the plain versions and the
    mesh's runners; kernels and library calls take DeviceClock.time."""
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


class DeviceClock:
    """Device time of a call, with the host's enqueue out of the window.

    Each rep flushes L2, enqueues a GPU busy wait (``torch.cuda._sleep``)
    of at least twice the call's host enqueue time, then records start,
    calls fn and records stop: the whole enqueue lands while the card is
    still busy, so the events bracket the call's device work alone.  The
    enqueue is timed once a call with ``time.perf_counter`` around a warm
    call; the busy wait's cycles are converted to milliseconds once, with
    events (``cycles_per_ms``)."""

    CALIBRATION_CYCLES = 1 << 21
    PAD_MS = 0.02   # beyond twice the enqueue: the host's jitter

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        torch.cuda._sleep(self.CALIBRATION_CYCLES)   # warm
        ms = []
        for _ in range(5):
            start, stop = self._events()
            start.record()
            torch.cuda._sleep(self.CALIBRATION_CYCLES)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
        self.cycles_per_ms = self.CALIBRATION_CYCLES / statistics.median(ms)

    def _events(self):
        return (self.torch.cuda.Event(enable_timing=True),
                self.torch.cuda.Event(enable_timing=True))

    def enqueue_ms(self, fn) -> float:
        """Host milliseconds of one warm call of fn (its enqueue)."""
        fn()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        self.torch.cuda.synchronize()
        return (t1 - t0) * 1e3

    def window(self, fn, reps: int, enqueue_ms: float):
        """Event times of fn() behind a busy wait sized for enqueue_ms."""
        cycles = int((2 * enqueue_ms + self.PAD_MS) * self.cycles_per_ms)
        times = []
        for _ in range(reps):
            self.flush.zero_()
            self.torch.cuda._sleep(cycles)
            start, stop = self._events()
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return times

    def time(self, fn, reps: int):
        """(median device milliseconds over reps, enqueue milliseconds)."""
        enqueue = self.enqueue_ms(fn)
        return statistics.median(self.window(fn, reps, enqueue)), enqueue


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

    if sys.argv[1:]:
        fail(f"usage: python3 chip_smoke.py, got {sys.argv[1:]}")

    # ---- 1. card -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "torch_device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from logparser_tpu_torch import TorchBatchParser
    from logparser_tpu_torch.tools.demolog import HEADLINE_FIELDS, generate_combined_lines
    from logparser_tpu_torch import native
    from logparser_tpu_torch.tpu import kernels, pipeline, runtime

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    framer_build = threading.Thread(target=native.get_lib)
    framer_build.start()   # g++ beside the nvcc processes
    kernels.build()
    framer_build.join()
    info = kernels.build_info()
    regs = {k: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "stack frame" in ln]
            for k, log in info["ptxas"].items()}
    if not native.native_available():
        fail("the g++ framer (logparser_tpu_torch/native/logframe.cc) did not build")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": len(kernels.KERNELS), "native_available": native.native_available(),
          "framer_build_seconds": native.build_seconds(), "ptxas": regs})

    # ---- 2b. the yardstick ---------------------------------------------
    clock = DeviceClock(torch)
    empty = clock.window(lambda: None, KERNEL_REPS, 0.0)
    if statistics.median(empty) >= 0.005:
        fail(f"an empty window behind the busy wait reads {statistics.median(empty)} ms")
    emit({"phase": "timing", "empty_window_ms": statistics.median(empty),
          "empty_window_max_ms": max(empty), "cycles_per_us": clock.cycles_per_ms / 1e3,
          "pad_ms": clock.PAD_MS, "reps": KERNEL_REPS})

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
    dbuf = torch.from_numpy(buf).cuda()
    dlen = torch.from_numpy(lengths).cuda()

    # ---- 4. one phase per kernel ---------------------------------------
    rows = {}

    def phase(name, run_kernel, run_plain, bytes_moved, ops, kernel=None, n=None,
              width=None, library=None, compare=None, extra=None):
        """Kernel vs plain version on the same CUDA tensors, then timed.
        ``kernel`` names the kernels-line row when the phase name differs
        (a kernel re-run under the URI chain's tables keeps its slice-1
        row and reports here only); ``library`` is one PyTorch call
        computing the same function, timed the same way; ``compare``
        (got, want) -> max abs error replaces the exact tensor comparison
        (it calls fail itself); ``extra`` adds keys to the phase line."""
        got = run_kernel()
        want = run_plain()
        torch.cuda.synchronize()
        if compare is None:
            require_equal(torch, name, got, want)
            err = max_abs_err(torch, got, want)
        else:
            err = compare(got, want)
        ms, enqueue_ms = clock.time(run_kernel, KERNEL_REPS)
        plain_ms = time_kernel(torch, run_plain, PLAIN_REPS)
        library_ms, library_enqueue_ms = (clock.time(library, KERNEL_REPS) if library
                                          else (None, None))
        bound, bound_by = bound_ms(bytes_moved, ops)
        row = {
            "name": kernel or name, "route": "cuda",
            "source": SOURCES[kernel or name],
            "replaces": REPLACES[kernel or name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
        }
        phase.bounds[name] = bound
        if kernel is None:
            rows[name] = row
        emit({"phase": name, "equal": True, "B": n or B,
              "L": L if width is None else width, "ms": ms, "enqueue_ms": enqueue_ms,
              "plain_ms": plain_ms, "bound_ms": row["bound_ms"],
              "bound_by": row["bound_by"], "library_ms": library_ms,
              "library_enqueue_ms": library_enqueue_ms,
              "bytes": bytes_moved, **(extra or {}), "card": smi})
        return got

    phase.bounds = {}
    phase.clock = clock
    single_card_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase,
                       rows, smi, gpu, lines, buf, lengths, dbuf, dlen)

    # ---- 13. the device mesh ----------------------------------------------
    mesh_phases(torch, TorchBatchParser, kernels, runtime, phase, rows, smi, gpu,
                lines, buf, lengths)

    # ---- 14. result ------------------------------------------------------
    missing = [k for k in REPLACES if k not in rows]
    if missing:
        fail(f"no kernels-line row for {missing}")
    print(smi, flush=True)
    emit({"kernels": [rows[k] for k in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def single_card_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows,
                       smi, gpu, lines, buf, lengths, dbuf, dlen):
    """Sections 4 to 12: every kernel against its plain version and every
    single-card path end to end."""
    from logparser_tpu_torch.tools.demolog import (
        HEADLINE_FIELDS,
        URI_CHAIN_FIELDS,
        generate_combined_lines,
        uri_edge_lines,
    )

    B, L = buf.shape
    ex = gpu.executor
    unit = ex.unit_tables[0]
    starts, ends, flags = phase(
        "split",
        lambda: kernels.split(unit.split, dbuf, dlen),
        lambda: pipeline.compute_split(unit.split.program, dbuf, dlen),
        *split_cost(unit.split, B, L),
    )

    stages = unit.stages
    comps = phase(
        "span_stages",
        lambda: kernels.span_stages(stages, dbuf, starts, ends),
        lambda: pipeline.span_stages_plain(
            stages, dbuf, starts, ends,
            torch.empty((stages.n_out, B), dtype=torch.int32, device="cuda")),
        *span_stages_cost(torch, pipeline, stages, starts, ends, B, L),
    )

    ts = unit.ts[0]
    ts_out = phase(
        "timestamp",
        lambda: kernels.timestamp(ts, dbuf, starts, ends),
        lambda: pipeline.timestamp_plain(
            ts, dbuf, starts, ends,
            torch.empty((4, B), dtype=torch.int32, device="cuda")),
        *timestamp_cost(torch, ts, starts, ends, B, L),
    )

    all_comps = torch.cat([comps, ts_out]).contiguous()
    flags_u = flags[None, :].contiguous()
    pack = ex.pack
    phase(
        "pack_rows",
        lambda: kernels.pack_rows(pack, flags_u, all_comps),
        lambda: pipeline.pack_rows_plain(pack, flags_u, all_comps),
        *pack_cost(ex, all_comps.shape[0], B),
    )

    # ---- 4b. the seeded edge cases of span_stages and pack_rows -----------
    seeded_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase)

    # ---- 5. end to end -------------------------------------------------
    gpu.parse_batch(lines[:4096])  # warm the caching allocator
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = gpu.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("split", "span_stages", "timestamp", "pack_rows"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the main path")
        rows[name]["launches"] = launches[name]
    cpu = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    ref = cpu.parse_batch(lines)
    compare_results(res, ref, "end to end")
    DELIVERY["headline"] = (gpu, cpu, lines, ref)
    n_valid = int(res.valid.sum())
    if n_valid < 0.98 * N_LINES:
        fail(f"only {n_valid} of {B} lines valid on device")
    emit({"phase": "end_to_end", "B": B, "L": L, "equal_to_cpu": True,
          "valid": n_valid, "needs_host": len(res.needs_host), **rescue(res),
          "path_bound_ms": sum(phase.bounds[k] for k in
                               ("split", "span_stages", "timestamp", "pack_rows")),
          "stage_seconds": res.stage_seconds, "wall_seconds": wall,
          "lines_per_s": B / wall,
          "device_lines_per_s": B / res.stage_seconds["kernels"],
          "d2h_bytes": res.d2h_bytes, "launches": launches, "card": smi})
    agg_parity(torch, kernels, gpu, cpu, lines, "agg_parity_headline", smi)

    wide = generate_combined_lines(256, seed=7, garbage_fraction=0.05)
    wide.append(EDGE_PREFIX + ' "x" "' + "w" * (8191 - len(EDGE_PREFIX) - 7) + '"')
    wide.append(EDGE_PREFIX + ' "x" "' + "v" * 9000 + '"')   # past the cap: host
    res_w = gpu.parse_batch(wide)
    if res_w.buf.shape[1] != 8191:
        fail(f"the wide batch took bucket {res_w.buf.shape[1]}, not 8191")
    compare_results(res_w, cpu.parse_batch(wide), "wide bucket")
    hold_timestamp(gpu, wide, "wide_bucket")
    if len(wide) - 1 not in res_w.needs_host.tolist():
        fail("the over-long line was not routed to the host")
    if not res_w.valid[len(wide) - 1]:
        fail("the over-long line came back invalid from the host oracle")
    emit({"phase": "wide_bucket", "B": len(wide), "L": 8191,
          "equal_to_cpu": True, "needs_host": res_w.needs_host.tolist(), **rescue(res_w)})

    # ---- 5b. the split-only entry, the unescape utility, the blob ------
    run_program_phase(torch, kernels, pipeline, runtime, phase, unit, dbuf, dlen, B, L)
    unescape_phases(torch, kernels, runtime, phase, rows, smi)
    blob_phase(kernels, gpu, lines, ref, res, smi)

    # ---- 6. the URI chain -----------------------------------------------
    uri_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows,
               smi, URI_CHAIN_FIELDS, generate_combined_lines, uri_edge_lines)

    # ---- 7. the strftime configurations ---------------------------------
    strftime_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase,
                    rows, smi)

    # ---- 8. GeoIP --------------------------------------------------------
    geo_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows, smi)

    # ---- 9. NGINX --------------------------------------------------------
    nginx_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows, smi)

    # ---- 10. the analytics pushdown --------------------------------------
    agg_phases(torch, TorchBatchParser, kernels, runtime, phase, rows, smi)

    # ---- 11. cookies, Set-Cookie, mod_unique_id, NUL separators ----------
    cookie_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows, smi)

    # ---- 12. streams -----------------------------------------------------
    stream_phases(torch, TorchBatchParser, kernels, smi)

    # ---- 12b. columnar delivery --------------------------------------------
    arrow_delivery_phases(kernels, smi)


def seeded_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase):
    """Section 4b: span_stages on tools.kernel_ab's seeded spans (every
    task kind over two tokens) and pack_rows on its seeded lines of eight
    formats (every line-constraint kind, contested lines, view fields
    that several units decode), each equal to its plain version."""
    from logparser_tpu_torch.tools import kernel_ab

    buf, s, e = kernel_ab.seeded_span_case(N_LINES + 11, 384, seed=13)
    stages = kernel_ab.seeded_stage_tables(pipeline).cuda()
    dbuf, starts, ends = (torch.from_numpy(x).cuda() for x in (buf, s, e))
    B, L = buf.shape
    phase("span_stages_seeded",
          lambda: kernels.span_stages(stages, dbuf, starts, ends),
          lambda: pipeline.span_stages_plain(
              stages, dbuf, starts, ends,
              torch.empty((stages.n_out, B), dtype=torch.int32, device="cuda")),
          *span_stages_cost(torch, pipeline, stages, starts, ends, B, L),
          kernel="span_stages", n=B, width=L)

    lines = kernel_ab.seeded_pack_case(N_LINES + 11, seed=13)
    buf, lengths, _ = runtime.encode_batch(lines)
    B, L = buf.shape
    ex = TorchBatchParser(kernel_ab.SEEDED_PACK_FORMAT, kernel_ab.SEEDED_PACK_FIELDS).executor
    flags, comps = ex.components(torch.from_numpy(buf).cuda(), torch.from_numpy(lengths).cuda())
    want = pipeline.pack_rows_plain(ex.pack, flags, comps)
    contested = kernel_ab.contested_lines(want.cpu().numpy(), ex.pack)
    kinds = sorted({kind for _, kind in ex.pack.cons_py})
    if ex.pack.U != pipeline.MAX_UNITS or not contested or kinds != list(range(5)):
        fail(f"the seeded pack lines lost their premise: {ex.pack.U} units, "
             f"{contested} contested lines, constraint kinds {kinds}")
    phase("pack_rows_seeded",
          lambda: kernels.pack_rows(ex.pack, flags, comps),
          lambda: pipeline.pack_rows_plain(ex.pack, flags, comps),
          *pack_cost(ex, comps.shape[0], B), kernel="pack_rows", n=B, width=L,
          extra={"units": ex.pack.U, "contested": contested, "K": ex.pack.K})


def run_program_phase(torch, kernels, pipeline, runtime, phase, unit, dbuf, dlen, B, L):
    """runtime.run_program on the headline batch: driven once with the
    launch counts zeroed just before and read just after, then held to
    compute_split (starts, ends, valid) and timed like a kernel."""
    program = unit.split.program

    def run():
        out = runtime.run_program(program, dbuf, dlen)
        return out["starts"], out["ends"], out["valid"]

    def plain():
        starts, ends, flags = pipeline.compute_split(program, dbuf, dlen)
        return starts, ends, (flags & pipeline.SPLIT_VALID) != 0

    kernels.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches["split"] < 1:
        fail("run_program did not launch the split kernel")
    phase("run_program", run, plain, *split_cost(unit.split, B, L), kernel="split",
          extra={"launches": launches["split"]})


# The fuzz cases of the reference's unescape spec (tests/test_fuzz_differential.py):
# (span, exact, the reference decode of an exact span).
UNESCAPE_CASES = [
    (b'esc \\" quote', True, b'esc " quote'),
    (b"a\\\\b", True, b"a\\b"),
    (b'a\\\\\\"b', True, b'a\\"b'),
    (b'run\\\\\\\\\\"x', True, b'run\\\\"x'),
    (b'\\" \\" \\"', True, b'" " "'),
    (b"plain", True, b"plain"),
    (b"tail\\\\", True, b"tail\\"),
    (b"a\\qb", True, b"a\\qb"),
    (b"odd\\", False, None),
    (b"a\\nb", False, None),
    (b"\\x41z", False, None),
]


def unescape_corpus(runtime):
    """(lines, buf, starts, ends, width) of the unescape phase: the
    user-agent spans of the headline corpus with 5% of lines carrying an
    escaped quote (the reference bench's corpus, B = 65,536), the window
    one byte wider than the longest span."""
    import numpy as np

    from logparser_tpu_torch.tools.demolog import (
        force_escaped_quote_lines,
        generate_combined_lines,
    )

    lines = force_escaped_quote_lines(generate_combined_lines(N_LINES, seed=42), 5)
    buf, lengths, _ = runtime.encode_batch(lines)
    # The UA span is the final quoted field, opened by the last ' "'.
    starts = np.array([ln.rindex(' "') + 2 for ln in lines], dtype=np.int32)
    ends = np.array([len(ln) - 1 for ln in lines], dtype=np.int32)
    width = min(int((ends - starts).max()) + 1, buf.shape[1])
    return lines, buf, starts, ends, width


def unescape_cost(torch, s, e, B, L, width):
    """(bytes, operations) of unescape: each row's window bytes that lie
    inside the line (min(n, width) from its start, Row::at's 0 past L),
    the cursors in, the [B, width] window, out_len and exact out; ~10
    operations a byte read."""
    width = min(width, L)
    mask = (1 << max(1, (L - 1).bit_length())) - 1
    m = (e.to(torch.int64) - s).clamp(0, width)
    n_read = int(torch.minimum(m, (L - (s.to(torch.int64) & mask)).clamp(min=0)).sum())
    return n_read + 8 * B + B * width + 5 * B, 10 * n_read


def unescape_phases(torch, kernels, runtime, phase, rows, smi):
    """The unescape utility over the user-agent spans of the headline
    corpus (unescape_corpus): postproc.unescape_compact_spans driven once
    with the counts zeroed, then the kernel against its plain version
    (out, out_len, exact), timed; then tools.kernel_ab's seeded spans at
    three (L, width) shapes (every kind of read and walk present); then
    the spec's fuzz cases."""
    import numpy as np

    from logparser_tpu_torch.tools import kernel_ab
    from logparser_tpu_torch.tpu import postproc

    lines, buf, starts, ends, width = unescape_corpus(runtime)
    B, L = buf.shape
    dbuf, ds, de = (torch.from_numpy(a).cuda() for a in (buf, starts, ends))
    kernels.reset_launch_counts()
    out, out_len, exact = postproc.unescape_compact_spans(dbuf, ds, de, width)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["unescape"]
    if launches < 1:
        fail("unescape_compact_spans did not launch the unescape kernel")
    escaped = sum('"esc \\" quote' in ln for ln in lines)
    span_len = torch.from_numpy(ends - starts).cuda()
    phase("unescape", lambda: kernels.unescape(dbuf, ds, de, width),
          lambda: postproc.unescape_compact_spans_plain(dbuf, ds, de, width),
          *unescape_cost(torch, ds, de, B, L, width), n=B, width=width,
          extra={"L": L, "launches": launches, "escaped_lines": escaped,
                 "exact_rows": int(exact.sum()),
                 "kinds": kernel_ab.unescape_kinds(buf, starts, ends, width)})
    rows["unescape"]["launches"] = launches
    if int((out_len < span_len).sum()) != escaped or not bool(exact.all()):
        fail("unescape: the escaped-quote lines did not each lose one byte, "
             "or a row was inexact")

    for tag, (sL, swidth, sB) in zip(("unescape_seeded", "unescape_seeded_8191",
                                      "unescape_seeded_cap"), kernel_ab.UNESCAPE_SEEDED):
        sbuf, s, e = kernel_ab.seeded_unescape_case(sB, sL, swidth, seed=sL + swidth)
        kinds = kernel_ab.unescape_kinds(sbuf, s, e, swidth)
        if not all(kinds[k] for k in ("chunks", "bytes", "backslash_free", "walked")):
            fail(f"{tag}: the seeded spans lost a path kind: {kinds}")
        sd, ss, se = (torch.from_numpy(a).cuda() for a in (sbuf, s, e))
        phase(tag, lambda: kernels.unescape(sd, ss, se, swidth),
              lambda: postproc.unescape_compact_spans_plain(sd, ss, se, swidth),
              *unescape_cost(torch, ss, se, sB, sL, swidth), kernel="unescape", n=sB,
              width=swidth, extra={"L": sL, "kinds": kinds})
        del sd, ss, se

    case = np.zeros((len(UNESCAPE_CASES), 64), dtype=np.uint8)
    for i, (c, _, _) in enumerate(UNESCAPE_CASES):
        case[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
    args = (torch.from_numpy(case).cuda(), torch.zeros(len(case), dtype=torch.int32).cuda(),
            torch.tensor([len(c) for c, _, _ in UNESCAPE_CASES], dtype=torch.int32).cuda())
    got = kernels.unescape(*args, 32)
    require_equal(torch, "unescape_cases", got, postproc.unescape_compact_spans_plain(*args, 32))
    o, n, e = (t.cpu().numpy() for t in got)
    for i, (c, want_exact, decoded) in enumerate(UNESCAPE_CASES):
        if bool(e[i]) != want_exact or (want_exact and bytes(o[i, :n[i]]) != decoded):
            fail(f"unescape case {c!r}: exact {bool(e[i])}, out {bytes(o[i, :n[i]])!r}")
    emit({"phase": "unescape_cases", "equal": True, "cases": len(UNESCAPE_CASES),
          "card": smi})


def blob_phase(kernels, gpu, lines, ref, res, smi):
    """parse_blob on the card: the headline corpus and its edge lines as one
    blob, CRLF on every seventh line and a trailing newline.  The framed
    lines must be the list, and the result equal parse_batch's on the CPU
    over them (``ref``); the encode seconds beside parse_batch's on the
    same lines (``res``: its numpy loop, forced by the empty edge line) and
    on the same lines without the empty one (native)."""
    from logparser_tpu_torch.tpu.batch import _BlobLines

    raw = [ln.encode() for ln in lines]
    blob = b"".join(r + (b"\r\n" if i % 7 == 3 else b"\n") for i, r in enumerate(raw))
    if list(_BlobLines(blob)) != raw:
        fail("end_to_end_blob: the framed lines differ from the list")
    gpu.parse_blob(blob[:1 << 20])   # warm the pinned-memory cache
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = gpu.parse_blob(blob)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("split", "span_stages", "timestamp", "pack_rows"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the blob path")
    if got.framer != "native":
        fail(f"parse_blob framed with {got.framer}, not the native framer")
    compare_results(got, ref, "end_to_end_blob")
    nonempty = [ln for ln in lines if ln]
    t0 = time.perf_counter()
    native_res = gpu.parse_batch(nonempty)
    native_wall = time.perf_counter() - t0
    if native_res.framer != "native":
        fail(f"parse_batch without empty lines framed with {native_res.framer}")
    emit({"phase": "end_to_end_blob", "B": len(lines), "blob_bytes": len(blob),
          "equal_to_cpu": True, "framer": got.framer, **rescue(got), "wall_seconds": wall,
          "lines_per_s": len(lines) / wall, "stage_seconds": got.stage_seconds,
          "encode_seconds": got.stage_seconds["encode"],
          "parse_batch_framer": res.framer,
          "parse_batch_encode_seconds": res.stage_seconds["encode"],
          "parse_batch_native_framer": native_res.framer,
          "parse_batch_native_encode_seconds": native_res.stage_seconds["encode"],
          "parse_batch_native_wall_seconds": native_wall,
          "launches": launches, "card": smi})


def bound_ms(bytes_moved, ops):
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over the CUDA-core rate."""
    by_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    by_ops = ops / H100_CUDA_CORE_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def split_cost(split, B, L):
    """(bytes, operations) of the split: the [B, L] bytes and lengths in,
    the token cursors and flags out; a compare per plane per byte."""
    n_planes = split.n_planes + int(split.has_esc)
    C = (L + 31) // 32
    return (B * L + 4 * B + 2 * split.n_tok * 4 * B + 4 * B,
            B * C * 32 * (n_planes + 2))


def span_stages_cost(torch, pipeline, stages, starts, ends, B, L):
    """(bytes, operations) of span_stages: the span bytes its tasks read
    (a long's first 19, a view field's first 12, a first line whole), the
    cursors in, the component rows out."""
    toks = sorted({t[1] for t in stages.tasks_py})
    n_read = 0
    for t in stages.tasks_py:
        n = (ends[t[1]] - starts[t[1]]).clamp(0, L).to(torch.int64)
        if t[0] in (pipeline.TASK_LONG, pipeline.TASK_SECMILLIS):
            n_read += int(n.clamp(max=19).sum())
        elif t[2] == pipeline.PART_DIRECT:
            n_read += B + (int(n.clamp(max=12).sum()) if t[11] >= 0 else 0)
    fl_toks = {t[1] for t in stages.tasks_py if t[0] == pipeline.TASK_SPAN and t[2]}
    for tok in fl_toks:
        n_read += int((ends[tok] - starts[tok]).clamp(0, L).to(torch.int64).sum())
    return n_read + 2 * 4 * B * len(toks) + 4 * B * stages.n_out, 4 * n_read


def pack_cost(ex, n_comp_rows, B):
    """(bytes, operations) of pack_rows: the component rows and flags in,
    the packed rows out; a shift, mask and or per slot."""
    return (4 * B * (n_comp_rows + 1 + ex.n_out_rows),
            3 * B * (len(ex.pack.slots_py) + 8 * ex.pack.V))


def timestamp_cost(torch, ts, starts, ends, B, L):
    """(bytes, operations) of timestamp: the span bytes inside the
    layout's windows, the cursors in, 4 rows out (and the zone row of a
    %Z layout)."""
    dl = ts.layout
    window = (dl.seg_widths[0] + 6 if dl.one_shot(L)
              else sum(dl.windows()) + (6 if dl.tail else 0))
    n_read = span_bytes(torch, starts[ts.token_index], ends[ts.token_index], window)
    return n_read + B * (8 + 16 + (4 if ts.zone is not None else 0)), 4 * n_read


def span_bytes(torch, s, e, cap):
    """Bytes a kernel must read of spans [s, e) cut to ``cap``."""
    return int((e - s).clamp(0, cap).to(torch.int64).sum())


def window_bytes(torch, s, L, n):
    """Bytes of the n from each start (its bits above the gather mask
    ignored) that lie inside the line: Row::at reads 0 past L."""
    mask = (1 << max(1, (L - 1).bit_length())) - 1
    return int((L - (s.to(torch.int64) & mask)).clamp(0, n).sum())


def muid_cost(torch, s, e, B, L):
    """(bytes, operations) of muid: the token's first 24 bytes inside the
    line, the cursors in, 6 rows out."""
    n_read = window_bytes(torch, s, L, 24)
    return n_read + B * (8 + 24), 10 * n_read


def ipv4_cost(torch, starts, ends, tokens, B):
    """(bytes, operations) of ipv4_spans, one launch per token: each
    token's span bytes (its first 15), the cursors in, 4 rows out."""
    n_read = sum(span_bytes(torch, starts[t], ends[t], 15) for t in tokens)
    return n_read + len(tokens) * B * (8 + 16), 10 * n_read


def uri_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows,
               smi, fields, generate_combined_lines, uri_edge_lines):
    """Section 6: the URI chain's kernels, end to end, wide bucket."""
    edge = uri_edge_lines()
    lines = generate_combined_lines(N_LINES, seed=53) + edge
    buf, lengths, overflow = runtime.encode_batch(lines)
    B, L = buf.shape
    if L != 384 or overflow:
        fail(f"URI corpus bucket {L} != 384 or overflow {overflow}")
    emit({"phase": "corpus_uri", "B": B, "L": L, "bytes": int(buf.nbytes)})
    gpu = TorchBatchParser("combined", fields)
    ex = gpu.executor
    t = ex.unit_tables[0]
    dbuf = torch.from_numpy(buf).cuda()
    dlen = torch.from_numpy(lengths).cuda()
    starts, ends, flags = phase(
        "split_uri", lambda: kernels.split(t.split, dbuf, dlen),
        lambda: pipeline.compute_split(t.split.program, dbuf, dlen),
        *split_cost(t.split, B, L), kernel="split", n=B)
    block = torch.zeros((t.n_comp, B), dtype=torch.int32, device="cuda")
    a = t.stages.n_out

    stages = t.stages
    fl_toks = {x[1] for x in stages.tasks_py if x[0] == pipeline.TASK_SPAN and x[2]}
    sb = sum(span_bytes(torch, starts[k], ends[k], L) for k in fl_toks)
    sb += sum(B for x in stages.tasks_py if x[2] == pipeline.PART_DIRECT)
    phase("span_stages_uri",
          lambda: kernels.span_stages(stages, dbuf, starts, ends, out=block[:a]),
          lambda: pipeline.span_stages_plain(
              stages, dbuf, starts, ends,
              torch.empty((a, B), dtype=torch.int32, device="cuda")),
          bytes_moved=sb + 8 * B * len(fl_toks) + 4 * B * a, ops=4 * sb,
          kernel="span_stages", n=B)
    kernels.span_stages(stages, dbuf, starts, ends, out=block[:a])
    for g, ts in enumerate(t.ts):
        kernels.timestamp(ts, dbuf, starts, ends, out=block[a + 4 * g:a + 4 * g + 4])

    # uri_split: both groups per timing, each on the block as it stands
    # before the URI stage (its own rows are outputs only).
    base = block.clone()
    u_bytes = u_rows = 0
    for u in t.uri:
        if u.src[0] < 0:
            s, e = starts[u.token_index], ends[u.token_index]
        else:
            s = base[u.src[0]]
            e = s + base[u.src[1]]
        u_bytes += span_bytes(torch, s, e, u.window) + (8 if u.src[0] < 0 else 12) * B
        u_rows += 2 + 6 * len(u.parts_py) + 3 * sum(p[-1] >= 0 for p in u.parts_py)

    def uri_kernel():
        for u in t.uri:
            kernels.uri_split(u, dbuf, starts, ends, block)
        return block

    def uri_plain():
        out = base.clone()
        for u in t.uri:
            pipeline.uri_split_plain(u, dbuf, starts, ends, out)
        return out

    phase("uri_split", uri_kernel, uri_plain, bytes_moved=u_bytes + 4 * B * u_rows,
          ops=10 * u_bytes, n=B)
    uri_kernel()
    torch.cuda.synchronize()

    base = block.clone()
    c_bytes = c_rows = 0
    for c in t.csr:
        s = base[c.src[0]]
        c_bytes += span_bytes(torch, s, s + base[c.src[1]], c.window) + 12 * B
        c_rows += 2 * c.slots + 2

    def csr_kernel():
        for c in t.csr:
            kernels.csr_split(c, dbuf, block)
        return block

    def csr_plain():
        out = base.clone()
        for c in t.csr:
            pipeline.csr_split_plain(c, dbuf, out)
        return out

    phase("csr_split", csr_kernel, csr_plain, bytes_moved=c_bytes + 4 * B * c_rows,
          ops=6 * c_bytes, n=B)
    csr_kernel()
    flags_u = flags[None, :].contiguous()
    phase("pack_rows_uri",
          lambda: kernels.pack_rows(ex.pack, flags_u, block),
          lambda: pipeline.pack_rows_plain(ex.pack, flags_u, block),
          *pack_cost(ex, block.shape[0], B), kernel="pack_rows", n=B)
    # The least time of one device pass at 16 slots (split and timestamp
    # as on the headline path, bounded on this batch).
    path_bound = (bound_ms(*split_cost(t.split, B, L))[0]
                  + bound_ms(*timestamp_cost(torch, t.ts[0], starts, ends, B, L))[0]
                  + sum(phase.bounds[k] for k in
                        ("span_stages_uri", "uri_split", "csr_split", "pack_rows_uri")))

    # End to end: the regrow happens on the card inside parse_batch.
    gpu.parse_batch(lines[:min(4096, N_LINES)])  # warm the allocator, no edge lines
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = gpu.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("split", "span_stages", "timestamp", "uri_split", "csr_split",
                 "pack_rows"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the URI chain's path")
    for name in ("uri_split", "csr_split"):
        rows[name]["launches"] = launches[name]
    cpu = TorchBatchParser("combined", fields, device="cpu")
    ref = cpu.parse_batch(lines)
    compare_results(res, ref, "end_to_end_uri")
    DELIVERY["uri_chain"] = (gpu, cpu, lines, ref)
    hold_timestamp(gpu, lines, "uri")
    twenty = len(lines) - len(edge) + next(
        i for i, x in enumerate(edge) if "k19=v19" in x)
    cap_line = len(lines) - 1
    if res.csr_regrows < 1 or gpu.csr_slots < 32 or not res.valid[twenty]:
        fail(f"no regrow on the card: {gpu.csr_slots} slots, 20-param line "
             f"valid {bool(res.valid[twenty])}")
    if cap_line not in res.needs_host.tolist():
        fail("the line past the 128-slot cap is not in needs_host")
    n_valid = int(res.valid.sum())
    if n_valid < 0.98 * N_LINES:
        fail(f"only {n_valid} of {B} URI lines valid on device")
    emit({"phase": "end_to_end_uri", "B": B, "L": L, "equal_to_cpu": True,
          "valid": n_valid, "needs_host": len(res.needs_host), **rescue(res),
          "path_bound_ms_16_slots": path_bound,
          "csr_slots": gpu.csr_slots, "csr_regrows": res.csr_regrows,
          "stage_seconds": res.stage_seconds, "wall_seconds": wall,
          "lines_per_s": B / wall,
          "device_lines_per_s": B / res.stage_seconds["kernels"],
          "d2h_bytes": res.d2h_bytes, "launches": launches, "card": smi})
    # The same batch again at the grown slots: no regrow, one device pass.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res2 = gpu.parse_batch(lines)
    wall2 = time.perf_counter() - t0
    compare_results(res2, ref, "end_to_end_uri_grown")
    emit({"phase": "end_to_end_uri_grown", "B": B, "L": L, "equal_to_cpu": True,
          "csr_slots": gpu.csr_slots, "csr_regrows": res2.csr_regrows, **rescue(res2),
          "stage_seconds": res2.stage_seconds, "wall_seconds": wall2,
          "lines_per_s": B / wall2,
          "device_lines_per_s": B / res2.stage_seconds["kernels"],
          "d2h_bytes": res2.d2h_bytes, "launches": kernels.launch_counts(),
          "card": smi})
    agg_parity(torch, kernels, gpu, cpu, lines, "agg_parity_uri", smi)
    # The query-key lane: an AggregateSpec instance (validate_for would
    # refuse a count_by over a query key), as the reference reaches it.
    from logparser_tpu_torch.analytics import AggregateSpec

    key_spec = AggregateSpec.parse(
        [{"op": "count_by", "field": "STRING:request.firstline.uri.query.q"}])
    out = agg_parity(torch, kernels, gpu, cpu, lines, "agg_query_key", smi, key_spec)
    if not out.state.data[0]:
        fail("agg_query_key: no query key counted")
    agg_lanes_query_key_phase(torch, kernels, runtime, phase, gpu, lines)

    wide = generate_combined_lines(256, seed=7, garbage_fraction=0.05) + edge + [
        edge[0].replace("/x/y?", "/p?" + "&".join(f"k{i}" for i in range(200)) + "&"),
        edge[0].replace("/x/y?", "/" + "z" * 5000 + "?"),
    ]
    gpu_w = TorchBatchParser("combined", fields)
    res_w = gpu_w.parse_batch(wide)
    ref_w = TorchBatchParser("combined", fields, device="cpu").parse_batch(wide)
    if res_w.buf.shape[1] != 8191:
        fail(f"the wide URI batch took bucket {res_w.buf.shape[1]}, not 8191")
    compare_results(res_w, ref_w, "wide_bucket_uri")
    hold_timestamp(gpu_w, wide, "wide_bucket_uri")
    host = res_w.needs_host.tolist()
    if not {len(wide) - 2, len(wide) - 1} <= set(host):
        fail("the 200-parameter or the 5,000-byte URI line is not in needs_host")
    emit({"phase": "wide_bucket_uri", "B": len(wide), "L": 8191,
          "equal_to_cpu": True, "csr_slots": gpu_w.csr_slots, "needs_host": host, **rescue(res_w)})


def strftime_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase,
                    rows, smi):
    """Section 7: each strftime configuration's kernels against their
    plain versions under its tables (zone_lookup also alone on every
    transition), end to end, and the zone-text 8191-byte bucket."""
    from logparser_tpu_torch.dissectors.tztable import SPAN_MINUTES, default_zone_table
    from logparser_tpu_torch.tools import demolog

    table = default_zone_table()
    if not table.zones:
        fail("the zone vocabulary is empty")
    configs = [
        ("strftime", demolog.COMBINEDIO_STRFTIME_FORMAT,
         demolog.COMBINEDIO_STRFTIME_FIELDS, demolog.combinedio_strftime_lines),
        ("zonetext", demolog.ZONETEXT_FORMAT, demolog.ZONETEXT_FIELDS,
         demolog.zonetext_lines),
    ]
    edge = demolog.strftime_edge_lines()
    for tag, fmt, fields, gen in configs:
        lines = gen(N_LINES) + edge
        buf, lengths, overflow = runtime.encode_batch(lines)
        B, L = buf.shape
        if overflow:
            fail(f"{tag} corpus overflows its bucket: {overflow}")
        emit({"phase": f"corpus_{tag}", "B": B, "L": L, "bytes": int(buf.nbytes)})
        gpu = TorchBatchParser(fmt, fields)
        ex = gpu.executor
        (t,) = ex.unit_tables
        (ts,) = t.ts
        zone = ts.zone is not None
        dbuf = torch.from_numpy(buf).cuda()
        dlen = torch.from_numpy(lengths).cuda()
        starts, ends, flags = phase(
            f"split_{tag}", lambda: kernels.split(t.split, dbuf, dlen),
            lambda: pipeline.compute_split(t.split.program, dbuf, dlen),
            *split_cost(t.split, B, L), kernel="split", n=B, width=L)
        comps = phase(
            f"span_stages_{tag}",
            lambda: kernels.span_stages(t.stages, dbuf, starts, ends),
            lambda: pipeline.span_stages_plain(
                t.stages, dbuf, starts, ends,
                torch.empty((t.stages.n_out, B), dtype=torch.int32, device="cuda")),
            *span_stages_cost(torch, pipeline, t.stages, starts, ends, B, L),
            kernel="span_stages", n=B, width=L)
        zone_out = torch.empty(B, dtype=torch.int32, device="cuda")

        def ts_kernel():
            out = kernels.timestamp(ts, dbuf, starts, ends, zone_out=zone_out)
            return (out, zone_out) if zone else out

        def ts_plain():
            out = torch.empty((4, B), dtype=torch.int32, device="cuda")
            z = torch.empty(B, dtype=torch.int32, device="cuda")
            pipeline.timestamp_plain(ts, dbuf, starts, ends, out, z)
            return (out, z) if zone else out

        got = phase(f"timestamp_{tag}", ts_kernel, ts_plain,
                    *timestamp_cost(torch, ts, starts, ends, B, L),
                    kernel="timestamp", n=B, width=L)
        ts_rows = got[0].clone() if zone else got
        path_phases = [f"split_{tag}", f"span_stages_{tag}", f"timestamp_{tag}",
                       f"pack_rows_{tag}"]
        if zone:
            zones = got[1].clone()

            def gated_kernel():
                return kernels.zone_lookup(ts.zone, zones, ts_rows[2], gate=ts_rows[3])

            def gated_plain():
                return pipeline.zone_lookup_plain(
                    ts.zone, zones, ts_rows[2], ts_rows[3],
                    torch.empty((2, B), dtype=torch.int32, device="cuda"))

            final = phase("zone_lookup_gated", gated_kernel, gated_plain,
                          B * 20 + zone_table_bytes(torch, ts.zone, zones, ts_rows[2]),
                          10 * B, kernel="zone_lookup", n=B, width=L)
            ts_rows = torch.cat([ts_rows[:2], final])
            path_phases.append("zone_lookup_gated")
            zone_lookup_phase(torch, kernels, pipeline, phase, ts.zone, SPAN_MINUTES)
        all_comps = torch.cat([comps, ts_rows]).contiguous()
        flags_u = flags[None, :].contiguous()
        phase(f"pack_rows_{tag}",
              lambda: kernels.pack_rows(ex.pack, flags_u, all_comps),
              lambda: pipeline.pack_rows_plain(ex.pack, flags_u, all_comps),
              *pack_cost(ex, all_comps.shape[0], B), kernel="pack_rows", n=B, width=L)

        # End to end, the counts zeroed just before and read just after.
        gpu.parse_batch(lines[:4096])   # warm the caching allocator
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = gpu.parse_batch(lines)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        for name in ["split", "span_stages", "timestamp", "pack_rows"] + (
                ["zone_lookup"] if zone else []):
            if launches[name] < 1:
                fail(f"kernel {name} was not launched on the {tag} path")
        if zone:
            rows["zone_lookup"]["launches"] = launches["zone_lookup"]
        cpu = TorchBatchParser(fmt, fields, device="cpu")
        ref = cpu.parse_batch(lines)
        compare_results(res, ref, f"end_to_end_{tag}")
        host_generated = [int(i) for i in res.needs_host if i < N_LINES]
        if any("[" in lines[i] for i in host_generated):
            fail(f"{tag}: a generated timestamp line is in needs_host: "
                 f"{lines[host_generated[0]]!r}")
        n_valid = int(res.valid.sum())
        if n_valid < 0.98 * N_LINES:
            fail(f"only {n_valid} of {B} {tag} lines valid on device")
        emit({"phase": f"end_to_end_{tag}", "B": B, "L": L, "equal_to_cpu": True,
              "valid": n_valid, "needs_host": len(res.needs_host), **rescue(res),
              "needs_host_generated": len(host_generated),
              "path_bound_ms": sum(phase.bounds[k] for k in path_phases),
              "stage_seconds": res.stage_seconds, "wall_seconds": wall,
              "lines_per_s": B / wall,
              "device_lines_per_s": B / res.stage_seconds["kernels"],
              "d2h_bytes": res.d2h_bytes, "launches": launches, "card": smi})
        agg_parity(torch, kernels, gpu, cpu, lines, f"agg_parity_{tag}", smi)

    # The zone-text configuration at the widest bucket.
    _, fmt, fields, gen = configs[1]
    run_wide(TorchBatchParser(fmt, fields), TorchBatchParser(fmt, fields, device="cpu"),
             gen(256) + edge, "zonetext")


def zone_table_bytes(torch, zt, zones, minutes):
    """Table bytes a lookup of these pairs must read, each entry once: the
    reference's buckets (2^14 minutes) and packed rows it touches, and the
    window table; one bound for every design of the kernel."""
    table = zt.table
    m = minutes.to(torch.int64).clamp(0, (1 << 26) - 1)
    key = zones.to(torch.int64) * (1 << 26) + m
    bucket = key >> table.BUCKET_BITS
    idx = torch.from_numpy(table.buckets).to(key.device, torch.int64)[bucket]
    rows = torch.cat([idx + k for k in range(table.chain + 1)]).clamp(max=len(table.keys) - 1)
    return (4 * int(torch.unique(bucket).numel()) + 8 * int(torch.unique(rows).numel())
            + 4 * len(table.valid_until))


def zone_probe_pairs(np, table, span):
    """(zones, minutes) int32: every transition key +-1 minute, each
    zone's window edges and the clip edges, plus N_LINES random pairs."""
    keys = table.keys.astype(np.int64)
    z = np.repeat(keys // span, 3)
    m = (keys[:, None] % span + np.array([-1, 0, 1])[None, :]).ravel()
    vu = table.valid_until.astype(np.int64)
    Z = len(vu)
    edges = np.stack([vu - 1, vu, np.full(Z, -1), np.zeros(Z), np.full(Z, span)], 1)
    rng = np.random.default_rng(17)
    z = np.concatenate([z, np.repeat(np.arange(Z), 5), rng.integers(0, Z, N_LINES)])
    m = np.concatenate([m, edges.ravel(), rng.integers(-10, span + 10, N_LINES)])
    return z.astype(np.int32), m.astype(np.int32)


def zone_lookup_phase(torch, kernels, pipeline, phase, zt, span):
    """The standalone lookup on zone_probe_pairs."""
    import numpy as np

    z, m = zone_probe_pairs(np, zt.table, span)
    keys = zt.table.keys.astype(np.int64)
    zones = torch.from_numpy(z).cuda()
    minutes = torch.from_numpy(m).cuda()
    n = len(z)
    # The library yardstick: the sorted-key search alone, on the same
    # (zone, clipped minute) keys.
    sorted_keys = torch.from_numpy(keys).cuda()
    query = zones.to(torch.int64) * span + minutes.to(torch.int64).clamp(0, span - 1)
    phase("zone_lookup",
          lambda: kernels.zone_lookup(zt, zones, minutes),
          lambda: pipeline.zone_lookup_plain(
              zt, zones, minutes, None, torch.empty((2, n), dtype=torch.int32, device="cuda")),
          bytes_moved=16 * n + zone_table_bytes(torch, zt, zones, minutes),
          ops=10 * n, n=n, width=0,
          library=lambda: torch.searchsorted(sorted_keys, query, right=True))


GEO_LARGE_RANGES = 1 << 22   # the order of a production City database's IPv4 networks
GEO_LARGE_STRIDE = 64
GEO_SYNTHETIC_SEED = 4


def large_geo_table(np, GeoDeviceTable):
    """(table, keys uint32): GEO_LARGE_RANGES seeded disjoint ranges over
    the whole uint32 space; the start, end and both neighbours of every
    GEO_LARGE_STRIDE-th range, 0 and 0xFFFFFFFF."""
    mask = 0xFFFFFFFF
    rng = np.random.default_rng(21)
    K = GEO_LARGE_RANGES
    bounds = np.sort(rng.choice(1 << 32, size=2 * K, replace=False)).astype(np.uint32)
    large = GeoDeviceTable.from_ranges(bounds[0::2], bounds[1::2])
    pick = np.arange(0, K, GEO_LARGE_STRIDE)
    s64, e64 = large.starts[pick].astype(np.int64), large.ends[pick].astype(np.int64)
    keys = (np.concatenate([s64, e64, s64 - 1, e64 + 1, [0, mask]]) & mask).astype(np.uint32)
    return large, keys


def geo_search_bytes(np, starts, ends, keys, gate=None):
    """(bytes, hits) of the geo_lookup join on these keys: a host
    simulation of the kernel's upper-bound search counts the distinct
    32-byte sectors of ``starts`` the keys' paths touch, plus the ``ends``
    word of each distinct hit range."""
    s = starts.astype(np.int64)
    k = keys.astype(np.int64) & 0xFFFFFFFF
    K, n = len(s), len(k)
    active = np.ones(n, dtype=bool) if gate is None else gate != 0
    if K == 0:
        return 0, np.zeros(n, dtype=bool)
    lo = np.zeros(n, dtype=np.int64)
    hi = np.full(n, K, dtype=np.int64)
    sectors = []
    while True:
        live = np.nonzero(active & (lo < hi))[0]
        if live.size == 0:
            break
        mid = lo[live] + ((hi[live] - lo[live]) >> 1)
        sectors.append(np.unique(mid >> 3))
        le = s[mid] <= k[live]
        lo[live] = np.where(le, mid + 1, lo[live])
        hi[live] = np.where(le, hi[live], mid)
    hits = active & (lo > 0) & (k <= ends.astype(np.int64)[np.maximum(lo - 1, 0)])
    n_sectors = np.unique(np.concatenate(sectors)).size if sectors else 0
    return 32 * n_sectors + 4 * np.unique(lo[hits]).size, hits


def run_end_to_end(torch, kernels, gpu, cpu, lines, tag, must, path_bound, smi,
                   **extra):
    """parse_batch on the card with the launch counts zeroed just before
    and read just after, held equal to the CPU; one result line."""
    gpu.parse_batch(lines[:4096])   # warm the caching allocator
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = gpu.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in must:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the {tag} path")
    ref = cpu.parse_batch(lines)
    compare_results(res, ref, tag)
    if tag == "end_to_end_geo":
        DELIVERY["geoip_chain"] = (gpu, cpu, lines, ref)
    hold_timestamp(gpu, lines, tag)
    n_valid = int(res.valid.sum())
    if n_valid < 0.98 * N_LINES:
        fail(f"only {n_valid} of {len(lines)} {tag} lines valid on device")
    emit({"phase": tag, "B": len(lines), "L": int(res.buf.shape[1]),
          "equal_to_cpu": True, "valid": n_valid, "needs_host": len(res.needs_host), **rescue(res),
          "path_bound_ms": path_bound, "stage_seconds": res.stage_seconds,
          "wall_seconds": wall, "lines_per_s": len(lines) / wall,
          "device_lines_per_s": len(lines) / res.stage_seconds["kernels"],
          "d2h_bytes": res.d2h_bytes, "launches": launches, **extra, "card": smi})
    return launches


def run_wide(gpu, cpu, lines, tag):
    """A small batch at the widest bucket: a line of exactly 8191 bytes
    and one past the cap (which must go to the host), equal to the CPU."""
    pad = 8191 - len(lines[0].encode())
    lines = lines + [lines[0].replace('"GET ', '"GET /' + "w" * (pad - 1), 1),
                     lines[0].replace('"GET ', '"GET /' + "w" * (pad + 999), 1)]
    res = gpu.parse_batch(lines)
    if res.buf.shape[1] != 8191:
        fail(f"the wide {tag} batch took bucket {res.buf.shape[1]}, not 8191")
    compare_results(res, cpu.parse_batch(lines), f"wide_bucket_{tag}")
    hold_timestamp(gpu, lines, f"wide_bucket_{tag}")
    if len(lines) - 1 not in res.needs_host.tolist():
        fail(f"the over-long {tag} line was not routed to the host")
    if not res.valid[len(lines) - 1]:
        fail(f"the over-long {tag} line came back invalid from the host oracle")
    emit({"phase": f"wide_bucket_{tag}", "B": len(lines), "L": 8191,
          "equal_to_cpu": True, "needs_host": res.needs_host.tolist(), **rescue(res)})


def hold_timestamp(gpu, lines, tag) -> None:
    """Every timestamp launch of the parser's device pass over ``lines``
    made again and held bit for bit to timestamp_plain on the same inputs
    (the zone row too); the path's counted run is over, so these launches
    only compare.  A field set without a timestamp (GeoIP's, NGINX's) has
    none to hold."""
    import torch

    from logparser_tpu_torch.tpu import kernels, pipeline, runtime

    if not any(t.ts for t in gpu.executor.unit_tables):
        return
    buf, lengths, _ = runtime.encode_batch(lines)
    dbuf, dlen = torch.from_numpy(buf).cuda(), torch.from_numpy(lengths).cuda()
    calls = recorded(kernels, "timestamp", lambda: gpu.executor.components(dbuf, dlen))
    if not calls:
        fail(f"no timestamp launch on the {tag} path")
    for args, _ in calls:
        ts, b, starts, ends = args[:4]
        zone = ts.zone is not None
        z = torch.empty(b.shape[0], dtype=torch.int32, device="cuda") if zone else None
        got = [kernels.timestamp(ts, b, starts, ends, zone_out=z)] + ([z] if zone else [])
        want = [torch.empty_like(got[0])] + ([torch.empty_like(z)] if zone else [])
        pipeline.timestamp_plain(ts, b, starts, ends, *want)
        require_equal(torch, f"timestamp_held_{tag}", got, want)
    emit({"phase": f"timestamp_held_{tag}", "equal": True, "launches": len(calls),
          "B": int(dbuf.shape[0]), "L": int(dbuf.shape[1])})


def geo_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows, smi):
    """Section 8: the GeoIP kernels on the geoip_chain batch, geo_lookup
    on a large and an empty table, both GeoIP paths end to end, and the
    8191-byte bucket."""
    import os

    import numpy as np

    from logparser_tpu_torch.geoip import (
        GeoDeviceTable,
        GeoIPASNDissector,
        GeoIPCityDissector,
    )
    from logparser_tpu_torch.tools import demolog, geoip_testdata

    fixtures = geoip_testdata.ensure_test_databases()
    asn = os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb")

    def parser(city, device=None):
        return TorchBatchParser("combined", demolog.GEOIP_FIELDS, device=device,
                                extra_dissectors=[GeoIPCityDissector(city),
                                                  GeoIPASNDissector(asn)])

    city = os.path.join(fixtures, "GeoIP2-City-Test.mmdb")
    edge = demolog.geoip_edge_lines()
    lines = demolog.geoip_chain_lines(N_LINES) + edge
    buf, lengths, overflow = runtime.encode_batch(lines)
    B, L = buf.shape
    if overflow:
        fail(f"geo corpus overflows its bucket: {overflow}")
    emit({"phase": "corpus_geo", "B": B, "L": L, "bytes": int(buf.nbytes)})
    gpu = parser(city)
    ex = gpu.executor
    (t,) = ex.unit_tables
    if len(t.geo) != 2 or len(t.ip) != 1:
        fail(f"geoip_chain has {len(t.geo)} geo groups over {len(t.ip)} IP tokens, "
             "not 2 (City, ASN) over 1")
    dbuf = torch.from_numpy(buf).cuda()
    dlen = torch.from_numpy(lengths).cuda()
    starts, ends, flags = kernels.split(t.split, dbuf, dlen)
    block = torch.zeros((t.n_comp, B), dtype=torch.int32, device="cuda")
    a = t.stages.n_out
    kernels.span_stages(t.stages, dbuf, starts, ends, out=block[:a])

    base = block.clone()

    def ip_kernel():
        for ip in t.ip:
            kernels.ipv4_spans(ip, dbuf, starts, ends, out=block[ip.base:ip.base + 4])
        return block

    def ip_plain():
        out = base.clone()
        for ip in t.ip:
            pipeline.ipv4_spans_plain(ip, dbuf, starts, ends, out[ip.base:ip.base + 4])
        return out

    phase("ipv4_spans", ip_kernel, ip_plain,
          *ipv4_cost(torch, starts, ends, [ip.token_index for ip in t.ip], B), n=B)
    ip_kernel()
    torch.cuda.synchronize()

    base = block.clone()
    V, OK = pipeline.GEO_VALUE, pipeline.GEO_IP_OK

    def geo_kernel():
        for g in t.geo:
            kernels.geo_lookup(g, block[g.ip + V], gate=block[g.ip + OK], out=block[g.row])
        return block

    def geo_plain():
        out = base.clone()
        for g in t.geo:
            pipeline.geo_lookup_plain(g, out[g.ip + V], out[g.ip + OK], out[g.row])
        return out

    mask = 0xFFFFFFFF
    lib_in = [((g.starts.to(torch.int64) & mask), (base[g.ip + V].to(torch.int64) & mask))
              for g in t.geo]
    g_bytes = 12 * B * len(t.geo)
    for g in t.geo:
        host = base[g.ip:g.ip + 2].cpu().numpy()
        g_bytes += geo_search_bytes(np, g.table.starts, g.table.ends,
                                    host[0].view(np.uint32), host[1])[0]
    phase("geo_lookup", geo_kernel, geo_plain, bytes_moved=g_bytes, ops=4 * B * len(t.geo),
          n=B, library=lambda: [torch.searchsorted(s, k, right=True) for s, k in lib_in])
    geo_kernel()
    flags_u = flags[None, :].contiguous()
    phase("pack_rows_geo",
          lambda: kernels.pack_rows(ex.pack, flags_u, block),
          lambda: pipeline.pack_rows_plain(ex.pack, flags_u, block),
          *pack_cost(ex, block.shape[0], B), kernel="pack_rows", n=B)
    path_bound = (bound_ms(*split_cost(t.split, B, L))[0]
                  + bound_ms(*span_stages_cost(torch, pipeline, t.stages, starts, ends,
                                               B, L))[0]
                  + sum(phase.bounds[k] for k in ("ipv4_spans", "geo_lookup",
                                                  "pack_rows_geo")))

    # geo_lookup alone on a table of a production database's size, and
    # on an empty one.
    K = GEO_LARGE_RANGES
    large, keys_np = large_geo_table(np, GeoDeviceTable)
    gl = pipeline.GeoTables(pipeline._GeoGroup("large", 0, large)).cuda()
    keys = torch.from_numpy(keys_np.view(np.int32)).cuda()
    n = len(keys_np)
    table_bytes, hits = geo_search_bytes(np, large.starts, large.ends, keys_np)
    lib_s = gl.starts.to(torch.int64) & mask
    lib_k = keys.to(torch.int64) & mask
    got = phase("geo_lookup_large", lambda: kernels.geo_lookup(gl, keys),
                lambda: pipeline.geo_lookup_plain(gl, keys, None, torch.empty_like(keys)),
                bytes_moved=8 * n + table_bytes, ops=4 * 22 * n, kernel="geo_lookup",
                n=n, width=0, library=lambda: torch.searchsorted(lib_s, lib_k, right=True))
    if int((got > 0).sum()) != int(hits.sum()) or int(hits.sum()) < 2 * K // GEO_LARGE_STRIDE:
        fail(f"geo_lookup_large: {int((got > 0).sum())} hits, the simulation "
             f"{int(hits.sum())}")
    emit({"phase": "geo_lookup_large_table", "ranges": K, "table_bytes": 8 * K,
          "keys": n, "hits": int(hits.sum()), "search_bytes": table_bytes})
    empty = pipeline.GeoTables(pipeline._GeoGroup("empty", 0, GeoDeviceTable.from_ranges(
        np.zeros(0, np.uint32), np.zeros(0, np.uint32)))).cuda()
    got = kernels.geo_lookup(empty, keys)
    want = pipeline.geo_lookup_plain(empty, keys, None, torch.empty_like(keys))
    torch.cuda.synchronize()
    require_equal(torch, "geo_lookup_empty", got, want)
    if int(got.abs().sum()) != 0:
        fail("geo_lookup on an empty table found a row")
    emit({"phase": "geo_lookup_empty", "equal": True, "keys": n, "rows": 0})

    # End to end: the fixture databases, then a synthetic City database.
    ipv4_seeded_phase(torch, kernels, pipeline, phase)
    cpu = parser(city, "cpu")
    launches = run_end_to_end(
        torch, kernels, gpu, cpu, lines, "end_to_end_geo",
        ("split", "span_stages", "ipv4_spans", "geo_lookup", "pack_rows"), path_bound, smi)
    require_geo_launches(launches, t, "end_to_end_geo")
    for name in ("ipv4_spans", "geo_lookup"):
        rows[name]["launches"] = launches[name]
    agg_parity(torch, kernels, gpu, cpu, lines, "agg_parity_geo", smi)
    syn_dir = os.path.join(os.path.dirname(fixtures), ".geoip-synthetic-torch")
    path = os.path.join(syn_dir, f"Synthetic-City-{geoip_testdata.SYNTHETIC_NETWORKS}"
                                 f"-s{GEO_SYNTHETIC_SEED}.mmdb")
    existed = os.path.exists(path)
    t0 = time.perf_counter()
    syn = geoip_testdata.ensure_synthetic_city_database(seed=GEO_SYNTHETIC_SEED)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpu_syn = parser(syn)
    build_s = time.perf_counter() - t0
    nets = geoip_testdata.synthetic_networks(geoip_testdata.SYNTHETIC_NETWORKS,
                                             GEO_SYNTHETIC_SEED)
    syn_lines = demolog.geoip_synthetic_lines(N_LINES, nets) + edge
    ranges = len(gpu_syn.executor.unit_tables[0].geo[0].table)
    cpu_syn = parser(syn, "cpu")
    launches = run_end_to_end(
        torch, kernels, gpu_syn, cpu_syn, syn_lines, "end_to_end_geo_synthetic",
        ("split", "span_stages", "ipv4_spans", "geo_lookup", "pack_rows"),
        None, smi, db_write_seconds=None if existed else write_s,
        table_build_seconds=build_s, ranges=ranges)
    require_geo_launches(launches, gpu_syn.executor.unit_tables[0],
                         "end_to_end_geo_synthetic")
    agg_parity(torch, kernels, gpu_syn, cpu_syn, syn_lines, "agg_parity_geo_synthetic", smi)
    geo_gather_phase(torch, kernels, pipeline, runtime, phase, rows, gpu_syn, syn_lines,
                     smi)
    run_wide(gpu, parser(city, "cpu"), demolog.geoip_chain_lines(256) + edge, "geo")
    host_fields_phase(TorchBatchParser, kernels, smi, city,
                      os.path.join(fixtures, "GeoIP2-Country-Test.mmdb"),
                      demolog.geoip_chain_lines(4096))

    # City and ASN over two IP tokens: one ipv4_spans launch a token.
    two = [TorchBatchParser(demolog.GEOIP_TWO_TOKEN_FORMAT, demolog.GEOIP_TWO_TOKEN_FIELDS,
                            device=device, extra_dissectors=[GeoIPCityDissector(city),
                                                             GeoIPASNDissector(asn)])
           for device in (None, "cpu")]
    (t2,) = two[0].executor.unit_tables
    if len(t2.geo) != 4 or len(t2.ip) != 2:
        fail(f"geoip_two_tokens has {len(t2.geo)} geo groups over {len(t2.ip)} IP tokens, "
             "not 4 over 2")
    two_lines = demolog.geoip_two_token_lines(4096)
    kernels.reset_launch_counts()
    res = two[0].parse_batch(two_lines)
    launches = kernels.launch_counts()
    require_geo_launches(launches, t2, "end_to_end_geo_two_tokens")
    compare_results(res, two[1].parse_batch(two_lines), "end_to_end_geo_two_tokens")
    emit({"phase": "end_to_end_geo_two_tokens", "B": len(two_lines), "equal_to_cpu": True,
          "valid": int(res.valid.sum()), "needs_host": len(res.needs_host), **rescue(res),
          "launches": {k: launches[k] for k in ("ipv4_spans", "geo_lookup")}})


def host_fields_phase(TorchBatchParser, kernels, smi, city, country, lines) -> None:
    """country.name under both a City and a Country dissector has two
    producers, so the host oracle delivers it: the unit's kernels still run
    on the card, and every line the device accepts visits the oracle.
    Fails unless split was launched, every row (country.name included)
    equals the CPU's, and rescue_reasons["host_fields"] is the number of
    rows the device found valid; reports the oracle's lines per second."""
    from logparser_tpu_torch.geoip import GeoIPCityDissector, GeoIPCountryDissector

    fields = ["STRING:connection.client.host.country.name", "IP:connection.client.host"]

    def parser(device=None):
        return TorchBatchParser("combined", fields, device=device,
                                extra_dissectors=[GeoIPCityDissector(city),
                                                  GeoIPCountryDissector(country)])

    gpu = parser()
    if gpu.plan_by_id[fields[0]].kind != "host":
        fail("host_fields: country.name under City and Country is not a host field")
    gpu.parse_batch(lines[:64])   # warm the caching allocator
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = gpu.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if launches["split"] < 1:
        fail("host_fields: split was not launched")
    compare_results(res, parser("cpu").parse_batch(lines), "host_fields")
    device_valid = int((res.format_index >= 0).sum())
    if res.rescue_reasons["host_fields"] != device_valid or device_valid < 0.9 * len(lines):
        fail(f"host_fields: {res.rescue_reasons} for {device_valid} device-valid rows")
    named = sum(v is not None for v in res.to_pylist(fields[0]))
    emit({"phase": "host_fields", "B": len(lines), "equal_to_cpu": True,
          "device_valid": device_valid, "country_names": named, **rescue(res),
          "oracle_lines_per_s": res.oracle_rows / res.rescue_wall_s,
          "wall_seconds": wall, "stage_seconds": res.stage_seconds,
          "launches": launches, "card": smi})


def require_geo_launches(launches, t, tag) -> None:
    """One ipv4_spans launch per IP token of the unit's geo groups and one
    geo_lookup per group, in the path's one pass."""
    want = {"ipv4_spans": len(t.ip), "geo_lookup": len(t.geo)}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"{tag}: launches {got}, expected {want} (one ipv4_spans a token)")


def ipv4_seeded_phase(torch, kernels, pipeline, phase):
    """ipv4_spans on tools.kernel_ab's seeded spans over two tokens (leading
    zeros, octets past 255, uint32 wraps, empty octets, ':' inside and past
    the span, every width 0 to 16, spans past L, starts above the gather
    mask) at L = 384, one launch a token, equal to its plain version."""
    from logparser_tpu_torch.tools import kernel_ab

    buf, s, e = kernel_ab.seeded_ipv4_case(N_LINES + 11, 384, seed=15)
    dbuf, starts, ends = (torch.from_numpy(x).cuda() for x in (buf, s, e))
    B, L = buf.shape
    ips = [pipeline.IpTables(tok, 4 * tok) for tok in (0, 1)]
    block = torch.zeros((8, B), dtype=torch.int32, device="cuda")

    def run(fn):
        def go():
            out = block.clone() if fn is pipeline.ipv4_spans_plain else block
            for ip in ips:
                fn(ip, dbuf, starts, ends, out=out[ip.base:ip.base + 4])
            return out
        return go

    inside = kernel_ab.window_inside(s[0], L, 15)
    phase("ipv4_spans_seeded", run(kernels.ipv4_spans), run(pipeline.ipv4_spans_plain),
          *ipv4_cost(torch, starts, ends, (0, 1), B), kernel="ipv4_spans", n=B, width=L,
          extra={"window_inside": int(inside.sum()), "byte_reads": int((~inside).sum())})


def geo_gather_phase(torch, kernels, pipeline, runtime, phase, rows, gpu_syn, syn_lines,
                     smi):
    """geo_lookup on the synthetic City table (131,072 networks: a
    two-level search with 16 starts a splitter) for the geoip_synthetic
    batch, against its plain version and torch.searchsorted (phase
    ``geo_lookup_synthetic``); then GeoDeviceTable.gather_columns on that
    table for every column, by the rows geo_lookup finds plus crafted
    out-of-range rows: driven once with the counts zeroed just before and
    read just after (exactly one geo_gather launch), each column held to
    its plain version (bit for bit: the float columns hold NaN); then
    gather of the float latitude alone (phase ``geo_gather``) and the
    whole table's call (``geo_gather_table``), each timed beside
    torch.index_select over the same rows with the index rule applied
    beforehand (one call a column for the table, timed as one)."""
    import numpy as np

    from logparser_tpu_torch.geoip.device import geo_gather_plain

    (t,) = gpu_syn.executor.unit_tables
    g = next(g for g in t.geo if "location.latitude" in g.table.columns)
    table = g.table
    buf, lengths, _ = runtime.encode_batch(syn_lines)
    dbuf, dlen = torch.from_numpy(buf).cuda(), torch.from_numpy(lengths).cuda()
    starts, ends, _ = kernels.split(t.split, dbuf, dlen)
    ip = kernels.ipv4_spans(g, dbuf, starts, ends)
    host = ip[:2].cpu().numpy()
    mask = 0xFFFFFFFF
    lib_s, lib_k = g.starts.to(torch.int64) & mask, ip[0].to(torch.int64) & mask
    found = phase(
        "geo_lookup_synthetic", lambda: kernels.geo_lookup(g, ip[0], gate=ip[1]),
        lambda: pipeline.geo_lookup_plain(g, ip[0], ip[1], torch.empty_like(ip[0])),
        bytes_moved=12 * ip.shape[1] + geo_search_bytes(
            np, table.starts, table.ends, host[0].view(np.uint32), host[1])[0],
        ops=4 * ip.shape[1], kernel="geo_lookup", n=ip.shape[1], width=0,
        library=lambda: torch.searchsorted(lib_s, lib_k, right=True),
        extra={"ranges": len(table), "split_shift": g.split_shift,
               "lockstep": g.lockstep})
    n = len(table) + 1   # the miss row and one row per range
    crafted = torch.tensor([-1, -n, -n - 5, n, n + 100, 2**31 - 1, -2**31],
                           dtype=torch.int32, device="cuda")
    rows_t = torch.cat([found, crafted]).contiguous()
    B = rows_t.shape[0]
    cols = table.columns
    kernels.reset_launch_counts()
    got = table.gather_columns(cols, rows_t)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["geo_gather"]
    if launches != 1:
        fail(f"gather_columns launched geo_gather {launches} times for {len(cols)} columns, "
             "not once")

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def same_bits(a, b):
        return all(x.dtype == y.dtype and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

    dcols = [table._device_arrays[(c, rows_t.device)] for c in cols]
    for c, col in zip(cols, dcols):
        if not same_bits([got[c]], [geo_gather_plain(col, rows_t)]):
            fail(f"geo_gather on {c} differs from its plain version")
    if int((found > 0).sum()) < 0.45 * N_LINES:   # half the hosts are inside
        fail(f"geo_gather: only {int((found > 0).sum())} lookups hit")
    col = table._device_arrays[("location.latitude", rows_t.device)]
    idx = gather_index(torch, rows_t, n)
    phase("geo_gather", lambda: table.gather("location.latitude", rows_t),
          lambda: geo_gather_plain(col, rows_t), *gather_cost(torch, [col], rows_t),
          n=B, width=0, library=lambda: torch.index_select(col, 0, idx),
          compare=lambda a, b: 0.0 if same_bits([a], [b]) else fail(
              "geo_gather on location.latitude differs from its plain version"),
          extra={"columns": cols, "rows": n, "launches": launches,
                 "hits": int((found > 0).sum())})
    rows["geo_gather"]["launches"] = launches
    phase("geo_gather_table", lambda: list(table.gather_columns(cols, rows_t).values()),
          lambda: [geo_gather_plain(c, rows_t) for c in dcols],
          *gather_cost(torch, dcols, rows_t), kernel="geo_gather", n=B, width=0,
          library=lambda: [torch.index_select(c, 0, idx) for c in dcols],
          compare=lambda a, b: 0.0 if same_bits(a, b) else fail(
              "geo_gather_table differs from its plain version"),
          extra={"columns": len(cols), "launches": 1,
                 "library_calls": len(cols), "library": "torch.index_select a column "
                 "over the index clamped beforehand, timed as one call"})


def gather_index(torch, rows, n):
    """geo_gather's index rule applied beforehand: [B] int64 in [0, n)."""
    r = rows.to(torch.int64)
    return torch.where(r < 0, r + n, r).clamp(0, n - 1)


def gather_cost(torch, columns, rows):
    """(bytes, operations) of geo_gather over ``columns`` (one table's,
    each [N]): the int32 rows read once, each output written once, and the
    distinct elements of each column read; a clamp per row."""
    B = rows.shape[0]
    distinct = int(torch.unique(gather_index(torch, rows, columns[0].shape[0])).numel())
    elem = sum(c.element_size() for c in columns)
    return 4 * B + elem * (B + distinct), 4 * B


def nginx_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows, smi):
    """Section 9: the secmillis tasks of span_stages under the
    nginx_timing tables, both NGINX paths end to end, and the 8191-byte
    bucket."""
    from logparser_tpu_torch.tools import demolog

    edge = demolog.nginx_edge_lines()
    configs = [
        ("nginx_uri", demolog.NGINX_URI_FORMAT, demolog.NGINX_URI_FIELDS,
         demolog.nginx_uri_lines),
        ("nginx_timing", demolog.NGINX_TIMING_FORMAT, demolog.NGINX_TIMING_FIELDS,
         demolog.nginx_timing_lines),
    ]
    for tag, fmt, fields, gen in configs:
        lines = gen(N_LINES) + edge
        buf, lengths, overflow = runtime.encode_batch(lines)
        B, L = buf.shape
        if overflow:
            fail(f"{tag} corpus overflows its bucket: {overflow}")
        emit({"phase": f"corpus_{tag}", "B": B, "L": L, "bytes": int(buf.nbytes)})
        gpu = TorchBatchParser(fmt, fields)
        (t,) = gpu.executor.unit_tables
        dbuf = torch.from_numpy(buf).cuda()
        dlen = torch.from_numpy(lengths).cuda()
        starts, ends, _ = kernels.split(t.split, dbuf, dlen)
        path_bound = (bound_ms(*split_cost(t.split, B, L))[0]
                      + bound_ms(*pack_cost(gpu.executor, t.n_comp, B))[0])
        if tag == "nginx_timing":
            if not any(x[0] == pipeline.TASK_SECMILLIS for x in t.stages.tasks_py):
                fail("nginx_timing has no secmillis task")
            comps = phase(
                "span_stages_nginx_timing",
                lambda: kernels.span_stages(t.stages, dbuf, starts, ends),
                lambda: pipeline.span_stages_plain(
                    t.stages, dbuf, starts, ends,
                    torch.empty((t.stages.n_out, B), dtype=torch.int32, device="cuda")),
                *span_stages_cost(torch, pipeline, t.stages, starts, ends, B, L),
                kernel="span_stages", n=B, width=L)
            path_bound += phase.bounds["span_stages_nginx_timing"]
        else:
            comps = kernels.span_stages(t.stages, dbuf, starts, ends)
            path_bound += bound_ms(*span_stages_cost(torch, pipeline, t.stages, starts,
                                                     ends, B, L))[0]
        for u in t.uri:   # the first-line URI: its span from span_stages' rows
            s = comps[u.src[0]]
            u_bytes = span_bytes(torch, s, s + comps[u.src[1]], u.window) + 12 * B
            u_rows = 2 + 6 * len(u.parts_py) + 3 * sum(p[-1] >= 0 for p in u.parts_py)
            path_bound += bound_ms(u_bytes + 4 * B * u_rows, 10 * u_bytes)[0]
        must = ("split", "span_stages", "uri_split", "pack_rows")
        cpu = TorchBatchParser(fmt, fields, device="cpu")
        run_end_to_end(torch, kernels, gpu, cpu, lines, f"end_to_end_{tag}", must,
                       path_bound, smi)
        agg_parity(torch, kernels, gpu, cpu, lines, f"agg_parity_{tag}", smi)
    _, fmt, fields, gen = configs[1]
    run_wide(TorchBatchParser(fmt, fields), TorchBatchParser(fmt, fields, device="cpu"),
             gen(256) + edge, "nginx_timing")


def compare_aggregates(got, want, what) -> None:
    """The card's AggregateOutcome against the CPU's: state, needs_host,
    the row accounting and the reject ledger."""
    if got.state != want.state:
        diff = [(a["op"], a.get("field")) for a, b in
                zip(got.state.summary(), want.state.summary()) if a != b]
        fail(f"{what}: the card's aggregate state differs from the CPU's in {diff}")
    if got.needs_host.tolist() != want.needs_host.tolist():
        fail(f"{what}: needs_host differs: {got.needs_host[:10]} vs {want.needs_host[:10]}")
    if got.reject_items != want.reject_items:
        fail(f"{what}: reject_items differ: {got.reject_items[:3]} vs {want.reject_items[:3]}")
    acct = ("good_lines", "bad_lines", "device_rows", "fold_rows", "oracle_rows")
    if [getattr(got, k) for k in acct] != [getattr(want, k) for k in acct]:
        fail(f"{what}: row accounting differs: "
             f"{[getattr(got, k) for k in acct]} vs {[getattr(want, k) for k in acct]}")


def agg_parity(torch, kernels, gpu, cpu, lines, tag, smi, spec=None):
    """One aggregate of ``spec`` (the reference bench's representative_spec
    of the parser when None) on the card, the launch counts zeroed just
    before and read just after, held equal to the same on the CPU."""
    from logparser_tpu_torch.tools.demolog import representative_spec

    spec = spec or representative_spec(gpu)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = gpu.aggregate_batch(lines, spec)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("agg_lanes", "agg_reduce"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the {tag} path")
    compare_aggregates(out, cpu.aggregate_batch(lines, spec), tag)
    emit({"phase": tag, "B": len(lines), "equal_to_cpu": True,
          "ops": [op.as_dict() for op in spec.ops],
          "groups": [len(d) for d in out.state.data if isinstance(d, dict)],
          "device_rows": out.device_rows, "fold_rows": out.fold_rows,
          "needs_host": len(out.needs_host), **rescue(out), "stage_seconds": out.stage_seconds,
          "wall_seconds": wall, "lines_per_s": len(lines) / wall,
          "d2h_bytes": out.d2h_bytes, "row_path_d2h_bytes": out.row_path_d2h_bytes,
          "launches": launches, "card": smi})
    return out


def canonical_groups(groups, n, buf, spans):
    """{raw key bytes or bucket: count} of one agg_group output; a key seen
    twice fails (a split group)."""
    out = {}
    for row in groups[:int(n[0])].cpu().tolist():
        if spans:
            cnt, r, s, ln = row
            key = bytes(buf[r, s:s + ln])
        else:
            key, cnt = row
        if key in out:
            fail(f"agg_group split the key {key!r}")
        out[key] = cnt
    return out


def agg_lanes_query_key_phase(torch, kernels, runtime, phase, gpu, lines):
    """agg_lanes on QUERY_KEY_OPS (the query-key lane beside a span and a
    limbs lane) over the URI chain's batch at the parser's grown slots,
    every other line's request URI replaced by one of kernel_ab's
    LANES_QUERIES (the key ``q`` in either case, repeated, empty,
    %-encoded, past 16 slots), against its plain version; some rows must
    select a key."""
    import re

    import numpy as np

    from logparser_tpu_torch.analytics import AggregateSpec
    from logparser_tpu_torch.analytics import device as agg
    from logparser_tpu_torch.tools.demolog import QUERY_KEY_OPS
    from logparser_tpu_torch.tools.kernel_ab import LANES_QUERIES

    lines = [ln if i % 2 else re.sub(r'"(\w+) \S+ ', lambda m, i=i: '"%s %s ' % (
        m.group(1), LANES_QUERIES[(i // 2) % len(LANES_QUERIES)]), ln, count=1)
        for i, ln in enumerate(lines)]
    buf, lengths, overflow = runtime.encode_batch(lines)
    B, L = buf.shape
    ex = gpu._agg_executor(AggregateSpec.parse(QUERY_KEY_OPS))
    t = ex.tables
    if not any(d[0] == agg.UNIT_QS for d in t.udesc_py):
        fail("agg_lanes_query_key: the spec has no query-key lane")
    kill = np.zeros(B, dtype=np.uint8)
    kill[np.asarray(overflow, dtype=np.int64)] = 1
    dbuf, dlen, kill = (torch.from_numpy(x).cuda() for x in (buf, lengths, kill))
    packed = ex.units(dbuf, dlen)
    cls, lanes = phase(
        "agg_lanes_query_key", lambda: kernels.agg_lanes(t, packed, dbuf, B, kill),
        lambda: agg.agg_lanes_plain(t, packed, dbuf, B, kill,
                                    torch.empty(B, dtype=torch.uint8, device="cuda"),
                                    torch.empty((t.n_lane_rows, B), dtype=torch.int32,
                                                device="cuda")),
        *agg_lanes_cost(t, packed, B, kill), kernel="agg_lanes", n=B,
        extra={"csr_slots": gpu.csr_slots})
    if not bool((lanes[t.lanes_py[0][1]] != -1).any()):
        fail("agg_lanes_query_key: no row selected a query key")


def agg_lanes_cost(t, packed, n_rows, kill):
    """(bytes, operations) of agg_lanes on this launch's data
    (``kernel_ab.lanes_cost``: each unit's row 0 for every row, the winner's
    words and compared key bytes only for the rows that walk their lanes)."""
    from logparser_tpu_torch.tools.kernel_ab import lanes_cost

    return lanes_cost(t, packed.cpu().numpy(), n_rows, kill.cpu().numpy())


def agg_reduce_cost(t, B, ntiles):
    """(bytes, operations) of agg_reduce: the class byte and each limbs
    lane a sum or histogram reads (12 bytes a row) in, the counts and
    tiles out; an add per limb half, three compares per edge."""
    lanes = set(t.sums_py) | {h[0] for h in t.hists_py}
    out = 4 * (1 + t.n_bins) + 24 * ntiles * len(t.sums_py)
    ops = 1 + 9 * len(t.sums_py) + sum(3 * h[2] + 1 for h in t.hists_py)
    return B * (1 + 12 * len(lanes)) + out, B * ops


def agg_reduce_library(torch, t, lanes):
    """The yardstick beside agg_reduce: one reshaped sum over the tiles'
    16-bit halves of every summed limb, which are split outside the timed
    call -- a floor for any PyTorch composition, not the same work (no
    selection, no halves, no n_device, no bins inside it)."""
    from logparser_tpu_torch.analytics import device as agg

    B = lanes.shape[1]
    tile, ntiles = agg.sum_tiling(B)
    halves = torch.stack([
        torch.nn.functional.pad(torch.where(lanes[r] != -1, lanes[r + j], 0)
                                >> (16 * h) & 0xFFFF, (0, ntiles * tile - B))
        for r in t.sums_py for j in range(3) for h in range(2)])
    return lambda: halves.view(-1, ntiles, tile).sum(2)


def agg_group_cost(torch, agg, lane, spans, n_groups):
    """(bytes, operations) of agg_group on this lane: the lane in, the key
    bytes of the selected rows (spans), the groups and their count out;
    a hash step per key byte and a few operations per row."""
    B = lane.shape[0]
    if spans:
        sel = lane != -1
        key_bytes = int(((lane >> 13) & 8191)[sel].to(torch.int64).sum())
    else:
        sel = lane != agg.INT32_MAX
        key_bytes = 0
    n_sel = int(sel.sum())
    return (4 * B + key_bytes + (16 if spans else 8) * n_groups + 4,
            2 * key_bytes + 10 * n_sel)


def agg_phases(torch, TorchBatchParser, kernels, runtime, phase, rows, smi):
    """Section 10: the three aggregate kernels against their plain versions
    on the dashboard batch, then the dashboard aggregate end to end beside
    parse_batch on the same batch."""
    import numpy as np

    from logparser_tpu_torch.analytics import AggregateSpec
    from logparser_tpu_torch.analytics import device as agg
    from logparser_tpu_torch.tools import demolog

    lines = (demolog.generate_combined_lines(N_LINES, seed=42, garbage_fraction=0.01)
             + demolog.aggregate_edge_lines())
    buf, lengths, overflow = runtime.encode_batch(lines)
    B, L = buf.shape
    if overflow:
        fail(f"dashboard corpus overflows its bucket: {overflow}")
    emit({"phase": "corpus_agg", "B": B, "L": L, "bytes": int(buf.nbytes)})
    spec = AggregateSpec.parse(demolog.DASHBOARD_OPS)
    gpu = TorchBatchParser("combined", demolog.HEADLINE_FIELDS)
    ex = gpu._agg_executor(spec)
    t = ex.tables
    dbuf = torch.from_numpy(buf).cuda()
    dlen = torch.from_numpy(lengths).cuda()
    kill = torch.zeros(B, dtype=torch.uint8, device="cuda")
    packed = ex.units(dbuf, dlen)
    torch.cuda.synchronize()

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="cuda")

    cls, lanes = phase(
        "agg_lanes", lambda: kernels.agg_lanes(t, packed, dbuf, B, kill),
        lambda: agg.agg_lanes_plain(t, packed, dbuf, B, kill, empty(B, dtype=torch.uint8),
                                    empty(t.n_lane_rows, B)),
        *agg_lanes_cost(t, packed, B, kill), n=B)

    tile, ntiles = agg.sum_tiling(B)
    phase("agg_reduce", lambda: kernels.agg_reduce(t, cls, lanes),
          lambda: agg.agg_reduce_plain(t, cls, lanes, empty(1 + t.n_bins),
                                       empty(len(t.sums_py), ntiles, 3, 2)),
          *agg_reduce_cost(t, B, ntiles), n=B, library=agg_reduce_library(torch, t, lanes))

    labels = {}
    for p, part in zip(t.op_plans, t.op_partial):
        if p.op.op in ("count_by", "top_k", "time_bucket"):
            labels.setdefault(part, p.op.field.split(":")[1].replace(".", "_"))
    for gi, (row, spans) in enumerate(t.groups_py):
        lane = lanes[row]

        def compare(got, want, spans=spans, label=labels[gi]):
            a = canonical_groups(*got, buf, spans)
            if a != canonical_groups(*want, buf, spans) or int(got[1][0]) != len(a):
                fail(f"agg_group on {label}: {len(a)} groups differ from the "
                     "plain version's")
            return 0.0

        def run_kernel(lane=lane, spans=spans):
            return kernels.agg_group(lane, dbuf, spans)

        def run_plain(lane=lane, spans=spans):
            return agg.agg_group_plain(lane, dbuf, spans, empty(B, 4 if spans else 2),
                                       empty(1))

        n_groups = int(run_plain()[1][0])
        vals = lane[lane != agg.INT32_MAX]
        # The kernels line's agg_group row is the int (time_bucket)
        # grouping, the one a single PyTorch call also computes.
        phase("agg_group" if not spans else f"agg_group_{labels[gi]}", run_kernel,
              run_plain, *agg_group_cost(torch, agg, lane, spans, n_groups),
              kernel=None if not spans else "agg_group", n=B, compare=compare,
              library=None if spans else lambda vals=vals: torch.unique(
                  vals, return_counts=True))

    # End to end: the dashboard aggregate, the counts zeroed just before
    # and read just after; then aggregate and parse_batch in turns.
    gpu.aggregate_batch(lines[:4096], spec)   # warm the caching allocator
    gpu.parse_batch(lines[:4096])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = gpu.aggregate_batch(lines, spec)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("split", "span_stages", "timestamp", "pack_rows", "agg_lanes",
                 "agg_reduce", "agg_group"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the dashboard aggregate path")
    for name in ("agg_lanes", "agg_reduce", "agg_group"):
        rows[name]["launches"] = launches[name]
    walls = {"aggregate": [wall], "parse_batch": []}
    res = None
    for which in ("parse_batch", "aggregate", "aggregate", "parse_batch"):
        t0 = time.perf_counter()
        if which == "aggregate":
            again = gpu.aggregate_batch(lines, spec)
        else:
            res = gpu.parse_batch(lines)
        walls[which].append(time.perf_counter() - t0)
    compare_aggregates(again, out, "agg_dashboard_repeat")
    cpu = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu")
    cpu_out = cpu.aggregate_batch(lines, spec)
    compare_aggregates(out, cpu_out, "end_to_end_agg")
    if out.d2h_bytes * 10 > res.d2h_bytes:
        fail(f"the aggregate copied {out.d2h_bytes} bytes back, parse_batch "
             f"{res.d2h_bytes}: not 10x fewer")
    esc_request = len(lines) - len(demolog.aggregate_edge_lines()) + 2
    if out.fold_rows < 4 or esc_request not in out.needs_host.tolist():
        fail(f"the crafted fold lines did not fold: {out.fold_rows} folded, "
             f"needs_host {out.needs_host.tolist()}")
    agg_s, parse_s = (float(np.median(walls[k])) for k in ("aggregate", "parse_batch"))
    emit({"phase": "end_to_end_agg", "B": B, "L": L, "equal_to_cpu": True,
          "ops": demolog.DASHBOARD_OPS,
          "summary": [{**d, "buckets": len(d["buckets"])} if "buckets" in d else d
                      for d in out.state.summary()],
          "device_rows": out.device_rows, "fold_rows": out.fold_rows,
          "needs_host": out.needs_host.tolist(), **rescue(out),
          "aggregate_wall_seconds": walls["aggregate"],
          "parse_batch_wall_seconds": walls["parse_batch"],
          "aggregate_lines_per_s": B / agg_s, "parse_batch_lines_per_s": B / parse_s,
          "aggregate_over_parse": parse_s / agg_s,
          "aggregate_stage_seconds": out.stage_seconds,
          "parse_batch_stage_seconds": res.stage_seconds,
          "d2h_bytes": out.d2h_bytes, "parse_batch_d2h_bytes": res.d2h_bytes,
          "d2h_ratio": res.d2h_bytes / out.d2h_bytes,
          "device_lines_per_s": B / out.stage_seconds["kernels"],
          "launches": launches, "card": smi})

    # aggregate_blob: the same lines as one blob, against the CPU's state.
    blob = "\n".join(lines).encode()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    blob_out = gpu.aggregate_blob(blob, spec)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("split", "pack_rows", "agg_lanes", "agg_reduce", "agg_group"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the aggregate_blob path")
    compare_aggregates(blob_out, cpu_out, "end_to_end_agg_blob")
    emit({"phase": "end_to_end_agg_blob", "B": B, "blob_bytes": len(blob),
          "equal_to_cpu": True, "wall_seconds": wall, "lines_per_s": B / wall,
          "stage_seconds": blob_out.stage_seconds, "fold_rows": blob_out.fold_rows,
          **rescue(blob_out),
          "d2h_bytes": blob_out.d2h_bytes, "launches": launches, "card": smi})


def cookie_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, rows, smi):
    """Section 11: slice 6.  cookies_uniqueid end to end (the slots regrow
    on the card), then, under its grown tables, setcookie_split, muid and
    csr_split in cookie mode against their plain versions; split on a
    NUL-separated format; the small legs (a probe unit, an upstream-list
    element, BYTESCLF over %B, the 8191-byte bucket)."""
    from logparser_tpu_torch.tools import demolog

    edge = demolog.cookie_edge_lines()
    lines = demolog.cookie_lines(N_LINES) + edge
    buf, lengths, overflow = runtime.encode_batch(lines)
    B, L = buf.shape
    if overflow:
        fail(f"cookie corpus overflows its bucket: {overflow}")
    emit({"phase": "corpus_cookies", "B": B, "L": L, "bytes": int(buf.nbytes)})
    args = (demolog.COOKIE_FORMAT, demolog.COOKIE_FIELDS)
    remap = {"type_remappings": demolog.COOKIE_REMAPPINGS}
    gpu = TorchBatchParser(*args, **remap)
    cpu = TorchBatchParser(*args, device="cpu", **remap)
    must = ("split", "span_stages", "timestamp", "csr_split", "setcookie_split",
            "muid", "pack_rows")
    gpu.parse_batch(lines[:4096])   # warm the allocator (and grow the slots)
    gpu_fresh = TorchBatchParser(*args, **remap)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = gpu_fresh.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in must:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the cookies path")
    ref = cpu.parse_batch(lines)
    compare_results(res, ref, "end_to_end_cookies")
    DELIVERY["cookies_uniqueid"] = (gpu_fresh, cpu, lines, ref)
    hold_timestamp(gpu_fresh, lines, "cookies")
    if gpu_fresh.csr_slots != 128 or res.csr_regrows != 3:
        fail(f"cookies: {gpu_fresh.csr_slots} slots after {res.csr_regrows} regrows")
    if len(lines) - 1 not in res.needs_host.tolist():
        fail("cookies: the line past the 128-slot cap is not in needs_host")
    n_valid = int(res.valid.sum())
    if n_valid < 0.98 * N_LINES:
        fail(f"only {n_valid} of {B} cookie lines valid on device")
    if 1798761600000 not in res.to_pylist("TIME.EPOCH:response.cookies.sid.expires"):
        fail("cookies: no sid expires reads Thu, 01-Jan-2027 00:00:00 GMT")
    emit({"phase": "end_to_end_cookies", "B": B, "L": L, "equal_to_cpu": True,
          "valid": n_valid, "needs_host": len(res.needs_host), **rescue(res),
          "csr_slots": gpu_fresh.csr_slots, "csr_regrows": res.csr_regrows,
          "stage_seconds": res.stage_seconds, "wall_seconds": wall,
          "lines_per_s": B / wall,
          "device_lines_per_s": B / res.stage_seconds["kernels"],
          "d2h_bytes": res.d2h_bytes, "launches": launches, "card": smi})
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res2 = gpu_fresh.parse_batch(lines)
    wall2 = time.perf_counter() - t0
    compare_results(res2, ref, "end_to_end_cookies_grown")
    emit({"phase": "end_to_end_cookies_grown", "B": B, "L": L, "equal_to_cpu": True,
          "csr_slots": gpu_fresh.csr_slots, "csr_regrows": res2.csr_regrows, **rescue(res2),
          "stage_seconds": res2.stage_seconds, "wall_seconds": wall2,
          "lines_per_s": B / wall2,
          "device_lines_per_s": B / res2.stage_seconds["kernels"],
          "d2h_bytes": res2.d2h_bytes, "launches": kernels.launch_counts(),
          "card": smi})

    # The kernels under the grown (128-slot) tables, on the same batch.
    (t,) = gpu_fresh.executor.unit_tables
    dbuf = torch.from_numpy(buf).cuda()
    dlen = torch.from_numpy(lengths).cuda()
    starts, ends, _ = phase(
        "split_cookies", lambda: kernels.split(t.split, dbuf, dlen),
        lambda: pipeline.compute_split(t.split.program, dbuf, dlen),
        *split_cost(t.split, B, L), kernel="split", n=B, width=L)
    block = torch.zeros((t.n_comp, B), dtype=torch.int32, device="cuda")
    cookie = [c for c in t.csr if c.mode == "cookie"]
    setcookie = [c for c in t.csr if c.mode == "setcookie"]
    if not (cookie and setcookie and len(t.muid) == 1):
        fail("cookies: expected a cookie, a Set-Cookie and a muid group")
    state = {"base": block.clone()}   # the block before the phase's kernel

    def group_bytes(groups, cap, extra_rows):
        n = sum(span_bytes(torch, starts[c.token_index], ends[c.token_index], cap(c))
                for c in groups)
        return n, n + sum(8 * B + 4 * B * (2 * c.slots + extra_rows) for c in groups)

    def in_block(run):
        def go():
            for c in run[0]:
                run[1](c, block)
            return block
        return go

    def plain_block(run):
        def go():
            out = state["base"].clone()
            for c in run[0]:
                run[2](c, out)
            return out
        return go

    sc = (setcookie, lambda c, out: kernels.setcookie_split(c, dbuf, starts, ends, out),
          lambda c, out: pipeline.setcookie_split_plain(c, dbuf, starts, ends, out))
    n_read, n_bytes = group_bytes(setcookie, lambda c: L, 3)
    phase("setcookie_split", in_block(sc), plain_block(sc), bytes_moved=n_bytes,
          ops=10 * n_read, n=B, width=L)
    state["base"] = block.clone()
    ck = (cookie, lambda c, out: kernels.csr_split(c, dbuf, out, starts, ends),
          lambda c, out: pipeline.csr_split_plain(c, dbuf, out, starts, ends))
    n_read, n_bytes = group_bytes(cookie, lambda c: c.window, 2)
    phase("csr_split_cookie", in_block(ck), plain_block(ck), bytes_moved=n_bytes,
          ops=6 * n_read, kernel="csr_split", n=B, width=L)
    (m,) = t.muid
    phase("muid",
          lambda: kernels.muid(m, dbuf, starts, ends),
          lambda: pipeline.muid_plain(
              m, dbuf, starts, ends, torch.empty((6, B), dtype=torch.int32, device="cuda")),
          *muid_cost(torch, starts[m.token_index], ends[m.token_index], B, L), n=B, width=L)
    for name in ("setcookie_split", "muid"):
        rows[name]["launches"] = launches[name]
    muid_seeded_phases(torch, kernels, pipeline, phase)

    nul_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, smi)

    # Small legs, correctness only: card = CPU.
    small = [
        ("probe_unit", "%h %u %>s\n%h%l %u %>s",
         ["IP:connection.client.host", "STRING:connection.client.user",
          "STRING:request.status.last"],
         ["1.2.3.4 frank 200", "1.2.3.4- frank 200", "1.2.3.4 - frank 200", "x"]
         + [f"10.0.{i % 256}.{i // 256} u{i} {200 + i % 3}" for i in range(2000)]),
        ("ulist", '$remote_addr "$upstream_addr" $status',
         ["UPSTREAM_ADDR:nginxmodule.upstream.addr.0.value",
          "UPSTREAM_ADDR:nginxmodule.upstream.addr.1.value",
          "UPSTREAM_ADDR:nginxmodule.upstream.addr.0.redirected"],
         ['1.2.3.4 "10.0.0.1:80" 200', '1.2.3.4 "-" 200',
          '1.2.3.4 "10.0.0.1:80, 10.0.0.2:80" 502', '1.2.3.4 "unix:/s" 200']
         + [f'9.9.9.{i % 250} "10.1.{i % 256}.{i // 256}:8080" 200' for i in range(2000)]),
        ("bytesclf", "%h %B",
         ["BYTESCLF:response.body.bytes", "BYTES:response.body.bytes"],
         ["1.2.3.4 0", "1.2.3.4 00", "1.2.3.4 007", "1.2.3.4 123",
          "1.2.3.4 12345678901234567890", "1.2.3.4 -"]
         + [f"1.2.3.{i % 250} {i * 7919 % 100000}" for i in range(2000)]),
    ]
    for tag, fmt, fields, leg in small:
        res_s = TorchBatchParser(fmt, fields).parse_batch(leg)
        compare_results(res_s, TorchBatchParser(fmt, fields, device="cpu").parse_batch(leg),
                        tag)
        emit({"phase": f"leg_{tag}", "B": len(leg), "equal_to_cpu": True,
              "valid": int(res_s.valid.sum()), "needs_host": len(res_s.needs_host), **rescue(res_s)})
    wide = demolog.cookie_lines(256) + edge
    pad = 8191 - len(wide[0].encode())
    wide += [wide[0].replace('"GET ', '"GET /' + "w" * (pad - 1), 1),
             wide[0].replace('"GET ', '"GET /' + "w" * (pad + 999), 1)]
    gpu_w = TorchBatchParser(*args, **remap)
    res_w = gpu_w.parse_batch(wide)
    if res_w.buf.shape[1] != 8191:
        fail(f"the wide cookie batch took bucket {res_w.buf.shape[1]}, not 8191")
    compare_results(res_w, TorchBatchParser(*args, device="cpu", **remap).parse_batch(wide),
                    "wide_bucket_cookies")
    hold_timestamp(gpu_w, wide, "wide_bucket_cookies")
    if len(wide) - 1 not in res_w.needs_host.tolist():
        fail("the over-long cookie line was not routed to the host")
    emit({"phase": "wide_bucket_cookies", "B": len(wide), "L": 8191,
          "equal_to_cpu": True, "needs_host": res_w.needs_host.tolist(), **rescue(res_w)})


def muid_seeded_phases(torch, kernels, pipeline, phase):
    """muid on tools.kernel_ab's seeded tokens (a byte outside the
    alphabet at each of the 24 positions, widths 0, 23, 24 and 25, tokens
    running past L, starts past L and above the gather mask, rows of
    random bytes) at L = 2,048 (``muid_seeded``) and 64
    (``muid_seeded_64``), each equal to its plain version."""
    from logparser_tpu_torch.tools import kernel_ab

    m = pipeline.MuidTables(pipeline._MuidGroup("seeded", 0, 0))
    for L, name in ((2048, "muid_seeded"), (64, "muid_seeded_64")):
        buf, s, e = kernel_ab.seeded_muid_case(N_LINES + 11, L, seed=L)
        dbuf = torch.from_numpy(buf).cuda()
        starts, ends = torch.from_numpy(s)[None].cuda(), torch.from_numpy(e)[None].cuda()
        B = buf.shape[0]
        inside = kernel_ab.window_inside(s, L, kernel_ab.MUID_TOKEN)
        phase(name, lambda: kernels.muid(m, dbuf, starts, ends),
              lambda: pipeline.muid_plain(m, dbuf, starts, ends,
                                          torch.empty((6, B), dtype=torch.int32,
                                                      device="cuda")),
              *muid_cost(torch, starts[0], ends[0], B, L), kernel="muid", n=B, width=L,
              extra={"window_inside": int(inside.sum()), "byte_reads": int((~inside).sum())})


NUL_FORMAT = "%h\x00%u\x00%>s"
NUL_FIELDS = ["IP:connection.client.host", "STRING:connection.client.user",
              "STRING:request.status.last"]


def nul_lines(np):
    """The NUL-separated batch: generated headline lines (seed 62) cut to
    host, user and status joined by NULs; 5% end in 1-3 NULs, 5% have a
    space for the first NUL, garbage lines stay as they are."""
    from logparser_tpu_torch.tools.demolog import generate_combined_lines

    rng = np.random.default_rng(61)
    lines = []
    for ln in generate_combined_lines(N_LINES, seed=62, garbage_fraction=0.01):
        parts = ln.split(" ")
        if len(parts) < 9:
            lines.append(ln.encode())
            continue
        line = f"{parts[0]}\x00{parts[2]}\x00{parts[8]}".encode()
        r = rng.random()
        if r < 0.05:
            line += b"\x00" * int(rng.integers(1, 4))
        elif r < 0.1:
            line = line.replace(b"\x00", b" ", 1)
        lines.append(line)
    return lines


def nul_phases(torch, TorchBatchParser, kernels, pipeline, runtime, phase, smi):
    """split on a format whose separators are NUL bytes, with lines that
    end in NULs and are padded with zeros, against its plain version
    (which the CPU tests hold to the reference's compute_split_dense),
    then that format end to end."""
    import numpy as np

    lines = nul_lines(np)
    buf, lengths, _ = runtime.encode_batch(lines)
    B, L = buf.shape
    fields = NUL_FIELDS
    gpu = TorchBatchParser(NUL_FORMAT, fields)
    (t,) = gpu.executor.unit_tables
    if 0 not in {b for lit in t.split.program.ops for b in lit.lit}:
        fail("split_nul: the program has no NUL separator")
    dbuf = torch.from_numpy(buf).cuda()
    dlen = torch.from_numpy(lengths).cuda()
    phase("split_nul",
          lambda: kernels.split(t.split, dbuf, dlen),
          lambda: pipeline.compute_split(t.split.program, dbuf, dlen),
          *split_cost(t.split, B, L), kernel="split", n=B, width=L)
    kernels.reset_launch_counts()
    res = gpu.parse_batch(lines)
    launches = kernels.launch_counts()
    compare_results(res, TorchBatchParser(NUL_FORMAT, fields,
                                          device="cpu").parse_batch(lines), "end_to_end_nul")
    if launches["split"] < 1 or int(res.valid.sum()) < 0.8 * B:
        fail(f"split_nul: {launches['split']} split launches, {int(res.valid.sum())} valid")
    emit({"phase": "end_to_end_nul", "B": B, "L": L, "equal_to_cpu": True,
          "valid": int(res.valid.sum()), "needs_host": len(res.needs_host), **rescue(res),
          "launches": launches, "card": smi})


STREAM_BATCHES = (("headline", 142), ("headline", 143), ("uri", 153), ("uri", 154),
                  ("headline", 144), ("headline", 145))


def stream_phases(torch, TorchBatchParser, kernels, smi):
    """parse_batch_stream (depth 1, staged H2D) over six batches of 65,536
    lines -- headline, then the URI chain (a fresh parser regrows 16 -> 128
    slots mid-stream: one URI edge line passes the cap), then headline
    again -- each result equal to that batch's parse_batch on the card on
    another fresh parser; the stream wall beside the sum of the serial
    walls, taken before the stream and again after it.  Then aggregate_batch_stream(depth=2) over three dashboard
    batches, each state equal to aggregate_batch's."""
    from logparser_tpu_torch.tools import demolog

    def batch(kind, seed):
        lines = demolog.generate_combined_lines(N_LINES, seed=seed, garbage_fraction=0.01)
        return lines + (demolog.uri_edge_lines() if kind == "uri" else [])

    batches = [batch(kind, seed) for kind, seed in STREAM_BATCHES]
    fields = demolog.URI_CHAIN_FIELDS
    serial = TorchBatchParser("combined", fields)
    serial.parse_batch(batches[0][:4096])   # warm the allocators
    walls, want = [], []
    for b in batches:
        t0 = time.perf_counter()
        want.append(serial.parse_batch(b))
        walls.append(time.perf_counter() - t0)
    stream = TorchBatchParser("combined", fields)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = list(stream.parse_batch_stream(batches, depth=1))
    stream_wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("split", "span_stages", "timestamp", "uri_split", "csr_split", "pack_rows"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the stream path")
    if [r.csr_regrows for r in got] != [r.csr_regrows for r in want] or stream.csr_slots != 128:
        fail(f"stream regrows {[r.csr_regrows for r in got]}, serial "
             f"{[r.csr_regrows for r in want]}, slots {stream.csr_slots}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.framer != "native":
            fail(f"stream batch {i} framed with {g.framer}, not the native framer")
        compare_results(g, w, f"stream batch {i}", arrow=False)
    # The serial walls once more, after the stream (a fresh parser again,
    # results dropped): how much of the difference is the order of runs.
    again = TorchBatchParser("combined", fields)
    walls_after = []
    for b in batches:
        t0 = time.perf_counter()
        again.parse_batch(b)
        walls_after.append(time.perf_counter() - t0)
    emit({"phase": "stream", "batches": [f"{k} {len(b)}" for (k, _), b in
                                         zip(STREAM_BATCHES, batches)],
          "depth": 1, "stage_h2d": True, "equal_to_parse_batch": True,
          "stream_wall_seconds": stream_wall, "serial_wall_seconds": walls,
          "serial_wall_sum": sum(walls), "serial_after_wall_seconds": walls_after,
          "serial_after_wall_sum": sum(walls_after),
          "lines_per_s": sum(map(len, batches)) / stream_wall,
          "serial_lines_per_s": sum(map(len, batches)) / sum(walls),
          "csr_regrows": [r.csr_regrows for r in got],
          "oracle_rows": [r.oracle_rows for r in got],
          "rescue_reasons": [r.rescue_reasons for r in got],
          "rescue_wall_s": [r.rescue_wall_s for r in got],
          "stage_seconds": [r.stage_seconds for r in got],
          "serial_stage_seconds": [r.stage_seconds for r in want],
          "launches": launches, "card": smi})

    spec = demolog.DASHBOARD_OPS
    agg = [demolog.generate_combined_lines(N_LINES, seed=s, garbage_fraction=0.01)
           + demolog.aggregate_edge_lines() for s in (146, 147, 148)]
    gpu = TorchBatchParser("combined", demolog.HEADLINE_FIELDS)
    walls = []
    want = []
    for b in agg:
        t0 = time.perf_counter()
        want.append(gpu.aggregate_batch(b, spec))
        walls.append(time.perf_counter() - t0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = list(gpu.aggregate_batch_stream(agg, spec, depth=2))
    stream_wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("agg_lanes", "agg_reduce", "agg_group"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the aggregate stream path")
    for i, (g, w) in enumerate(zip(got, want)):
        compare_aggregates(g, w, f"aggregate stream batch {i}")
    walls_after = []
    for b in agg:
        t0 = time.perf_counter()
        gpu.aggregate_batch(b, spec)
        walls_after.append(time.perf_counter() - t0)
    emit({"phase": "aggregate_stream", "batches": len(agg), "depth": 2,
          "equal_to_aggregate_batch": True, "stream_wall_seconds": stream_wall,
          "oracle_rows": [o.oracle_rows for o in got],
          "rescue_reasons": [o.rescue_reasons for o in got],
          "rescue_wall_s": [o.rescue_wall_s for o in got],
          "serial_wall_seconds": walls, "serial_wall_sum": sum(walls),
          "serial_after_wall_seconds": walls_after,
          "serial_after_wall_sum": sum(walls_after),
          "stage_seconds": [o.stage_seconds for o in got],
          "launches": launches, "card": smi})


def arrow_delivery_phases(kernels, smi) -> None:
    """Section 12b: the delivery tier on the four paths' batches (65,536
    lines each, kept by their end-to-end phases).  Per path: a fresh
    parse on the card (launch counts zeroed just before, read just
    after), then to_arrow() -- every span column with device view rows
    interleaved from the card's block by native.views_interleave, their
    count printed and equal to the parser's view fields --,
    to_arrow(strings="copy"), span_bytes_many over the span columns, the
    to_pylist walk (to_dict) and parse_to_ipc, each timed; both tables
    equal to the CPU result's, the IPC table equal to the CPU parser's
    parse_to_ipc (headline, geoip_chain) or to the CPU result's copy-mode
    table (URI chain, cookies: a CPU parse of a minute or more each).
    span_bytes_many is timed on the generated lines (``slice(0,
    N_LINES)``): a column with a rescued row's override takes the
    per-row path.  The previous path's view table, held across this
    path's parse and delivery, must still equal its copy-mode twin (a
    pinned buffer or a pooled view array reused under live views would
    show there); after the last path one more headline parse checks the
    last table.  The native library must be built: the host tier may
    not take its numpy paths on the card's machine."""
    import pyarrow as pa

    from logparser_tpu_torch import native
    from logparser_tpu_torch.tpu.arrow_bridge import parse_to_ipc, table_from_ipc_bytes

    if not native.native_available():
        fail("arrow_delivery: the native library did not build (numpy delivery)")

    def held_intact(held, after):
        path, view, copy = held
        for name in copy.column_names:
            col = view.column(name)
            if pa.types.is_string_view(col.type):
                col = col.cast(pa.string())
            if not col.equals(copy.column(name)):
                fail(f"arrow_delivery: {path}'s view table changed under the {after} "
                     f"batch in {name}")

    held = None
    real = native.views_interleave
    for path in DELIVERY_PATHS:
        gpu, cpu, lines, ref = DELIVERY[path]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = gpu.parse_batch(lines)
        parse_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        if launches["pack_rows"] < 1:
            fail(f"arrow_delivery: pack_rows was not launched on {path}")
        interleaved = []

        def counting(packed, field_rows, *args, **kw):
            interleaved.append(len(field_rows))
            return real(packed, field_rows, *args, **kw)

        native.views_interleave = counting
        try:
            t0 = time.perf_counter()
            view = res.to_arrow()
            view_s = time.perf_counter() - t0
        finally:
            native.views_interleave = real
        t0 = time.perf_counter()
        copy = res.to_arrow(strings="copy")
        copy_s = time.perf_counter() - t0
        span_ids = [f for f in res.field_ids()
                    if res.column(f)["kind"] == "span" and not f.endswith(".*")]
        # A column with an override (a rescued row) takes the per-row path,
        # as in the reference: the flat gather is timed on the generated
        # lines, whose rows the device finishes.
        window = res.slice(0, N_LINES)
        t0 = time.perf_counter()
        flats = window.span_bytes_many(span_ids, include_fix=True)
        many_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res.to_dict()
        walk_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ipc = parse_to_ipc(gpu, lines)
        ipc_s = time.perf_counter() - t0
        n_views = len(gpu.view_specs)
        if (sorted(res.device_views) != sorted(f for f, _ in gpu.view_specs)
                or interleaved != [n_views] or not n_views):
            fail(f"arrow_delivery: {path}: {interleaved} columns interleaved from the "
                 f"device block, {n_views} view fields")
        if not all(pa.types.is_string_view(view.schema.field(f).type)
                   for f in res.device_views):
            fail(f"arrow_delivery: {path}: a view field is not a string_view column")
        if held is not None:
            held_intact(held, path)
        if not copy.equals(ref.to_arrow(strings="copy")):
            fail(f"arrow_delivery: {path}: to_arrow(strings='copy') differs from the CPU's")
        if not view.equals(ref.to_arrow()):
            fail(f"arrow_delivery: {path}: to_arrow() differs from the CPU's")
        # The CPU's own parse_to_ipc where its parse is short; on the two
        # paths whose CPU parse takes a minute or more, the CPU result's
        # copy-mode table (parse_to_ipc's table is that table, and the CPU
        # tests hold the two equal).
        t0 = time.perf_counter()
        cpu_ipc = (table_from_ipc_bytes(parse_to_ipc(cpu, lines)) if path in CPU_IPC_PATHS
                   else ref.to_arrow(strings="copy"))
        cpu_ipc_s = time.perf_counter() - t0
        if not table_from_ipc_bytes(ipc).equals(cpu_ipc):
            fail(f"arrow_delivery: {path}: parse_to_ipc's table differs from the CPU's")
        held = (path, view, copy)
        emit({"phase": f"arrow_delivery_{path}", "B": len(lines), "equal_to_cpu": True,
              "view_columns_interleaved": sum(interleaved), "view_fields": n_views,
              "span_columns_gathered": len(flats), "span_columns": len(span_ids),
              "ipc_bytes": len(ipc), "cpu_ipc": ("parse_to_ipc" if path in CPU_IPC_PATHS
                                                 else "to_arrow_copy"),
              "parse_seconds": parse_s, "materialize_seconds": res.stage_seconds["materialize"],
              "to_arrow_view_seconds": view_s, "to_arrow_copy_seconds": copy_s,
              "span_bytes_many_seconds": many_s, "to_pylist_walk_seconds": walk_s,
              "parse_to_ipc_seconds": ipc_s, "cpu_parse_to_ipc_seconds": cpu_ipc_s,
              "stage_seconds": res.stage_seconds, "launches": launches, "card": smi})
    gpu, _, lines, _ = DELIVERY["headline"]
    gpu.parse_batch(lines).to_arrow()
    held_intact(held, "next headline")
    emit({"phase": "arrow_delivery", "paths": list(DELIVERY_PATHS), "equal_to_cpu": True,
          "held_view_tables_intact": True, "native_available": True, "card": smi})


class swapped:
    """``with swapped(module, name, fn):`` module.name is fn inside."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def recorded(kernels, name, run):
    """[(args, kwargs)] of every call ``run()`` makes to kernels.<name>
    (each passed through to the wrapper)."""
    calls = []
    wrapper = getattr(kernels, name)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return wrapper(*args, **kwargs)

    # The wrapper counts through its module-level name, which is this
    # function while swapped: those launches land here, uncounted.
    record.launches = 0

    with swapped(kernels, name, record):
        run()
    return calls


def flat(outs):
    """A list of sp_program results as one list of tensors."""
    return [t for o in outs for t in (o["starts"], o["ends"], o["valid"])]


def sp_paths(torch, kernels, mesh, run, per_op, dbuf, dlen, n_data, tag):
    """Both SP paths of one card's mesh on (dbuf, dlen): the runner (counts
    zeroed just before, read just after: sp_program once per data shard,
    sp_split never), the per-op runner (sp_split, no sp_program), the
    runner over sp_program's plain version -- all equal.  Returns (the
    runner's result, its counts, the per-op runner's counts)."""
    run(dbuf, dlen)   # warm
    per_op(dbuf, dlen)
    kernels.reset_launch_counts()
    got = run(dbuf, dlen)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches["sp_program"] != n_data or launches["sp_split"]:
        fail(f"{tag}: the runner launched sp_program {launches['sp_program']} times over "
             f"{n_data} data shards, sp_split {launches['sp_split']} times")
    kernels.reset_launch_counts()
    op = per_op(dbuf, dlen)
    torch.cuda.synchronize()
    op_launches = kernels.launch_counts()
    if op_launches["sp_split"] < 1 or op_launches["sp_program"]:
        fail(f"{tag}: the per-op path launched sp_split {op_launches['sp_split']} times, "
             f"sp_program {op_launches['sp_program']} times")
    with swapped(kernels, "sp_program", mesh.sp_program_plain):
        want = run(dbuf, dlen)
    for key in ("valid", "starts", "ends"):
        if not torch.equal(got[key], want[key]):
            fail(f"{tag}: the runner's {key} differs from the runner over the plain version")
        if not torch.equal(got[key], op[key]):
            fail(f"{tag}: the runner's {key} differs from the per-op path's")
    return got, launches, op_launches


def sp_cost(program, B, L):
    """(bytes, operations) of the SP split as a function, whatever its
    launches re-read between them: the [B, L] buffer and the lengths in
    once, the token cursors [T, B] int32 and valid [B] out once (split's
    own count); a compare per byte."""
    return B * L + 4 * B + 2 * len(program.tokens) * 4 * B + B, B * L


def time_wall(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, host clock around a
    synchronize (the runners enqueue many launches and combines)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_phases(torch, TorchBatchParser, kernels, runtime, phase, rows, smi, gpu,
                lines, buf, lengths):
    """The device mesh on one card: ``parallel.mesh.local_devices``
    replaced with [cuda:0] * 4 for every phase, restored after."""
    import numpy as np

    from logparser_tpu_torch.parallel import mesh

    saved = mesh.local_devices
    cuda0 = torch.device("cuda", 0)
    mesh.local_devices = lambda: [cuda0] * 4
    try:
        # The headline batch padded to a multiple of 4 (and 2) rows with
        # empty lines: the runners take even shards only.
        pad = mesh.padded_rows(mesh.make_mesh(4), len(lines)) - len(lines)
        pbuf = np.concatenate([buf, np.zeros((pad, buf.shape[1]), dtype=np.uint8)])
        plen = np.concatenate([lengths, np.zeros(pad, dtype=np.int32)])
        dbuf, dlen = torch.from_numpy(pbuf).cuda(), torch.from_numpy(plen).cuda()
        mesh_dp_phase(torch, kernels, runtime, mesh, gpu, dbuf, dlen, smi,
                      mesh.make_mesh(4), "mesh_dp")
        mesh_dp_uri_phase(torch, TorchBatchParser, kernels, smi)
        parser_dp_phase(torch, TorchBatchParser, kernels, gpu, lines, smi)
        sp = sp_split_phase(torch, kernels, runtime, mesh, phase, rows, gpu, lines,
                            dbuf, dlen, smi)
        sp_long_phase(torch, kernels, runtime, mesh, gpu, smi, phase.clock)
        counters_phase(torch, kernels, mesh, phase, rows, gpu, lines, smi)
    finally:
        mesh.local_devices = saved
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        emit({"phase": "mesh_multi_card", "skipped": "1 card"})
        return
    devs = [torch.device("cuda", i) for i in range(n_cards)]
    width = mesh.dp_device_count()   # the real local_devices again
    emit({"phase": "mesh_multi_card", "cards": n_cards, "data_width": width,
          "names": [torch.cuda.get_device_name(i) for i in range(n_cards)]})
    mesh_dp_phase(torch, kernels, runtime, mesh, gpu, dbuf, dlen, smi,
                  mesh.make_mesh(width, devices=devs), "mesh_multi_card_dp")
    parser_dp_phase(torch, TorchBatchParser, kernels, gpu, lines, smi, width,
                    "mesh_multi_card_parser")
    n_seq = 4 if width >= 4 else 2
    prog = gpu.units[0].program
    run = mesh.sequence_parallel_runner(prog, mesh.make_mesh(1, n_seq, devices=devs),
                                        dbuf.shape[1])
    kernels.reset_launch_counts()
    got = run(dbuf, dlen)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches["sp_split"] < 1 or launches["sp_program"]:
        fail(f"mesh_multi_card: SP on {n_seq} cards launched sp_split {launches['sp_split']} "
             f"times, sp_program {launches['sp_program']} times: not the per-op path")
    for key in ("valid", "starts", "ends"):
        if not torch.equal(got[key], sp[key]):
            fail(f"mesh_multi_card: SP on {n_seq} cards differs from one card in {key}")
    emit({"phase": "mesh_multi_card_sp", "cards": n_seq, "equal_to_one_card": True,
          "launches": launches,
          "runner_ms": time_wall(torch, lambda: run(dbuf, dlen), 5), "card": smi})


def mesh_dp_phase(torch, kernels, runtime, mesh, gpu, dbuf, dlen, smi, m, tag):
    """data_parallel_runner and batch_parallel_runner (with the view rows)
    on mesh ``m`` against run_program and the unsharded executor, bit for
    bit, each timed beside its unsharded run."""
    prog = gpu.units[0].program
    B = dbuf.shape[0]
    dp = mesh.data_parallel_runner(prog, m)
    bp = mesh.batch_parallel_runner(gpu.units, m, gpu.view_specs)
    kernels.reset_launch_counts()
    got_dp = dp(dbuf, dlen)
    got_bp = bp(dbuf, dlen)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for name in ("split", "span_stages", "timestamp", "pack_rows"):
        if launches[name] < m.shape[0]:
            fail(f"{tag}: kernel {name} launched {launches[name]} times over "
                 f"{m.shape[0]} shards")
    want_dp = runtime.run_program(prog, dbuf, dlen)
    for key in ("starts", "ends", "valid"):
        if not torch.equal(got_dp[key], want_dp[key]):
            fail(f"{tag}: data_parallel_runner {key} differs from run_program")
    want_bp = gpu.executor(dbuf, dlen)
    if not torch.equal(got_bp, want_bp):
        bad = (got_bp != want_bp).nonzero()
        fail(f"{tag}: batch_parallel_runner differs from the executor at "
             f"{bad.shape[0]} places, first {bad[:3].tolist()}")
    emit({"phase": tag, "B": B, "L": int(dbuf.shape[1]), "mesh": list(m.shape),
          "devices": [str(d) for d in m.data_devices], "equal": True,
          "dp_ms": time_kernel(torch, lambda: dp(dbuf, dlen), 10),
          "run_program_ms": time_kernel(torch, lambda: runtime.run_program(prog, dbuf, dlen), 10),
          "dp_wall_ms": time_wall(torch, lambda: dp(dbuf, dlen), 10),
          "run_program_wall_ms": time_wall(
              torch, lambda: runtime.run_program(prog, dbuf, dlen), 10),
          "bp_ms": time_kernel(torch, lambda: bp(dbuf, dlen), 10),
          "executor_ms": time_kernel(torch, lambda: gpu.executor(dbuf, dlen), 10),
          "bp_wall_ms": time_wall(torch, lambda: bp(dbuf, dlen), 10),
          "executor_wall_ms": time_wall(torch, lambda: gpu.executor(dbuf, dlen), 10),
          "launches": launches, "card": smi})


def mesh_dp_uri_phase(torch, TorchBatchParser, kernels, smi):
    """The URI chain under data_parallel=4: the uri edge lines (20
    parameters, and more than the 128-slot cap) lie in the last shard, so
    one shard's overflow bit regrows the whole batch 16 -> 128; equal to
    the unsharded card parser, regrows included."""
    from logparser_tpu_torch.tools.demolog import (
        URI_CHAIN_FIELDS,
        generate_combined_lines,
        uri_edge_lines,
    )

    lines = generate_combined_lines(N_LINES, seed=53) + uri_edge_lines()
    solo = TorchBatchParser("combined", URI_CHAIN_FIELDS)
    dp = TorchBatchParser("combined", URI_CHAIN_FIELDS, data_parallel=4)
    if dp.mesh_devices != 4:
        fail(f"mesh_dp_uri: data_parallel=4 resolved to {dp.mesh_devices} devices")
    shard = -(-len(lines) // 4)
    edge_rows = range(N_LINES, len(lines))
    if {r // shard for r in edge_rows} != {3}:
        fail("mesh_dp_uri: the URI edge lines are not all in the last shard")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = dp.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    want = solo.parse_batch(lines)
    solo_wall = time.perf_counter() - t0
    if (got.csr_regrows, dp.csr_slots) != (want.csr_regrows, solo.csr_slots) \
            or dp.csr_slots != 128:
        fail(f"mesh_dp_uri: regrows {got.csr_regrows} to {dp.csr_slots} slots, "
             f"unsharded {want.csr_regrows} to {solo.csr_slots}")
    compare_results(got, want, "mesh_dp_uri")
    emit({"phase": "mesh_dp_uri", "B": len(lines), "mesh_devices": dp.mesh_devices,
          "equal_to_unsharded": True, "csr_regrows": got.csr_regrows, **rescue(got),
          "csr_slots": dp.csr_slots, "wall_seconds": wall, "unsharded_wall_seconds": solo_wall,
          "stage_seconds": got.stage_seconds, "unsharded_stage_seconds": want.stage_seconds,
          "launches": launches, "card": smi})


def parser_dp_phase(torch, TorchBatchParser, kernels, gpu, lines, smi, width=4,
                    tag="parser_dp"):
    """TorchBatchParser("combined", HEADLINE_FIELDS, data_parallel=width)
    against the unsharded card parser ``gpu``: parse_batch, parse_blob, a
    3-batch parse_batch_stream and the dashboard aggregate_batch (state,
    IPC bytes, row accounting)."""
    from logparser_tpu_torch.tools import demolog

    dp = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, data_parallel=width)
    if dp.mesh_devices != width:
        fail(f"{tag}: data_parallel={width} resolved to {dp.mesh_devices} devices")
    dp.parse_batch(lines[:4096])   # warm the allocators
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = dp.parse_batch(lines)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    want = gpu.parse_batch(lines)
    solo_wall = time.perf_counter() - t0
    compare_results(got, want, f"{tag} parse_batch")
    blob = "\n".join(lines).encode()
    compare_results(dp.parse_blob(blob), gpu.parse_blob(blob), f"{tag} parse_blob")
    batches = [demolog.generate_combined_lines(N_LINES, seed=s, garbage_fraction=0.01)
               for s in (142, 143, 144)]
    for i, (g, w) in enumerate(zip(dp.parse_batch_stream(batches, depth=2),
                                   [gpu.parse_batch(b) for b in batches])):
        compare_results(g, w, f"{tag} stream batch {i}", arrow=False)
    agg_lines = lines + demolog.aggregate_edge_lines()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    agg = dp.aggregate_batch(agg_lines, demolog.DASHBOARD_OPS)
    agg_wall = time.perf_counter() - t0
    agg_launches = kernels.launch_counts()
    agg_want = gpu.aggregate_batch(agg_lines, demolog.DASHBOARD_OPS)
    compare_aggregates(agg, agg_want, f"{tag} aggregate_batch")
    if agg.state.to_ipc_bytes() != agg_want.state.to_ipc_bytes():
        fail(f"{tag}: the mesh aggregate's IPC bytes differ from one device's")
    for name in ("split", "pack_rows"):
        if launches[name] < width:
            fail(f"{tag}: {name} launched {launches[name]} times over {width} shards")
    for name in ("agg_lanes", "agg_reduce"):
        if agg_launches[name] < width:
            fail(f"{tag}: {name} launched {agg_launches[name]} times over {width} shards")
    emit({"phase": tag, "B": len(lines), "mesh_devices": dp.mesh_devices,
          "equal_to_unsharded": True, **rescue(got), "wall_seconds": wall,
          "unsharded_wall_seconds": solo_wall, "stage_seconds": got.stage_seconds,
          "unsharded_stage_seconds": want.stage_seconds,
          "aggregate_wall_seconds": agg_wall, "aggregate_d2h_bytes": agg.d2h_bytes,
          "unsharded_aggregate_d2h_bytes": agg_want.d2h_bytes,
          "launches": launches, "aggregate_launches": agg_launches, "card": smi})


def sp_split_phase(torch, kernels, runtime, mesh, phase, rows, gpu, lines, dbuf, dlen,
                   smi):
    """The SP runner over the padded headline batch on a 2 x 4 mesh
    (shard width 96), every shard on one card: one sp_program launch per
    data shard, held to its plain version, to the per-op path and to
    run_program on every row whose line holds no escaped quote (the
    reference's SP has no escape parity); sp_program's launches against
    their plain version (timed), then the per-op path's sp_split launches
    against theirs (timed: all launches of a batch), both runners' walls."""
    prog = gpu.units[0].program
    B, L = dbuf.shape
    m = mesh.make_mesh(2, 4, devices=[torch.device("cuda", 0)] * 8)
    run = mesh.sequence_parallel_runner(prog, m, L)
    per_op = mesh._sp_runner(prog, m, L, one_launch=False)
    got, launches, op_launches = sp_paths(torch, kernels, mesh, run, per_op, dbuf, dlen,
                                          2, "sp_split")
    single = runtime.run_program(prog, dbuf, dlen)
    same = torch.ones(B, dtype=torch.bool, device=dbuf.device)
    for key in ("starts", "ends"):
        same &= (got[key] == single[key]).all(dim=0)
    same &= got["valid"] == single["valid"]
    differ = (~same).nonzero().flatten().tolist()
    texts = lines + [""] * (B - len(lines))
    if any('\\"' not in texts[i] for i in differ):
        fail(f"sp_split: rows without an escaped quote differ from run_program: "
             f"{[i for i in differ if chr(92) + chr(34) not in texts[i]][:5]}")
    walls = {"runner_wall_ms": time_wall(torch, lambda: run(dbuf, dlen), 10),
             "per_op_runner_wall_ms": time_wall(torch, lambda: per_op(dbuf, dlen), 10)}
    plain = mesh.sp_program_plain
    fused = recorded(kernels, "sp_program", lambda: run(dbuf, dlen))
    phase("sp_program", lambda: flat([kernels.sp_program(*a, **k) for a, k in fused]),
          lambda: flat([plain(*a, **k) for a, k in fused]), *sp_cost(prog, B, L), n=B,
          width=L, extra={"mesh": list(m.shape), "shard_width": L // 4,
                          "launches_per_batch": len(fused),
                          "rows_differing_from_run_program": len(differ),
                          "all_differing_rows_hold_an_escaped_quote": True,
                          "equal_to_per_op_path": True, "valid": int(got["valid"].sum()),
                          **walls,
                          "run_program_ms": time_kernel(
                              torch, lambda: runtime.run_program(prog, dbuf, dlen), 10)})
    rows["sp_program"]["launches"] = launches["sp_program"]
    calls = recorded(kernels, "sp_split", lambda: per_op(dbuf, dlen))
    phase("sp_split", lambda: [kernels.sp_split(*a, **k) for a, k in calls],
          lambda: [mesh.sp_split_step_plain(*a, **k) for a, k in calls],
          *sp_cost(prog, B, L), n=B, width=L,
          extra={"mesh": list(m.shape), "path": "per-op", "launches_per_batch": len(calls),
                 **walls})
    rows["sp_split"]["launches"] = op_launches["sp_split"]
    return got


def sp_long_phase(torch, kernels, runtime, mesh, gpu, smi, clock):
    """Lines of 8,192 to 32,000 bytes (8,192 of them, seed 63, ~1%
    garbage) at L = 32,768 on a 1 x 4 mesh (shard width 8,192): one
    sp_program launch, equal to its plain version and to the per-op path,
    every non-garbage row valid; both paths' kernels timed, lines/s of
    the runners."""
    from logparser_tpu_torch.tools.demolog import long_combined_lines

    t0 = time.perf_counter()
    lines = long_combined_lines(8192, seed=63)
    buf, lengths, overflow = runtime.encode_batch(lines, line_len=32768)
    gen_s = time.perf_counter() - t0
    if overflow:
        fail(f"sp_long: {len(overflow)} lines past 32,768 bytes")
    B, L = buf.shape
    dbuf, dlen = torch.from_numpy(buf).cuda(), torch.from_numpy(lengths).cuda()
    prog = gpu.units[0].program
    m = mesh.make_mesh(1, 4)
    run = mesh.sequence_parallel_runner(prog, m, L)
    per_op = mesh._sp_runner(prog, m, L, one_launch=False)
    got, launches, op_launches = sp_paths(torch, kernels, mesh, run, per_op, dbuf, dlen,
                                          1, "sp_long")
    long_rows = torch.from_numpy(lengths >= 8192).cuda()
    if not bool(got["valid"][long_rows].all()):
        fail(f"sp_long: {int((~got['valid'][long_rows]).sum())} long lines invalid")
    plain = mesh.sp_program_plain
    fused = recorded(kernels, "sp_program", lambda: run(dbuf, dlen))
    replay = lambda: flat([kernels.sp_program(*a, **k) for a, k in fused])  # noqa: E731
    want = flat([plain(*a, **k) for a, k in fused])
    require_equal(torch, "sp_long", replay(), want)
    calls = recorded(kernels, "sp_split", lambda: per_op(dbuf, dlen))
    replay_op = lambda: [kernels.sp_split(*a, **k) for a, k in calls]  # noqa: E731
    bytes_moved, ops = sp_cost(prog, B, L)
    bound, bound_by = bound_ms(bytes_moved, ops)
    wall_ms = time_wall(torch, lambda: run(dbuf, dlen), 5)
    ms, enqueue_ms = clock.time(replay, 10)
    op_ms, op_enqueue_ms = clock.time(replay_op, 10)
    emit({"phase": "sp_long", "B": B, "L": L, "mesh": [1, 4], "shard_width": L // 4,
          "buffer_bytes": int(buf.nbytes), "long_lines": int(long_rows.sum()),
          "valid": int(got["valid"].sum()), "equal": True, "equal_to_per_op_path": True,
          "launches": launches["sp_program"], "ms": ms, "enqueue_ms": enqueue_ms,
          "plain_ms": time_kernel(torch, lambda: flat([plain(*a, **k) for a, k in fused]), 3),
          "per_op_launches": op_launches["sp_split"], "per_op_ms": op_ms,
          "per_op_enqueue_ms": op_enqueue_ms,
          "runner_wall_ms": wall_ms, "lines_per_s": B / (wall_ms / 1e3),
          "per_op_runner_wall_ms": time_wall(torch, lambda: per_op(dbuf, dlen), 5),
          "bound_ms": bound, "bound_by": bound_by, "bytes": bytes_moved,
          "generate_encode_seconds": gen_s, "card": smi})


def counters_phase(torch, kernels, mesh, phase, rows, gpu, lines, smi):
    """aggregate_counters over 4 shards on one card of the headline
    parse's valid and ~valid: one counters launch, equal to valid.sum()
    and (~valid).sum() in int32; that launch against the plain version and
    torch.stack((good, bad)).sum(1); then the whole call's wall, the host
    included (``counters_runner``)."""
    import numpy as np

    res = gpu.parse_batch(lines)
    good = torch.from_numpy(np.asarray(res.valid, dtype=bool)).cuda()
    bad = ~good
    m = mesh.make_mesh(4)
    kernels.reset_launch_counts()
    g, b = mesh.aggregate_counters(m, good, bad)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["counters"]
    if launches != 1:
        fail(f"aggregate_counters launched counters {launches} times on a one-card 4 x 1 "
             "mesh, not once")
    want = (int(res.valid.sum()), int((~res.valid).sum()))
    if (int(g), int(b)) != want or g.dtype != torch.int32 or b.dtype != torch.int32:
        fail(f"aggregate_counters: {(int(g), int(b))} ({g.dtype}) != {want}")
    calls = recorded(kernels, "counters", lambda: mesh.aggregate_counters(m, good, bad))
    B = good.shape[0]
    phase("counters", lambda: [kernels.counters(*a) for a, _ in calls],
          lambda: [mesh.counters_plain(*a) for a, _ in calls],
          bytes_moved=2 * B + 8 * len(calls), ops=2 * B, n=B, width=1,
          library=lambda: [torch.stack((g, b)).sum(1) for (g, b), _ in calls],
          extra={"shards": m.shape[0], "launches": len(calls), "good": want[0],
                 "bad": want[1]})
    rows["counters"]["launches"] = launches

    def runner():
        return mesh.aggregate_counters(m, good, bad)

    with swapped(kernels, "counters", mesh.counters_plain):
        plain_g, plain_b = runner()
    if (int(plain_g), int(plain_b)) != want:
        fail("aggregate_counters over the plain version differs")
    runner()   # warm
    emit({"phase": "counters_runner", "B": B, "shards": m.shape[0],
          "wall_ms": time_wall(torch, runner, KERNEL_REPS),
          "enqueue_ms": phase.clock.enqueue_ms(runner), "card": smi})


def compare_results(got, want, what, arrow=True) -> None:
    """needs_host (the oracle_row_ids), valid, reject_reasons, to_dict()
    and (with ``arrow``) to_arrow(strings="copy") of the card's result
    equal the CPU's -- the host oracle's rescued rows included."""
    if got.oracle_row_ids.tolist() != want.oracle_row_ids.tolist():
        fail(f"{what}: oracle_row_ids differ: {got.oracle_row_ids[:10]} vs "
             f"{want.oracle_row_ids[:10]}")
    if got.valid.tolist() != want.valid.tolist():
        i = next(i for i, (a, b) in enumerate(zip(got.valid, want.valid)) if a != b)
        fail(f"{what}: valid differs at row {i}: {got.valid[i]} vs {want.valid[i]}")
    if got.reject_reasons != want.reject_reasons:
        fail(f"{what}: reject_reasons differ: {sorted(got.reject_reasons.items())[:5]} vs "
             f"{sorted(want.reject_reasons.items())[:5]}")
    got_d, want_d = got.to_dict(), want.to_dict()
    for fid in want_d:
        if got_d[fid] != want_d[fid]:
            i = next(i for i, (a, b) in enumerate(zip(got_d[fid], want_d[fid])) if a != b)
            fail(f"{what}: {fid} row {i}: {got_d[fid][i]!r} != {want_d[fid][i]!r}")
    if not arrow:
        return
    got_t, want_t = got.to_arrow(strings="copy"), want.to_arrow(strings="copy")
    if not got_t.equals(want_t):
        bad = [n for n in want_t.column_names
               if n not in got_t.column_names or not got_t.column(n).equals(want_t.column(n))]
        fail(f"{what}: to_arrow differs in {bad[:5]}")


if __name__ == "__main__":
    sys.exit(main())
