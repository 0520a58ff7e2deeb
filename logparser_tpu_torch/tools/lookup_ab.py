"""The zone_lookup and geo_lookup kernels of a parent commit beside this
checkout's, on one card, in one process.

    mkdir -p DIR && for f in zone_lookup.cu tz_lookup.cuh geo_lookup.cu lp_common.cuh; do
        git show PARENT:logparser_tpu_torch/csrc/$f > DIR/$f; done
    python3 -m logparser_tpu_torch.tools.lookup_ab DIR      # from the checkout's root

Builds the parent's two kernels with nvcc into a temporary directory and
binds them with the parent's C interface (a thread a key, tables in
device memory).  Then, on the inputs of chip_smoke.py's lookup phases --
``zone_lookup`` (every transition key +-1 minute, the window and clip
edges, 65,536 random pairs), ``zone_lookup_gated`` (the %Z path: the
zonetext batch's timestamp rows), ``geo_lookup`` (the geoip_chain path:
City and ASN, two launches), ``geo_lookup_synthetic`` (the 131,072-network
synthetic City table) and ``geo_lookup_large`` (4,194,304 seeded ranges)
-- it holds both kernels to the plain version bit for bit and times them
with chip_smoke.DeviceClock in turns (parent, change, change, parent),
with torch.searchsorted beside them, and once more under the old
yardstick (chip_smoke.time_kernel, the host's enqueue inside the
window).  One JSON line per case, the card's name and power limit, and
a last line ``{"ok": true, ...}``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

_P, _INT = ctypes.c_void_p, ctypes.c_int
# The parent's ctypes argument lists, the stream last.
PARENT_SIGNATURES = {
    "zone_lookup": [_INT, _P, _P, _P, _P, _P, _P, _INT, _INT, _P, _P, _P],
    "geo_lookup": [_INT, _P, _P, _P, _P, _INT, _P, _P],
}
REPS = 25


def build_parent(src: Path, out: Path):
    """{kernel: the parent's entry point}, built from ``src`` into ``out``."""
    from ..tpu import kernels

    procs = {}
    for k in PARENT_SIGNATURES:
        procs[k] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(src), "-o",
             str(out / f"lib{k}_parent.so"), str(src / f"{k}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for k, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc refused the parent's {k}.cu:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{k}_parent.so")), f"lp_{k}")
        fn.argtypes = PARENT_SIGNATURES[k]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def _call(fn, *args):
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"parent kernel launch failed ({code})")


def zone_cases(smoke, kernels, pipeline, parent):
    """(name, parent fn, new fn, plain fn, library fn, bound bytes) of the
    two zone inputs."""
    from ..dissectors.tztable import SPAN_MINUTES, default_zone_table
    from ..tools import demolog
    from ..tpu import runtime
    from .. import TorchBatchParser

    zt = pipeline.ZoneTables(default_zone_table()).cuda()
    table = zt.table
    old = {"buckets": torch.from_numpy(table.buckets).cuda(),
           "packed": torch.from_numpy(table.packed().copy()).cuda(),
           "valid_until": torch.from_numpy(table.valid_until.astype(np.int32)).cuda()}

    def case(name, zones, minutes, gate, bound):
        B = zones.shape[0]
        out = torch.empty((2, B), dtype=torch.int32, device="cuda")
        g = gate.data_ptr() if gate is not None else None

        def run_parent():
            _call(parent["zone_lookup"], B, zones.data_ptr(), minutes.data_ptr(), g,
                  old["buckets"].data_ptr(), old["packed"].data_ptr(),
                  old["valid_until"].data_ptr(), len(table.keys), table.chain,
                  out[0].data_ptr(), out[1].data_ptr())
            return out

        query = zones.to(torch.int64) * SPAN_MINUTES + minutes.to(torch.int64).clamp(
            0, SPAN_MINUTES - 1)
        sorted_keys = torch.from_numpy(table.keys.astype(np.int64)).cuda()
        return (name, run_parent, lambda: kernels.zone_lookup(zt, zones, minutes, gate=gate),
                lambda: pipeline.zone_lookup_plain(zt, zones, minutes, gate,
                                                   torch.empty((2, B), dtype=torch.int32,
                                                               device="cuda")),
                lambda: torch.searchsorted(sorted_keys, query, right=True), bound)

    z, m = smoke.zone_probe_pairs(np, table, SPAN_MINUTES)
    zones, minutes = torch.from_numpy(z).cuda(), torch.from_numpy(m).cuda()
    yield case("zone_lookup", zones, minutes, None,
               16 * len(z) + smoke.zone_table_bytes(torch, zt, zones, minutes))

    lines = demolog.zonetext_lines(smoke.N_LINES) + demolog.strftime_edge_lines()
    buf, lengths, _ = runtime.encode_batch(lines)
    (t,) = TorchBatchParser(demolog.ZONETEXT_FORMAT, demolog.ZONETEXT_FIELDS).executor.unit_tables
    (ts,) = t.ts
    dbuf, dlen = torch.from_numpy(buf).cuda(), torch.from_numpy(lengths).cuda()
    starts, ends, _ = kernels.split(t.split, dbuf, dlen)
    zones = torch.empty(dbuf.shape[0], dtype=torch.int32, device="cuda")
    rows = kernels.timestamp(ts, dbuf, starts, ends, zone_out=zones)
    minutes, gate = rows[2].clone(), rows[3].clone()
    yield case("zone_lookup_gated", zones, minutes, gate,
               20 * len(lines) + smoke.zone_table_bytes(torch, zt, zones, minutes))


def geo_cases(smoke, kernels, pipeline, parent):
    """(name, parent fn, new fn, plain fn, library fn, bound bytes) of the
    three geo inputs; each case is a list of (tables, keys, gate) joins."""
    from ..geoip import GeoDeviceTable, GeoIPASNDissector, GeoIPCityDissector
    from ..tools import demolog, geoip_testdata
    from ..tpu import runtime
    from .. import TorchBatchParser

    mask = 0xFFFFFFFF
    fixtures = geoip_testdata.ensure_test_databases()
    asn = os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb")

    def joins_of(city, lines, city_only=False):
        parser = TorchBatchParser("combined", demolog.GEOIP_FIELDS, extra_dissectors=[
            GeoIPCityDissector(city), GeoIPASNDissector(asn)])
        (t,) = parser.executor.unit_tables
        buf, lengths, _ = runtime.encode_batch(lines)
        dbuf, dlen = torch.from_numpy(buf).cuda(), torch.from_numpy(lengths).cuda()
        starts, ends, _ = kernels.split(t.split, dbuf, dlen)
        groups = [g for g in t.geo if not city_only or "location.latitude" in g.table.columns]
        out = []
        for g in groups:
            ip = kernels.ipv4_spans(g, dbuf, starts, ends)
            out.append((g, ip[0].clone(), ip[1].clone()))
        return out

    def case(name, joins):
        outs = [torch.empty_like(k) for _, k, _ in joins]

        def run_parent():
            for (g, k, gate), o in zip(joins, outs):
                _call(parent["geo_lookup"], k.shape[0], k.data_ptr(),
                      gate.data_ptr() if gate is not None else None, g.starts.data_ptr(),
                      g.ends.data_ptr(), g.starts.shape[0], o.data_ptr())
            return outs

        lib = [(g.starts.to(torch.int64) & mask, k.to(torch.int64) & mask) for g, k, _ in joins]
        bound = 0
        for g, k, gate in joins:
            host_gate = None if gate is None else gate.cpu().numpy()
            bound += (8 + (0 if gate is None else 4)) * k.shape[0] + smoke.geo_search_bytes(
                np, g.table.starts, g.table.ends, k.cpu().numpy().view(np.uint32), host_gate)[0]
        return (name, run_parent,
                lambda: [kernels.geo_lookup(g, k, gate=gate) for g, k, gate in joins],
                lambda: [pipeline.geo_lookup_plain(g, k, gate, torch.empty_like(k))
                         for g, k, gate in joins],
                lambda: [torch.searchsorted(s, k, right=True) for s, k in lib], bound)

    city = os.path.join(fixtures, "GeoIP2-City-Test.mmdb")
    edge = demolog.geoip_edge_lines()
    yield case("geo_lookup", joins_of(city, demolog.geoip_chain_lines(smoke.N_LINES) + edge))

    syn = geoip_testdata.ensure_synthetic_city_database(seed=smoke.GEO_SYNTHETIC_SEED)
    nets = geoip_testdata.synthetic_networks(geoip_testdata.SYNTHETIC_NETWORKS,
                                             smoke.GEO_SYNTHETIC_SEED)
    yield case("geo_lookup_synthetic",
               joins_of(syn, demolog.geoip_synthetic_lines(smoke.N_LINES, nets) + edge, True))

    large, keys = smoke.large_geo_table(np, GeoDeviceTable)
    gl = pipeline.GeoTables(pipeline._GeoGroup("large", 0, large)).cuda()
    yield case("geo_lookup_large", [(gl, torch.from_numpy(keys.view(np.int32)).cuda(), None)])


def _same(a, b) -> bool:
    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("lookup_ab needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    from ..tpu import kernels, pipeline

    smi = smoke.card_line()
    kernels.build()
    with tempfile.TemporaryDirectory() as tmp:
        parent = build_parent(Path(argv[0]).resolve(), Path(tmp))
        clock = smoke.DeviceClock(torch)
        cases = list(zone_cases(smoke, kernels, pipeline, parent))
        cases += list(geo_cases(smoke, kernels, pipeline, parent))
        for name, run_parent, run_new, run_plain, run_lib, bound_bytes in cases:
            want = run_plain()
            for who, fn in (("parent", run_parent), ("change", run_new)):
                got = fn()
                torch.cuda.synchronize()
                if not _same(got, want):
                    print(f"lookup_ab: {name}: the {who} kernel differs from the plain "
                          "version", file=sys.stderr)
                    return 1
            turns = [("parent", run_parent), ("change", run_new), ("change", run_new),
                     ("parent", run_parent), ("library", run_lib)]
            line = {"case": name, "bound_ms": smoke.bound_ms(bound_bytes, 0)[0],
                    "bound_bytes": bound_bytes}
            for who, fn in turns:
                ms, enqueue = clock.time(fn, REPS)
                line.setdefault(f"{who}_ms", []).append(ms)
                line.setdefault(f"{who}_enqueue_ms", []).append(enqueue)
            for who, fn in turns[:2] + turns[-1:]:
                line[f"{who}_old_yardstick_ms"] = smoke.time_kernel(torch, fn, REPS)
            line["card"] = smi
            print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
