"""Variants of one kernel's source beside this checkout's, on kernel_ab's
cases, on one card, in one process.

    python3 -m logparser_tpu_torch.tools.kernel_variants KERNEL VARIANTS.json   # from the root

VARIANTS.json maps a variant's name to a list of [old, new] text
substitutions on ``csrc/KERNEL.cu`` (each ``old`` must occur; a ``new``
may include a header that lies beside VARIANTS.json).  Each
variant is built with nvcc into a temporary directory and run through
this checkout's wrapper with its library swapped in (as kernel_ab runs a
parent).  A variant is held to the plain version bit for bit (agg_group's
as key -> count maps) unless its name starts with ``x_``: an ablation that compiles a phase out, whose
outputs are wrong by design.  Then every variant and the checkout are
timed with chip_smoke.DeviceClock on each of kernel_ab's cases for the
kernel; one JSON line per case (device ms), the card's name and power
limit, and a last line ``{"ok": true, ...}``.  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import kernel_ab

REPS = 15


def main(argv) -> int:
    if len(argv) != 2 or argv[0] not in kernel_ab.CASES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    from ..tpu import kernels, pipeline

    name = argv[0]
    variants = json.loads(Path(argv[1]).read_text())
    beside = Path(argv[1]).resolve().parent
    src = (kernels.CSRC / f"{name}.cu").read_text()
    smi = smoke.card_line()
    kernels.build()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for v, subs in variants.items():
            text = src
            for old, new in subs:
                if old not in text:
                    print(f"kernel_variants: {v}: no {old!r} in {name}.cu", file=sys.stderr)
                    return 2
                text = text.replace(old, new)
            path = Path(tmp) / f"{name}_{v}.cu"
            path.write_text(text)
            procs[v] = (text, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-I", str(beside),
                 "-o",
                 str(Path(tmp) / f"lib{name}_{v}.so"), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for v, (text, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"kernel_variants: nvcc refused {v}:\n{log}", file=sys.stderr)
                return 1
            libs[v] = kernel_ab.ParentLib(Path(tmp) / f"lib{name}_{v}.so", name, text, src)
        clock = smoke.DeviceClock(torch)
        for case in kernel_ab.CASES[name](smoke, kernels, pipeline):
            canonical = case.canonical or (lambda out: out)
            want = canonical(case.plain())
            line = {"case": case.name}
            for v, lib in libs.items():
                def run(lib=lib, case=case):
                    with kernel_ab.parent_kernel(case.kernel, lib):
                        return case.run()

                got = canonical(run())
                torch.cuda.synchronize()
                if not v.startswith("x_") and kernel_ab._n_differ(got, want):
                    print(f"kernel_variants: {case.name}: {v} differs from the plain "
                          "version", file=sys.stderr)
                    return 1
                line[f"{v}_ms"] = clock.time(run, REPS)[0]
            line["checkout_ms"] = clock.time(case.run, REPS)[0]
            line["card"] = smi
            print(json.dumps(line), flush=True)
            del want, case
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
