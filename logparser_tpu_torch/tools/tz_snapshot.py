"""Regenerate ``dissectors/tz_wall_tables.json``, the snapshot of the
default zone vocabulary's wall-clock transition tables the port builds
its ``ZoneDeviceTable`` from.

    python -m logparser_tpu_torch.tools.tz_snapshot [--check]

Reads this machine's tzdata with the port's own TZif reader
(``dissectors/tztable.read_tzif`` / ``wall_table``), keeps the zones
zoneinfo confirms, and writes one JSON line per zone.  ``--check``
compares instead of writing and exits 1 on a difference (a tzdata
release that moved a transition).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import zoneinfo
from pathlib import Path
from typing import Optional

from ..dissectors import tztable


def tzdata_version() -> Optional[str]:
    """The release named in the first line of tzdata.zi, when present."""
    for base in zoneinfo.TZPATH:
        zi = Path(base) / "tzdata.zi"
        if zi.is_file():
            first = zi.read_text(errors="replace").splitlines()[:1]
            if first and first[0].startswith("# version "):
                return first[0][len("# version "):].strip()
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the committed snapshot, write nothing")
    args = ap.parse_args(argv)
    tables = tztable.tzdata_wall_tables(tztable.DEFAULT_DEVICE_ZONES)
    if not tables:
        print("no tzdata on this machine: nothing to snapshot", file=sys.stderr)
        return 1
    if args.check:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "tables.json"
            tztable.write_snapshot(tables, path, tzdata_version())
            fresh = tztable.read_snapshot(path)
        old = tztable.read_snapshot()
        same = list(fresh) == list(old) and all(
            (fresh[z][0] == old[z][0]).all() and (fresh[z][1] == old[z][1]).all()
            and fresh[z][2] == old[z][2] for z in fresh)
        print("snapshot up to date" if same else "snapshot differs from this tzdata")
        return 0 if same else 1
    tztable.write_snapshot(tables, tztable.SNAPSHOT, tzdata_version())
    n = sum(len(b) for b, _, _ in tables.values())
    print(f"wrote {len(tables)} zones, {n} transitions to {tztable.SNAPSHOT.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
