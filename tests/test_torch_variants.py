"""The committed source variants of ``tools/kernel_variants.py`` still apply.

Each JSON file there maps a variant's name to [old, new] substitutions on
one kernel's source; the tool refuses a variant whose ``old`` text is
missing, but only on the card.  These CPU tests apply every variant to
this checkout's kernel source, so a kernel edit that breaks a committed
ablation or layout variant shows here.
"""
import json
import re
from pathlib import Path

import pytest

from logparser_tpu_torch.tpu import kernels

TOOLS = Path(kernels.__file__).resolve().parent.parent / "tools"
VARIANT_FILES = {"split_phases.json": "split", "uri_variants.json": "uri_split",
                 "setcookie_variants.json": "setcookie_split",
                 "pack_rows_variants.json": "pack_rows",
                 "span_stages_variants.json": "span_stages",
                 "timestamp_variants.json": "timestamp",
                 "agg_group_variants.json": "agg_group",
                 "muid_variants.json": "muid",
                 "ipv4_spans_variants.json": "ipv4_spans",
                 "agg_lanes_variants.json": "agg_lanes",
                 "geo_gather_variants.json": "geo_gather",
                 "counters_variants.json": "counters"}


def test_every_variant_file_names_its_kernel():
    assert sorted(p.name for p in TOOLS.glob("*.json")) == sorted(VARIANT_FILES)


@pytest.mark.parametrize("name", sorted(VARIANT_FILES))
def test_variant_file_applies_to_its_kernel(name):
    """Each variant's substitutions apply in order, as kernel_variants
    applies them (every ``old`` occurs in the text so far), change the
    source, and include only headers that lie in csrc/ or beside the
    JSON file (the variant's include path)."""
    src = (kernels.CSRC / f"{VARIANT_FILES[name]}.cu").read_text()
    variants = json.loads((TOOLS / name).read_text())
    assert variants
    for v, subs in variants.items():
        text = src
        for old, new in subs:
            assert old in text, (v, old)
            text = text.replace(old, new)
            for header in re.findall(r'#include "([^"]+)"', new):
                assert (kernels.CSRC / header).exists() or (TOOLS / header).exists(), (v, header)
        assert text != src, v
