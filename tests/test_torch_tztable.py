"""The port's zone table equals the reference's, and so does its lookup.

The port builds its ``ZoneDeviceTable`` from the committed snapshot
``logparser_tpu_torch/dissectors/tz_wall_tables.json`` only; the
reference builds its table from this machine's tzdata.  Both must hold
the same zones, keys, offsets, windows, buckets and chain (a tzdata
release that moves a transition shows up here, not as wrong offsets), and
the plain ``lookup`` must equal the reference's at every transition key
+-1 minute of all zones, at each zone's ``valid_until`` - 1 and
``valid_until``, and at minutes -1, 0 and 2^26 (tolerance 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.dissectors.tztable import default_zone_table as ref_default_zone_table
from logparser_tpu_torch.dissectors import tztable
from logparser_tpu_torch.tools import tz_snapshot
from logparser_tpu_torch.tpu import kernels, pipeline


@pytest.fixture(scope="module")
def tables():
    return tztable.default_zone_table(), ref_default_zone_table()


def test_snapshot_table_equals_the_reference(tables):
    ours, ref = tables
    assert ours.zones == ref.zones and len(ours.zones) == 63
    for name in ("keys", "offsets_s", "valid_until", "buckets"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ours.chain == ref.chain
    assert np.array_equal(ours.packed().view(np.uint32), ref._packed_keys_offsets())


def test_snapshot_is_what_the_port_reads_from_tzdata():
    """The port's own TZif reader over this machine's tzdata gives the
    committed snapshot (the snapshot tool's --check)."""
    assert tz_snapshot.main(["--check"]) == 0


def test_snapshot_round_trips(tmp_path):
    tables = tztable.read_snapshot()
    path = tmp_path / "t.json"
    tztable.write_snapshot(tables, path, "x")
    again = tztable.read_snapshot(path)
    assert list(again) == list(tables)
    for z in tables:
        assert np.array_equal(again[z][0], tables[z][0]) and again[z][2] == tables[z][2]
        assert np.array_equal(again[z][1], tables[z][1])


def _probe_points(table):
    """(zone, minute) pairs: every transition key +-1, each zone's window
    edges, and the clip edges."""
    zones, minutes = [], []
    span = tztable.SPAN_MINUTES
    for key in table.keys.astype(np.int64).tolist():
        z, m = divmod(key, span)
        for d in (-1, 0, 1):
            zones.append(z)
            minutes.append(m + d)
    for z, vu in enumerate(table.valid_until.tolist()):
        for m in (vu - 1, vu, -1, 0, span, span - 1, -(1 << 31), (1 << 31) - 1):
            zones.append(z)
            minutes.append(m)
    return (np.asarray(zones, dtype=np.int32),
            np.clip(np.asarray(minutes, dtype=np.int64), -(1 << 31), (1 << 31) - 1
                    ).astype(np.int32))


def test_lookup_matches_reference_at_every_transition(tables):
    ours, ref = tables
    zones, minutes = _probe_points(ref)
    assert len(zones) > 3 * 5000
    off, ok = ours.lookup(torch.from_numpy(zones), torch.from_numpy(minutes))
    ref_off, ref_ok = ref.lookup(jnp.asarray(zones), jnp.asarray(minutes))
    assert off.dtype == torch.int32
    assert np.array_equal(off.numpy(), np.asarray(ref_off))
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert ok.any() and (~ok).any()


def test_lookup_matches_reference_on_random_pairs(tables):
    ours, ref = tables
    rng = np.random.default_rng(11)
    zones = rng.integers(0, len(ref.zones), size=4000).astype(np.int32)
    minutes = rng.integers(-1000, tztable.SPAN_MINUTES + 1000, size=4000).astype(np.int32)
    off, ok = ours.lookup(torch.from_numpy(zones), torch.from_numpy(minutes))
    ref_off, ref_ok = ref.lookup(jnp.asarray(zones), jnp.asarray(minutes))
    assert np.array_equal(off.numpy(), np.asarray(ref_off))
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))


def test_zone_lookup_wrapper_on_the_cpu(tables):
    """The kernel's wrapper runs the plain version on CPU tensors; with a
    gate row it narrows the verdict, in place on the gate's rows."""
    ours, _ = tables
    zt = pipeline.ZoneTables(ours)
    zones = torch.tensor([1, 1, 0, 5], dtype=torch.int32)
    minutes = torch.tensor([28_000_000, -1, 5, 28_000_000], dtype=torch.int32)
    out = kernels.zone_lookup(zt, zones, minutes)
    want_off, want_ok = ours.lookup(zones, minutes)
    assert torch.equal(out[0], want_off) and torch.equal(out[1], want_ok.to(torch.int32))
    rows = torch.stack([minutes, torch.tensor([1, 1, 1, 0], dtype=torch.int32)])
    kernels.zone_lookup(zt, zones, rows[0], gate=rows[1], out=rows)
    assert torch.equal(rows[0], want_off)
    assert rows[1].tolist() == [int(want_ok[0]), 0, int(want_ok[2]), 0]
    with pytest.raises(TypeError):
        kernels.zone_lookup(zt, zones.to(torch.int64), minutes)
    with pytest.raises(ValueError):
        kernels.zone_lookup(zt, zones[:2], minutes)


def test_vocabulary_order_is_the_references():
    """Abbreviations first (case-folded), then the region ids (exact), with
    the reference's zone indices."""
    from logparser_tpu.dissectors.strftime_stamp import compile_strftime
    from logparser_tpu.tpu.timeparse import compile_layout_for_device
    from logparser_tpu_torch.tpu.timeparse import zone_vocabulary

    (zone_item,) = compile_layout_for_device(compile_strftime("%Y %m %d %Z")).segments[-1]
    vocab = zone_vocabulary(tztable.default_zone_table())
    assert tuple(e[0] for e in vocab) == zone_item.table
    assert tuple(e[1] for e in vocab) == zone_item.zone_idx
    assert tuple(e[2] for e in vocab) == zone_item.fold_flags
    assert len(vocab) == 83


# -- the zone_lookup kernel's coarse index --------------------------------------


def _kernel_search(zt, zones, minutes):
    """The zone_lookup kernel's search in numpy, over ZoneTables.image as a
    block stages it: (transition index, offset seconds, ok)."""
    raw = zt.image.numpy().view(np.uint8)
    index = raw[:zt.packed_at].view(np.uint16)
    packed = raw[zt.packed_at:zt.packed_at + 8 * zt.n_transitions].view(np.uint32).reshape(-1, 2)
    valid = raw[zt.valid_at:zt.valid_at + 4 * zt.n_zones].view(np.int32)
    span = tztable.SPAN_MINUTES
    key = zones.astype(np.int64) * span + np.clip(minutes.astype(np.int64), 0, span - 1)
    idx = index[key >> zt.index_bits].astype(np.int64)
    last = max(zt.n_transitions - 1, 0)
    for _ in range(zt.chain):
        nxt = np.minimum(idx + 1, last)
        idx = np.where(packed[nxt, 0] <= key, nxt, idx)
    off = (packed[idx, 1].astype(np.int64) - (1 << 17)).astype(np.int32)
    return idx, off, (minutes >= 0) & (minutes < valid[zones])


def _random_pairs(table, n=20000, seed=12):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, len(table.zones), size=n).astype(np.int32),
            rng.integers(-1000, tztable.SPAN_MINUTES + 1000, size=n).astype(np.int32))


@pytest.mark.parametrize("probe", ["transitions", "random"])
def test_coarse_index_search_matches_reference(tables, probe):
    """The kernel's coarse index plus its forward steps find the
    reference's transition (the last key at or below the clipped key) and
    give ZoneDeviceTable.lookup's offset and ok."""
    ours, ref = tables
    zones, minutes = _probe_points(ref) if probe == "transitions" else _random_pairs(ref)
    zt = pipeline.ZoneTables(ours)
    idx, off, ok = _kernel_search(zt, zones, minutes)
    span = tztable.SPAN_MINUTES
    key = zones.astype(np.int64) * span + np.clip(minutes.astype(np.int64), 0, span - 1)
    want_idx = np.maximum(np.searchsorted(ref.keys.astype(np.int64), key, side="right") - 1, 0)
    assert np.array_equal(idx, want_idx)
    ref_off, ref_ok = ref.lookup(jnp.asarray(zones), jnp.asarray(minutes))
    assert np.array_equal(off, np.asarray(ref_off))
    assert np.array_equal(ok, np.asarray(ref_ok))
    assert (idx > 0).any() and ok.any() and (~ok).any()


def test_coarse_index_fits_a_block(tables):
    """2^18-minute buckets, at most 4 forward steps, each entry the last
    transition at or before its bucket's start; the image (index, packed
    rows, windows, each padded to 16 bytes) fits one block's shared
    memory."""
    ours, ref = tables
    zt = pipeline.ZoneTables(ours)
    assert zt.index_bits == 18 and 1 <= zt.chain <= 4
    Z, T = len(ref.zones), len(ref.keys)
    index = zt.image.numpy().view(np.uint8)[:zt.packed_at].view(np.uint16)
    assert zt.packed_at == 2 * (Z << 8) == 32256
    starts = np.arange(Z << 8, dtype=np.int64) << 18
    keys = ref.keys.astype(np.int64)
    assert np.array_equal(index, np.searchsorted(keys, starts, side="right") - 1)
    steps = np.searchsorted(keys, starts + (1 << 18) - 1, side="right") - (index + 1)
    assert steps.max() == zt.chain
    assert zt.valid_at == zt.packed_at + -(-8 * T // 16) * 16
    assert zt.smem_bytes == zt.valid_at + -(-4 * Z // 16) * 16
    assert zt.smem_bytes <= pipeline.SMEM_TABLE_BUDGET
    assert zt.image.dtype == torch.int32 and 4 * zt.image.numel() == zt.smem_bytes


def _dense_wall_tables(n_zones, per_zone):
    """Wall tables with a transition every 4,096 minutes (at most 3 inside
    a reference bucket of 2^14 minutes)."""
    bounds = np.arange(per_zone, dtype=np.int64) * 4096
    offsets = np.where(np.arange(per_zone) % 2 == 0, 0, 3600).astype(np.int32)
    return {f"Z{z}": (bounds, offsets, tztable.SPAN_MINUTES - 1) for z in range(n_zones)}


@pytest.mark.parametrize("n_zones,per_zone,match", [
    (5, 16384, "65,535"),              # 81,920 transitions: past uint16
    (2, 15000, "bytes of shared memory"),   # 240 KB of packed rows
])
def test_zone_tables_that_cannot_fit_raise(n_zones, per_zone, match):
    table = tztable.ZoneDeviceTable.from_wall_tables(_dense_wall_tables(n_zones, per_zone))
    assert table.chain <= 4   # the reference's table builds
    with pytest.raises(ValueError, match=match):
        pipeline.ZoneTables(table)


def test_dense_zone_tables_that_fit_still_search_right():
    """A vocabulary with many more steps a bucket than the default (64)
    that fits the budget: the kernel's search equals the plain lookup."""
    table = tztable.ZoneDeviceTable.from_wall_tables(_dense_wall_tables(1, 16000))
    zt = pipeline.ZoneTables(table)
    assert zt.chain == 63
    _, minutes = _random_pairs(table, seed=13)
    bounds = np.arange(16000, dtype=np.int32) * 4096
    minutes = np.concatenate([minutes, bounds - 1, bounds, bounds + 1])
    zones = np.zeros(len(minutes), dtype=np.int32)
    _, off, ok = _kernel_search(zt, zones, minutes)
    want_off, want_ok = table.lookup(torch.from_numpy(zones), torch.from_numpy(minutes))
    assert np.array_equal(off, want_off.numpy()) and np.array_equal(ok, want_ok.numpy())
