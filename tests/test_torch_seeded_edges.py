"""agg_lanes and unescape on tools.kernel_ab's seeded edge cases, held to
the JAX package on the CPU.

``seeded_lanes_case``: eight formats with contested lines, 16 lanes (a
query key, every null mode of a long, byte counts of 0 to 20 digits,
times at the 1902-2037 window's edges with +-14 h offsets), host_kill
rows, rows past ``n_rows``.  The port's plain ``agg_lanes`` and
``agg_reduce`` give the reference's ``build_aggregate_fn`` outputs
(``cls``, ``n_device``, the sum tiles) and ``agg_group`` its groups in
canonical ``{key: count}`` form, as tests/test_torch_analytics.py holds
the dashboard.  ``seeded_unescape_case``: the reference's unescape spec
at every offset of a 16-byte chunk, spans at and past the window, the
staging cap and L, lifted starts; the plain ``unescape`` equals the
reference's ``unescape_compact_spans``.  Each case's generator must give
every path kind its kernel has (``lanes_kinds``, ``unescape_kinds``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logparser_tpu.analytics.device import build_aggregate_fn
from logparser_tpu.analytics.spec import AggregateSpec as RefSpec
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.analytics import AggregateSpec
from logparser_tpu_torch.analytics import device as agg_device
from logparser_tpu_torch.tools import kernel_ab
from logparser_tpu_torch.tools.demolog import DASHBOARD_OPS, HEADLINE_FIELDS
from logparser_tpu_torch.tpu import kernels, postproc
from logparser_tpu_torch.tpu.runtime import encode_batch

LANES_B = 2048


@functools.lru_cache(maxsize=None)
def _lanes_run():
    """The reference's partials and the port's plain kernels' outputs on
    the seeded lines (cached: the reference's compile is the cost)."""
    lines, n_rows, kill = kernel_ab.seeded_lanes_case(LANES_B, seed=16)
    buf, lengths, overflow = encode_batch(lines)
    kill[np.asarray(overflow, dtype=np.int64)] = 1
    ref = TpuBatchParser(kernel_ab.SEEDED_LANES_FORMAT, list(kernel_ab.SEEDED_LANES_FIELDS))
    fn, _ = build_aggregate_fn(ref, RefSpec.parse(kernel_ab.SEEDED_LANES_OPS))
    out = fn(jnp.asarray(buf), jnp.asarray(lengths), jnp.int32(n_rows),
             jnp.asarray(kill.astype(bool)))
    want = {k: np.asarray(v) for k, v in out.items()}
    parser = TorchBatchParser(kernel_ab.SEEDED_LANES_FORMAT, kernel_ab.SEEDED_LANES_FIELDS,
                              device="cpu")
    ex = agg_device.AggregateExecutor(parser, AggregateSpec.parse(kernel_ab.SEEDED_LANES_OPS))
    tb = torch.from_numpy(buf)
    packed = ex.units(tb, torch.from_numpy(lengths))
    cls, lanes = kernels.agg_lanes(ex.tables, packed, tb, n_rows, torch.from_numpy(kill))
    counts, tiles = kernels.agg_reduce(ex.tables, cls, lanes)
    groups = [kernels.agg_group(lanes[row], tb, spans) for row, spans in ex.tables.groups_py]
    return (want, ex.tables, buf, packed.numpy(), n_rows, kill, cls.numpy(), lanes.numpy(),
            counts.numpy(), tiles.numpy(), groups)


def test_seeded_lanes_cls_and_sums_equal_the_reference():
    want, tables, _, _, _, _, cls, _, counts, tiles, _ = _lanes_run()
    np.testing.assert_array_equal(cls, want["cls"])
    assert int(counts[0]) == int(want["n_device"])
    assert all((cls == c).any() for c in range(4))
    for i, (p, part) in enumerate(zip(tables.op_plans, tables.op_partial)):
        if p.op.op == "sum":
            np.testing.assert_array_equal(tiles[part], want[f"op{i}_tiles"])


def _canonical(rows, buf, spans):
    """{key: count} of group rows."""
    out = {}
    for row in rows:
        if spans:
            cnt, r, s, ln = (int(x) for x in row)
            key = bytes(buf[r, s:s + ln])
        else:
            key, cnt = int(row[0]), int(row[1])
        out[key] = out.get(key, 0) + cnt
    return out


def test_seeded_lanes_groups_equal_the_reference():
    want, tables, buf, *_, groups = _lanes_run()
    n_ops = 0
    for i, (p, part) in enumerate(zip(tables.op_plans, tables.op_partial)):
        if p.op.op not in ("count_by", "time_bucket"):
            continue
        spans = tables.groups_py[part][1]
        g, n = (t.numpy() for t in groups[part])
        got = _canonical(g[:int(n[0])], buf, spans)
        assert int(n[0]) == len(got)           # no key split
        ref_n = int(want[f"op{i}_n"])
        assert got == _canonical(want[f"op{i}_groups"][:ref_n], buf, spans), p.op.field
        n_ops += 1
    assert n_ops == 14


def test_seeded_lanes_cover_every_kind():
    """Eight units, 16 lanes (a query-key lane, a probe unit's folded
    lanes, every null mode), every row kind of agg_lanes; byte counts of 1
    to 19 digits and a 20-digit one on counted rows' winners, and times
    inside and outside the device window; the dashboard's rows fetch their
    words in one round, the seeded ones in several."""
    _, tables, _, packed, n_rows, kill, cls, lanes, *_ = _lanes_run()
    U = len(tables.units_py)
    assert U == 8 and len(tables.lanes_py) == 16
    modes = {d[0] for d in tables.udesc_py}
    assert modes == {agg_device.UNIT_FOLD, agg_device.UNIT_SLOTS, agg_device.UNIT_QS}
    limbs = [ln for ln in tables.lanes_py if ln[0] == agg_device.LANE_LIMBS]
    assert {tables.udesc_py[u0 + u][1] for *_, u0 in limbs for u in range(U)
            if tables.udesc_py[u0 + u][0] == agg_device.UNIT_SLOTS} == {
        agg_device.NULL_PLAIN, agg_device.NULL_ZERO, agg_device.NULL_DASH}
    kinds = kernel_ab.lanes_kinds(tables, packed, n_rows, kill)
    assert all(v for k, v in kinds.items() if k != "walked_one_round"), kinds
    assert kill.any() and ((np.stack([packed[r] for r in tables.units_py]) & 4) != 0).any()
    # The BYTES lane (the first limbs lane): digit counts of the winner.
    row0 = np.stack([packed[r] for r in tables.units_py])
    winner = ((row0 & 1) != 0).argmax(0)
    u0 = limbs[0][3]
    ndig, big = np.zeros(LANES_B, np.int64), np.zeros(LANES_B, bool)
    for u in range(U):
        d = tables.udesc_py[u0 + u]
        if d[0] != agg_device.UNIT_SLOTS:
            continue
        at = winner == u
        for k, out in ((3, ndig), (6, big)):
            r, shift, bits = d[2 + 3 * k:5 + 3 * k]
            out[at] = (packed[r][at] >> shift) & ((1 << bits) - 1)
    won = ((row0 & 1) != 0).any(0) & (cls != 3)
    assert set(range(1, 20)) <= set(ndig[won & ~big].tolist()) and big[won].any()
    time_rows = [ln[1] for ln in tables.lanes_py if ln[0] == agg_device.LANE_TIME]
    assert len(time_rows) == 7 and (lanes[time_rows[0]] != agg_device.INT32_MAX).any()
    dash = agg_device.AggTables(TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu"),
                                AggregateSpec.parse(DASHBOARD_OPS))
    assert max(kernel_ab.lanes_fetch_words(dash)) <= kernel_ab.AGG_FETCH_CAP
    assert min(w for w in kernel_ab.lanes_fetch_words(tables) if w) > kernel_ab.AGG_FETCH_CAP


def test_lanes_cost_counts_each_rows_own_words():
    """lanes_cost, the bound of chip_smoke's agg_lanes lines, counted row
    by row: each unit's row 0, the host_kill and class bytes and the lane
    rows for every row; a walked row adds its winner's other words (each
    once) and the name bytes of the query-key slots as long as the key.
    With eight units that is far less than every unit's words for every
    row."""
    _, tables, _, packed, n_rows, kill, *_ = _lanes_run()
    walked, winner, _ = kernel_ab.lanes_walk(tables, packed, n_rows, kill)
    every, want = set(tables.units_py), 0
    for i in range(packed.shape[1]):
        words = set(tables.units_py)
        for kind, _, _, u0 in tables.lanes_py:
            for w in range(len(tables.units_py)):
                d = tables.udesc_py[u0 + w]
                if d[0] == agg_device.UNIT_SLOTS:
                    n = {agg_device.LANE_SPAN: 1, agg_device.LANE_LIMBS: 7}.get(kind, 4)
                    named = {d[2 + 3 * k] for k in range(n)}
                elif d[0] == agg_device.UNIT_QS:
                    named = {d[2]} | {d[5] + j for j in range(2 * d[6])}
                    if walked[i] and winner[i] == w:
                        for k in range(d[6]):
                            nl = (int(packed[d[5] + 2 * k, i]) >> 13) & 8191
                            want += d[9] if nl and nl == d[9] else 0
                else:
                    named = set()
                every |= named
                if walked[i] and winner[i] == w:
                    words |= named
        for o in tables.ovf_py:
            every |= {o[1], o[4], o[7], o[10]}
            if walked[i] and winner[i] == o[0]:
                words |= {o[1], o[4], o[7], o[10]}
        want += 4 * len(words) + 2 + 4 * tables.n_lane_rows
    got = kernel_ab.lanes_cost(tables, packed, n_rows, kill)[0]
    assert got == want
    assert 3 * got < packed.shape[1] * (4 * len(every) + 2 + 4 * tables.n_lane_rows)


@pytest.mark.parametrize("L,width,B", [(384, 121, 1500), (384, 16, 1200), (2048, 513, 900),
                                       (8191, 512, 200), (8191, 8191, 200)])
def test_seeded_unescape_equals_the_reference(L, width, B):
    buf, s, e = kernel_ab.seeded_unescape_case(B, L, width, seed=B + L + width)
    kinds = kernel_ab.unescape_kinds(buf, s, e, width)
    assert all(kinds[k] for k in ("chunks", "bytes", "backslash_free", "walked")), kinds
    staged = min(width, L) <= kernel_ab.UNESCAPE_STAGE_CAP
    assert kinds["staged" if staged else "direct"] == B
    out, out_len, exact = postproc.unescape_compact_spans_plain(
        torch.from_numpy(buf), torch.from_numpy(s), torch.from_numpy(e), width)
    r_out, r_len, r_exact = ref_postproc.unescape_compact_spans(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e), width)
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out).astype(np.uint8))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(r_len))
    np.testing.assert_array_equal(exact.numpy(), np.asarray(r_exact))
    assert exact.any() and not exact.all()
    assert (out_len.numpy() < np.clip(e - s, 0, min(width, L))).any()   # a byte dropped
