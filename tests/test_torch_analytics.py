"""The analytics pushdown of the port on the CPU, held to the JAX package.

Kernel level: the plain versions of ``agg_lanes`` and ``agg_reduce`` give
the reference's ``build_aggregate_fn`` outputs (``cls``, ``n_device``,
``op{i}_tiles``, ``op{i}_bins``) bit for bit on the same ``buf`` /
``lengths`` / ``host_kill`` at one padded B, and ``agg_group``'s plain
version the reference's groups in canonical ``{key bytes: count}`` form
(the reference may split one key in two groups; the port may not).  End
to end: ``TorchBatchParser(..., device="cpu").aggregate_batch`` equals
``TpuBatchParser.aggregate_batch`` over the whole batch (state, good /
bad counts, ``oracle_rows``, ``reject_items``), the rows its host oracle
rescues folded in, and ``needs_host`` is exactly the folded rows the
reference replays into its oracle.  Then the reference's own cases
(tests/test_analytics.py), each held to the port's row-path referee.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logparser_tpu.analytics.device import _limb_ge, _limbs_of, _sum_tiles, build_aggregate_fn
from logparser_tpu.analytics.spec import AggregateSpec as RefSpec
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.analytics import AggregateSpec, AggregateState
from logparser_tpu_torch.analytics import device as agg_device
from logparser_tpu_torch.analytics.spec import parse_aggregate_config, spec_tuple
from logparser_tpu_torch.analytics.state import merge_states
from logparser_tpu_torch.tools.demolog import (
    DASHBOARD_OPS,
    HEADLINE_FIELDS,
    QUERY_KEY_OPS,
    URI_CHAIN_FIELDS,
    aggregate_edge_lines,
    generate_combined_lines,
    representative_spec,
    uri_edge_lines,
)
from logparser_tpu_torch.tools.kernel_ab import SEEDED_B, SEEDED_HISTS, seeded_reduce_case
from logparser_tpu_torch.tpu import kernels
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import EDGE_LINES, assert_aggregate_matches_reference, reference_parser

pa = pytest.importorskip("pyarrow")

CASES = {
    "dashboard": ("combined", HEADLINE_FIELDS, DASHBOARD_OPS),
    "query_key": ("combined", URI_CHAIN_FIELDS, QUERY_KEY_OPS),
}


def _lines(case: str, n: int):
    if case == "query_key":
        lines = generate_combined_lines(n, seed=53) + uri_edge_lines()
    else:
        lines = generate_combined_lines(n, seed=42, garbage_fraction=0.01) + EDGE_LINES
    return lines + aggregate_edge_lines()


def _kernel_inputs(case: str, B: int, L: int):
    """(lines, buf, lengths, host_kill) padded to B rows at bucket L; at
    L = 8191 one line is exactly L bytes and one is truncated."""
    if L == 8191:
        lines = _lines(case, 20)
        head = lines[0]
        pad = L - len(head.encode())
        lines += [head.replace('"GET ', '"GET /' + "w" * (pad - 1), 1),
                  head.replace('"GET ', '"GET /' + "w" * (pad + 500), 1)]
    else:
        lines = _lines(case, B - 60)
    buf, lengths, overflow = encode_batch(lines, line_len=L)
    n = len(lines)
    assert n < B and buf.shape[1] == L
    buf = np.pad(buf, ((0, B - n), (0, 0)))
    lengths = np.pad(lengths, (0, B - n))
    host_kill = np.zeros(B, dtype=np.uint8)
    host_kill[overflow] = 1
    return lines, buf, lengths, host_kill


@functools.lru_cache(maxsize=None)
def _kernel_run(case: str, B: int, L: int):
    """The reference's partials and the port's plain kernels' outputs on
    the same inputs (cached: the reference's compile is the cost)."""
    fmt, fields, ops = CASES[case]
    ref = TpuBatchParser(fmt, list(fields))
    fn, _ = build_aggregate_fn(ref, RefSpec.parse(ops))
    lines, buf, lengths, host_kill = _kernel_inputs(case, B, L)
    out = fn(jnp.asarray(buf), jnp.asarray(lengths), jnp.int32(len(lines)),
             jnp.asarray(host_kill.astype(bool)))
    want = {k: np.asarray(v) for k, v in out.items()}
    ex = agg_device.AggregateExecutor(TorchBatchParser(fmt, fields, device="cpu"),
                                      AggregateSpec.parse(ops))
    tb = torch.from_numpy(buf)
    packed = ex.units(tb, torch.from_numpy(lengths))
    cls, lanes = kernels.agg_lanes(ex.tables, packed, tb, len(lines),
                                   torch.from_numpy(host_kill))
    counts, tiles = kernels.agg_reduce(ex.tables, cls, lanes)
    groups = [kernels.agg_group(lanes[row], tb, spans) for row, spans in ex.tables.groups_py]
    return want, ex.tables, buf, cls.numpy(), counts.numpy(), tiles.numpy(), groups


SHAPES = [(512, 384), (4096, 384), (64, 8191)]
KERNEL_CASES = [("dashboard", B, L) for B, L in SHAPES] + [("query_key", 512, 384)]


@pytest.mark.parametrize("case,B,L", KERNEL_CASES)
def test_lanes_and_reduce_equal_the_reference(case, B, L):
    want, tables, _, cls, counts, tiles, _ = _kernel_run(case, B, L)
    np.testing.assert_array_equal(cls, want["cls"])
    assert int(counts[0]) == int(want["n_device"])
    assert (cls == 1).any() and (cls == 3).any()
    for i, (p, part) in enumerate(zip(tables.op_plans, tables.op_partial)):
        if p.op.op == "sum":
            np.testing.assert_array_equal(tiles[part], want[f"op{i}_tiles"])
        elif p.op.op == "histogram":
            ne, b0 = tables.hists_py[part][2], tables.hists_py[part][3]
            np.testing.assert_array_equal(counts[1 + b0:2 + b0 + ne], want[f"op{i}_bins"])


@pytest.mark.parametrize("selected", ["some", "none", "all"])
@pytest.mark.parametrize("B", SEEDED_B)
def test_reduce_plain_matches_reference_on_seeded_lanes(B, selected):
    """agg_reduce's plain version on the card tests' seeded lanes (limbs
    at 0, 1, 0xFFFF, 0x10000, 999,999; 2 sums, a histogram with an
    always-edge and one with 8 edges) against the reference's _sum_tiles
    and _limb_ge bins, at B around the 4,096-row tile and past it.  The
    reference tiles a padded batch: the lanes are padded to whole tiles
    with unselected rows.  Exact."""
    t, cls, lanes = seeded_reduce_case(B, seed=B, selected=selected)
    counts, tiles = (x.numpy() for x in kernels.agg_reduce(t, cls, lanes))
    tile, ntiles = agg_device.sum_tiling(B)
    la = lanes.numpy()
    pad = np.pad(la, ((0, 0), (0, ntiles * tile - B)), constant_values=-1)
    for si, row in enumerate(t.sums_py):
        want = _sum_tiles(jnp.asarray(pad[row] != -1),
                          tuple(jnp.asarray(pad[row + j]) for j in range(3)), ntiles * tile)
        np.testing.assert_array_equal(tiles[si], np.asarray(want))
    assert int(counts[0]) == int((cls.numpy() == 0).sum())
    for (row, edges), (_, _, ne, b0) in zip(SEEDED_HISTS, t.hists_py):
        a, b, c = (jnp.asarray(la[row + j]) for j in range(3))
        bin_of = jnp.zeros(B, dtype=jnp.int32)
        for e in edges:
            ge = jnp.ones(B, dtype=bool) if e <= 0 else _limb_ge(a, b, c, *_limbs_of(e))
            bin_of = bin_of + ge.astype(jnp.int32)
        sel = a != -1
        want = [int(jnp.sum(sel & (bin_of == k))) for k in range(ne + 1)]
        np.testing.assert_array_equal(counts[1 + b0:2 + b0 + ne], want)
    if selected == "none":
        assert not counts[1:].any() and not tiles.any()


def _canonical(rows, buf, spans):
    """{key: count} of group rows; the port's keys must be distinct."""
    out = {}
    for row in rows:
        if spans:
            cnt, r, s, ln = (int(x) for x in row)
            key = bytes(buf[r, s:s + ln])
        else:
            key, cnt = int(row[0]), int(row[1])
        out[key] = out.get(key, 0) + cnt
    return out


@pytest.mark.parametrize("case,B,L", KERNEL_CASES)
def test_groups_equal_the_reference(case, B, L):
    want, tables, buf, _, _, _, groups = _kernel_run(case, B, L)
    for i, (p, part) in enumerate(zip(tables.op_plans, tables.op_partial)):
        if p.op.op not in ("count_by", "top_k", "time_bucket"):
            continue
        spans = tables.groups_py[part][1]
        g, n = (t.numpy() for t in groups[part])
        got = _canonical(g[:int(n[0])], buf, spans)
        assert int(n[0]) == len(got)           # no key split
        ref_n = int(want[f"op{i}_n"])
        assert got == _canonical(want[f"op{i}_groups"][:ref_n], buf, spans)
        assert ref_n >= len(got)


# ---------------------------------------------------------------------------
# End to end against TpuBatchParser.aggregate_batch.
# ---------------------------------------------------------------------------


def test_dashboard_matches_the_reference():
    lines = _lines("dashboard", 2000)
    ours = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    out = assert_aggregate_matches_reference(reference_parser("combined", HEADLINE_FIELDS), ours,
                                   lines, DASHBOARD_OPS)
    assert out.device_rows > 0.95 * len(lines)
    assert out.fold_rows >= 4 and len(out.needs_host) >= 1
    # Partials only: the class plane and a few KB against 168 B a row.
    assert out.d2h_bytes * 10 <= out.row_path_d2h_bytes
    (top,) = [d for d in out.state.summary() if d["op"] == "top_k"]
    assert len(top["values"]) == 5


def test_near_unique_ip_count_by_matches_the_reference():
    lines = _lines("dashboard", 2000)
    ours = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    spec = representative_spec(ours)
    assert spec.ops[1].field == "IP:connection.client.host"
    out = assert_aggregate_matches_reference(reference_parser("combined", HEADLINE_FIELDS), ours,
                                   lines, [op.as_dict() for op in spec.ops])
    assert len(out.state.data[1]) > 1500


def test_query_key_lane_matches_the_reference():
    # An AggregateSpec instance skips validate_for: the reference reaches
    # its _qs_key_lane this way.  The fold replay may grow the query-
    # string slots, so both parsers are fresh.
    # No URI edge lines here: their 200-parameter line would regrow the
    # reference to 128 slots, one compile per doubling.
    lines = generate_combined_lines(1500, seed=53) + aggregate_edge_lines() + [
        '1.2.3.4 - - [01/Jan/2026:10:00:00 +0000] "GET /s?Q=Up&x=1&q=last HTTP/1.1" 200 5 "-" "u"',
        '1.2.3.4 - - [01/Jan/2026:10:00:00 +0000] "GET /s?q=a+b HTTP/1.1" 200 5 "-" "u"',
        '1.2.3.4 - - [01/Jan/2026:10:00:00 +0000] "GET /s?q%41=1&q=z HTTP/1.1" 200 5 "-" "u"',
    ]
    ours = TorchBatchParser("combined", URI_CHAIN_FIELDS, device="cpu")
    spec = AggregateSpec.parse(QUERY_KEY_OPS)
    with pytest.raises(ValueError, match="string"):
        spec.validate_for(ours)
    out = assert_aggregate_matches_reference(TpuBatchParser("combined", URI_CHAIN_FIELDS), ours,
                                   lines, spec)
    q = out.state.data[0]
    assert q.get(b"last") == 1 and q.get(b"a b") == 1


# ---------------------------------------------------------------------------
# The reference's cases (tests/test_analytics.py), against the port's own
# row-path referee.
# ---------------------------------------------------------------------------

FIELDS = [
    "IP:connection.client.host",
    "TIME.EPOCH:request.receive.time.epoch",
    "STRING:request.status.last",
    "BYTES:response.body.bytes",
]
OPS = [
    {"op": "count"},
    {"op": "count_by", "field": "STRING:request.status.last"},
    {"op": "top_k", "field": "IP:connection.client.host", "k": 3},
    {"op": "sum", "field": "BYTES:response.body.bytes"},
    {"op": "histogram", "field": "BYTES:response.body.bytes",
     "edges": [1000, 100000, 10000000]},
    {"op": "time_bucket", "field": "TIME.EPOCH:request.receive.time.epoch", "width_s": 3600},
]


def parser():
    return TorchBatchParser("combined", FIELDS, device="cpu")


def spec():
    return parse_aggregate_config(OPS)


def combined_line(ip="1.2.3.4", ts="01/Jan/2026:10:00:00 +0000", status="200",
                  nbytes="512"):
    return f'{ip} - - [{ts}] "GET /x HTTP/1.1" {status} {nbytes} "-" "ua"'.encode()


def referee(p, lines, sp):
    state = AggregateState(sp)
    state.update_from_result(p.parse_batch(lines))
    return state


def corpus(n=512, garbage=True):
    lines = generate_combined_lines(n, seed=7, garbage_fraction=0.0)
    if garbage:
        lines[5] = "total garbage ! matches nothing ::"
        lines[n - 9] = ""
    return lines


def test_aggregate_batch_matches_referee():
    p, sp, lines = parser(), spec(), corpus()
    out = p.aggregate_batch(lines, sp)
    assert out.state == referee(p, lines, sp)
    assert out.lines_read == len(lines)
    assert out.good_lines + out.bad_lines == len(lines)
    assert out.bad_lines == 2 and out.reject_rows.tolist() == [5, len(lines) - 9]
    assert out.device_rows > 0.9 * len(lines)
    assert 0 < out.d2h_bytes < 64 * len(lines)


@pytest.mark.parametrize("row,line", [
    (3, combined_line(nbytes="9" * 20)),                        # Long overflow
    (40, combined_line(ts="01/Jan/2050:00:00:00 +0000")),       # past 2037
    (41, combined_line(ts="13/Dec/1901:00:00:00 +0000")),       # before 1902
    (42, combined_line(nbytes="1" + "0" * 18)),                 # a full 19-digit frame
])
def test_forced_fold_rows_stay_exact(row, line):
    p, sp = parser(), spec()
    lines = corpus(n=128, garbage=False)
    lines[row] = line.decode()
    out = p.aggregate_batch(lines, sp)
    assert out.fold_rows == 1 and out.device_rows == len(lines) - 1
    assert out.state == referee(p, lines, sp)
    assert out.state.data[0] == len(lines)


def test_reject_row_is_counted_bad():
    p, sp = parser(), spec()
    lines = corpus(n=128, garbage=False)
    lines[17] = "total garbage ! matches nothing ::"
    out = p.aggregate_batch(lines, sp)
    assert out.bad_lines == 1 and out.reject_rows.tolist() == [17]
    assert out.fold_rows == 0
    assert out.state == referee(p, lines, sp)


def test_histogram_bisect_right_edges():
    """Bin b holds values with exactly b edges <= v."""
    p = parser()
    sp = parse_aggregate_config([
        {"op": "histogram", "field": "BYTES:response.body.bytes", "edges": [1000, 100000]},
    ])
    values = [999, 1000, 1001, 99999, 100000, 100001]
    lines = [combined_line(nbytes=str(v)) for v in values]
    out = p.aggregate_batch(lines, sp)
    assert out.state == referee(p, lines, sp)
    assert out.state.data[0] == [1, 3, 2]


def test_time_bucket_hour_boundaries():
    p = parser()
    sp = parse_aggregate_config([
        {"op": "time_bucket", "field": "TIME.EPOCH:request.receive.time.epoch",
         "width_s": 3600},
    ])
    lines = [
        combined_line(ts="01/Jan/2026:10:59:59 +0000"),
        combined_line(ts="01/Jan/2026:11:00:00 +0000"),
        combined_line(ts="01/Jan/2026:11:59:59 +0000"),
        combined_line(ts="31/Dec/1969:23:59:59 +0000"),   # a negative bucket
    ]
    out = p.aggregate_batch(lines, sp)
    assert out.state == referee(p, lines, sp)
    assert sorted(out.state.data[0].values()) == [1, 1, 2]
    assert -1 in out.state.data[0]


def test_merge_associativity():
    p, sp, lines = parser(), spec(), corpus(n=300)
    parts = [referee(p, lines[a:b], sp) for a, b in ((0, 70), (70, 71), (71, 300))]
    left = merge_states(sp, parts)
    right = AggregateState(sp)
    tail = merge_states(sp, parts[1:])
    right.merge(parts[0])
    right.merge(tail)
    assert left == right == referee(p, lines, sp)
    with pytest.raises(ValueError, match="spec mismatch"):
        right.merge(AggregateState(parse_aggregate_config([{"op": "count"}])))


def test_wire_roundtrip_and_accumulate():
    p, sp, lines = parser(), spec(), corpus(n=200)
    state = p.aggregate_batch(lines, sp).state
    table = state.to_arrow()
    assert table.column_names == ["op", "key", "value"]
    again = AggregateState.from_ipc_bytes(state.to_ipc_bytes(), sp)
    assert again == state
    twice = AggregateState(sp)
    twice.merge(AggregateState.from_arrow(table, sp))
    twice.merge(AggregateState.from_arrow(table, sp))
    expect = AggregateState(sp)
    expect.merge(state)
    expect.merge(state)
    assert twice == expect
    bad = pa.table({"op": pa.array([99], type=pa.int32()),
                    "key": pa.array([b""], type=pa.binary()),
                    "value": pa.array(["1"], type=pa.string())})
    with pytest.raises(ValueError, match="bad op index"):
        AggregateState.from_arrow(bad, sp)


def test_topk_summary_selection_deterministic():
    sp = parse_aggregate_config([{"op": "top_k", "field": "IP:connection.client.host", "k": 2}])
    state = AggregateState(sp)
    state.data[0] = {b"b": 5, b"a": 5, b"c": 9, b"d": 1}
    (d,) = state.summary()
    assert d["values"] == [["c", 9], ["a", 5]]
    assert len(state._rows()) == 4


def test_stream_equals_per_batch_merges():
    p, sp, lines = parser(), spec(), corpus()
    chunks = [lines[i:i + 128] for i in range(0, len(lines), 128)]
    outcomes = list(p.aggregate_batch_stream(chunks, sp))
    assert len(outcomes) == len(chunks)
    total = merge_states(sp, (o.state for o in outcomes))
    assert total == merge_states(sp, (p.aggregate_batch(c, sp).state for c in chunks))
    assert total == referee(p, lines, sp)


@pytest.mark.parametrize("ops,err", [
    ([{"op": "count_by", "field": "NOSUCH:field"}], "not in the"),
    ([{"op": "sum", "field": "STRING:request.status.last"}], "numeric"),
    ([{"op": "count_by", "field": "BYTES:response.body.bytes"}], "string"),
])
def test_validate_for_rejects(ops, err):
    with pytest.raises(ValueError, match=err):
        parser().aggregate_batch(corpus(n=8), ops)


def test_spec_canonical_roundtrip():
    sp = spec()
    key = sp.canonical_key()
    assert AggregateSpec.from_canonical(key).canonical_key() == key == spec_tuple(sp)
    assert parse_aggregate_config(sp) is sp and parse_aggregate_config(None) is None


def test_executor_is_cached_per_spec_and_slot_count():
    p = TorchBatchParser("combined", URI_CHAIN_FIELDS, device="cpu")
    sp = parse_aggregate_config([{"op": "count"}])
    ex = p._agg_executor(sp)
    assert p._agg_executor(sp) is ex
    assert p._grow_csr_slots()
    assert p._agg_executor(sp) is not ex


def test_truncated_and_overflowing_lines_fold():
    """A line past the 8191-byte cap (host_kill) and a query string past
    the slot cap (CSR overflow) fold; the aggregate does not regrow."""
    p = TorchBatchParser("combined", URI_CHAIN_FIELDS, device="cpu")
    sp = parse_aggregate_config([{"op": "count"}])
    base = '1.2.3.4 - - [01/Jan/2026:10:00:00 +0000] "GET {} HTTP/1.1" 200 5 "-" "u"'
    lines = [base.format("/a"), base.format("/" + "z" * 9000),
             base.format("/p?" + "&".join(f"k{i}=v" for i in range(20)))]
    ex = p._agg_executor(sp)
    cls, _ = kernels.agg_lanes(
        ex.tables, ex.units(*(torch.from_numpy(a) for a in encode_batch(lines)[:2])),
        torch.from_numpy(encode_batch(lines)[0]), 3,
        torch.tensor([0, 1, 0], dtype=torch.uint8))
    assert cls.tolist() == [0, 1, 1]
    out = p.aggregate_batch(lines, sp)
    assert out.fold_rows == 2 and out.needs_host.tolist() == [1]
    # The truncated line is the host oracle's, and valid: all three count.
    assert out.state.data[0] == 3 and out.reject_items == []


def test_empty_batch():
    out = parser().aggregate_batch([], spec())
    assert out.lines_read == 0 and out.state == AggregateState(spec())


def test_wrappers_pass_the_c_signature(monkeypatch):
    """Routed to the kernel (as a CUDA tensor is), each wrapper launches
    with as many arguments as its C entry point takes, the stream last;
    here the launch is recorded instead of made."""
    p = parser()
    ex = p._agg_executor(spec())
    buf, lengths, _ = encode_batch(corpus(n=16))
    tb = torch.from_numpy(buf)
    packed = ex.units(tb, torch.from_numpy(lengths))
    calls = []

    def record(name, device, *args):
        calls.append(name)
        assert len(args) + 1 == len(kernels._SIGNATURES[name]), name

    monkeypatch.setattr(kernels, "_route", lambda t: True)
    monkeypatch.setattr(kernels, "_launch", record)
    cls, lanes = kernels.agg_lanes(ex.tables, packed, tb, 16, torch.zeros(16, dtype=torch.uint8))
    kernels.agg_reduce(ex.tables, cls, lanes)
    kernels.agg_group(lanes[0], tb, True)
    assert calls == ["agg_lanes", "agg_reduce", "agg_group"]


# ---------------------------------------------------------------------------
# kernel_ab's seeded grouping lanes (the inputs agg_group_seeded_* feeds the
# card) against the reference's _group_spans / _group_ints.
# ---------------------------------------------------------------------------

from logparser_tpu.analytics.device import _group_ints, _group_spans  # noqa: E402
from logparser_tpu_torch.tools.kernel_ab import (  # noqa: E402
    GROUP_CARDINALITIES,
    group_map,
    seeded_group_case,
)


def _reference_groups(rows, n, buf, spans):
    """The reference's groups merged by full key, as the host merges them
    (a span key read as the reference reads it: clamped to L - 1)."""
    L = buf.shape[1]
    out = {}
    for row in rows[:n]:
        if spans:
            cnt, r, s, ln = (int(x) for x in row)
            key = (ln, bytes(buf[r, np.minimum(np.arange(s, s + ln), L - 1)]))
        else:
            key, cnt = int(row[0]), int(row[1])
        out[key] = out.get(key, 0) + cnt
    return out


@pytest.mark.parametrize("distinct,selected", [(d, "some") for d in GROUP_CARDINALITIES]
                         + [(24, "all"), (24, "none")])
def test_seeded_group_lanes_match_the_reference(distinct, selected):
    """Both lanes of seeded_group_case through the plain agg_group and the
    reference: equal key -> count maps, the port's keys distinct and its
    n_groups their number."""
    B = 4095
    buf, span_lane, int_lane = seeded_group_case(B, distinct, seed=B + (distinct or 0),
                                                 selected=selected)
    tb = torch.from_numpy(buf)
    for lane, spans in ((span_lane, True), (int_lane, False)):
        got = agg_device.agg_group_plain(
            torch.from_numpy(lane), tb, spans,
            torch.empty((B, 4 if spans else 2), dtype=torch.int32),
            torch.empty(1, dtype=torch.int32))
        port = group_map(*got, buf, spans)
        assert int(got[1][0]) == len(port)
        if spans:
            sel = lane != -1
            n, rows = _group_spans(jnp.asarray(buf), jnp.asarray(sel),
                                   jnp.asarray(lane & 8191), jnp.asarray((lane >> 13) & 8191),
                                   B, buf.shape[1])
        else:
            sel = lane != agg_device.INT32_MAX
            n, rows = _group_ints(jnp.asarray(lane), jnp.asarray(sel), B)
        want = _reference_groups(np.asarray(rows), int(n), buf, spans)
        assert port == want
        assert sum(port.values()) == int(sel.sum())
        if selected == "none":
            assert not port
