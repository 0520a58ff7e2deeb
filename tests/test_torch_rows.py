"""The port's full packed output equals the reference executor's, bit for
bit.

``UnitsExecutor`` of logparser_tpu_torch (on the CPU: every kernel's
plain version) over the units carried across from a JAX TpuBatchParser,
against ``pipeline.build_units_jnp_fn(units, view_specs)`` on the same
``[B, L]`` buffer: all ``K`` unit rows and the ``4V`` view rows.  A
mismatch names its (field, component) through ``PackedLayout.slots``.
"""
import numpy as np
import pytest
import torch

from logparser_tpu.tools.demolog import HEADLINE_FIELDS, generate_combined_lines
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.tools.demolog import URI_CHAIN_FIELDS, uri_edge_lines
from logparser_tpu_torch.tpu import kernels, pipeline
from logparser_tpu_torch.tpu.carry import units_from_reference
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import (
    corpus,
    first_mismatch,
    jax_unit_plain,
    reference_packed,
    reference_parser,
)

CONFIGS = [
    ("combined", HEADLINE_FIELDS),
    ("common", ["IP:connection.client.host", "NUMBER:connection.client.logname",
                "BYTES:response.body.bytes", "STRING:request.status.last",
                "TIME.EPOCH:request.receive.time.epoch"]),
    ("combined", ["HTTP.PROTOCOL_VERSION:request.firstline.protocol",
                  "BYTESCLF:response.body.bytes",
                  "TIME.YEAR:request.receive.time.year",
                  "HTTP.URI:request.referer"]),
    # Two formats: stacked rows, the winner by registration priority and
    # the contested rule in the view rows.
    ("combined\ncommon", ["IP:connection.client.host", "BYTES:response.body.bytes",
                          "HTTP.URI:request.firstline.uri",
                          "TIME.EPOCH:request.receive.time.epoch"]),
    ("common\ncombined", ["IP:connection.client.host",
                          "STRING:request.status.last"]),
    # A separator longer than one 32-bit plane word.
    ("%h " + "=" * 40 + ' %u %t "%r" %>s %b',
     ["IP:connection.client.host", "BYTES:response.body.bytes",
      "TIME.EPOCH:request.receive.time.epoch"]),
    # The URI chain: two URI splits (first line, referer), two query-string
    # CSR groups, the protocol split and the referer's port.
    ("combined", URI_CHAIN_FIELDS),
    # Path and query only: the URI split without the authority parts.
    ("combined\ncommon", ["HTTP.PATH:request.firstline.uri.path",
                          "STRING:request.firstline.uri.query.*",
                          "HTTP.REF:request.firstline.uri.ref",
                          "HTTP.QUERYSTRING:request.referer.query",
                          "STRING:request.referer.query.q"]),
]


def _lines(seed):
    lines = corpus(seed)
    common = [ln.rsplit(' "', 2)[0] for ln in generate_combined_lines(40, seed=seed)]
    # common-format lines, so the two-format configs see both winners, and
    # the same with the long separator in place of %l.
    lines += common
    lines += [ln.replace(" - ", " " + "=" * 40 + " ", 1) for ln in common]
    lines += uri_edge_lines() + generate_combined_lines(60, seed=53)
    return lines


@pytest.mark.parametrize("fmt,fields", CONFIGS)
def test_packed_rows_match_reference(fmt, fields):
    ref = reference_parser(fmt, fields)
    specs = ref._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in ref.units])
    ex = pipeline.UnitsExecutor(units, specs)
    for seed in (21, 22):
        buf, lengths, _ = encode_batch(_lines(seed), line_len=384)
        want = reference_packed(ref.units, specs, buf, lengths)
        got = ex(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
        assert first_mismatch(ref.units, specs, got, want) is None


def test_own_compile_packs_like_the_reference():
    """The port's own TorchBatchParser executor (not the carried units)."""
    ref = reference_parser("combined", HEADLINE_FIELDS)
    ours = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    buf, lengths, _ = encode_batch(_lines(23))
    want = reference_packed(ref.units, ref._view_specs(), buf, lengths)
    got = ours.executor(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(ref.units, ref._view_specs(), got, want) is None
    assert got.shape == (14 + 4 * 7, buf.shape[0])


def test_view_rows_merge_the_winner():
    ref = reference_parser("combined\ncommon", ["IP:connection.client.host"])
    specs = ref._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in ref.units])
    ex = pipeline.UnitsExecutor(units, specs)
    buf, lengths, _ = encode_batch(_lines(24))
    got = ex(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    K = sum(u.layout.n_rows for u in units)
    live = (got[K] >> pipeline.VIEW_LIVE_SHIFT) & 1
    valid = (got[units[0].row_offset] & 1) | (got[units[1].row_offset] & 1)
    assert live.any() and (live <= valid).all()


def test_pack_rows_wrapper_checks_its_inputs():
    ours = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    pack = ours.executor.pack
    B = 8
    comps = torch.zeros((ours.executor.n_comp, B), dtype=torch.int32)
    flags = torch.zeros((1, B), dtype=torch.int32)
    out = kernels.pack_rows(pack, flags, comps)
    assert out.shape == (ours.executor.n_out_rows, B) and not out.any()
    with pytest.raises(TypeError):
        kernels.pack_rows(pack, flags, comps.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.pack_rows(pack, flags, comps[:3])
    with pytest.raises(ValueError):
        kernels.pack_rows(pack, torch.zeros((2, B), dtype=torch.int32), comps)


def test_stage_wrappers_check_their_inputs():
    ours = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu")
    unit = ours.executor.unit_tables[0]
    buf, lengths, _ = encode_batch(generate_combined_lines(4, seed=1))
    b, n = torch.from_numpy(buf), torch.from_numpy(lengths)
    starts, ends, _ = kernels.split(unit.split, b, n)
    with pytest.raises(TypeError):
        kernels.split(unit.split, b.to(torch.int32), n)
    with pytest.raises(ValueError):                               # bucket > 8191
        kernels.split(unit.split, torch.zeros((4, 8192), dtype=torch.uint8), n)
    # The split gathers no window: a bucket under 32 bytes is its to take,
    # while the stages, which gather up to 31 bytes, still reject it.
    s16, e16, _ = kernels.split(unit.split, b[:, :16].contiguous(), n.clamp(max=16))
    assert s16.shape == (unit.split.n_tok, 4) and e16.shape == s16.shape
    with pytest.raises(ValueError):                               # bucket < 32
        kernels.span_stages(unit.stages, b[:, :16].contiguous(), s16, e16)
    with pytest.raises(ValueError):
        kernels.span_stages(unit.stages, b, starts[:2], ends[:2])
    with pytest.raises(ValueError):
        kernels.timestamp(unit.ts[0], b, starts.t().contiguous(), ends)
    with pytest.raises(ValueError):
        kernels.span_stages(unit.stages, b, starts, ends,
                            out=torch.empty((1, 4), dtype=torch.int32))
    out = kernels.span_stages(unit.stages, b, starts, ends)
    assert out.shape == (unit.stages.n_out, 4)
    assert np.array_equal(kernels.timestamp(unit.ts[0], b, starts, ends)[3].numpy(),
                          np.ones(4, dtype=np.int32))



def test_seeded_pack_lines_match_reference():
    """The pack_rows kernel's seeded lines (tools.kernel_ab.
    seeded_pack_case: eight formats, so MAX_UNITS units, every
    line-constraint kind, contested lines, view fields that seven units
    decode) through the port's executor equal the reference executor's
    packed rows."""
    from logparser_tpu_torch.tools.kernel_ab import (SEEDED_PACK_FIELDS, SEEDED_PACK_FORMAT,
                                                     contested_lines, seeded_pack_case)

    ref = reference_parser(SEEDED_PACK_FORMAT, SEEDED_PACK_FIELDS)
    specs = ref._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in ref.units])
    ex = pipeline.UnitsExecutor(units, specs)
    assert ex.pack.U == pipeline.MAX_UNITS
    assert {kind for _, kind in ex.pack.cons_py} == set(range(5))
    assert max(sum(v >= 0 for v in row) for row in ex.pack.view_of_py) >= 7
    buf, lengths, _ = encode_batch(seeded_pack_case(600, seed=7))
    want = reference_packed(ref.units, specs, buf, lengths)
    got = ex(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(ref.units, specs, got, want) is None
    assert contested_lines(got, ex.pack) > 0


@pytest.mark.parametrize("config", ["headline", "two_formats", "uri_chain", "nginx_timing",
                                    "seeded_pack"])
def test_view_index_describes_the_view_entries(config):
    """PackTables.view_of, the index pack_rows walks instead of every view
    entry, names for each (view field, unit) exactly the entry of
    ``views_py`` with that field and unit (-1 where none); repeated
    entries, where a unit decodes a field twice, are equal."""
    from logparser_tpu_torch.tools import demolog
    from logparser_tpu_torch.tools.kernel_ab import SEEDED_PACK_FIELDS, SEEDED_PACK_FORMAT

    fmt, fields = {
        "headline": ("combined", HEADLINE_FIELDS), "two_formats": CONFIGS[3],
        "uri_chain": ("combined", URI_CHAIN_FIELDS),
        "nginx_timing": (demolog.NGINX_TIMING_FORMAT, demolog.NGINX_TIMING_FIELDS),
        "seeded_pack": (SEEDED_PACK_FORMAT, SEEDED_PACK_FIELDS)}[config]
    pack = TorchBatchParser(fmt, fields, device="cpu").executor.pack
    assert len(pack.view_of_py) == pack.V
    for vi, row in enumerate(pack.view_of_py):
        assert len(row) == pack.U
        for ui, e in enumerate(row):
            match = [i for i, (v, u, _, _) in enumerate(pack.views_py) if (v, u) == (vi, ui)]
            assert (e == -1) if not match else (e == match[-1]), (vi, ui)
            assert all(pack.views_py[i] == pack.views_py[match[-1]] for i in match)
    assert pack.view_of.tolist()[:pack.V] == pack.view_of_py
