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
]


def _lines(seed):
    lines = corpus(seed)
    common = [ln.rsplit(' "', 2)[0] for ln in generate_combined_lines(40, seed=seed)]
    # common-format lines, so the two-format configs see both winners, and
    # the same with the long separator in place of %l.
    lines += common
    lines += [ln.replace(" - ", " " + "=" * 40 + " ", 1) for ln in common]
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
    with pytest.raises(ValueError):
        kernels.split(unit.split, b[:, :16].contiguous(), n)      # bucket < 32
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
