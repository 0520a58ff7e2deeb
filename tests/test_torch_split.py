"""Kernel 1's plain version equals the reference split.

``pipeline.compute_split`` of logparser_tpu_torch (dense masks, the CPU
version of the ``split`` kernel) against logparser_tpu's bitplane
``compute_split`` on the same ``[B, L]`` buffers: every token cursor, the
validity, plausibility and escape-parity bits, exactly.  Format shapes
cover a leading literal, until_lit chains, a to_end tail with a bounded
charset, escaped quotes in final and non-final quoted fields.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.tpu import pipeline as ref_pipeline
from logparser_tpu.tpu import runtime as ref_runtime
from logparser_tpu.tools.demolog import HEADLINE_FIELDS
from logparser_tpu_torch.tpu import kernels, pipeline
from logparser_tpu_torch.tpu.carry import (
    program_from_plain,
    unit_to_plain,
    units_from_reference,
)
from logparser_tpu_torch.tools.kernel_ab import SPLIT_WIDTHS, seeded_split_case
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import (
    corpus,
    jax_program_plain,
    jax_unit_plain,
    reference_parser,
)

FORMATS = [
    ("combined", HEADLINE_FIELDS),
    ('[%t] "%r" %>s', ["TIME.EPOCH:request.receive.time.epoch",
                       "STRING:request.status.last"]),
    ('%h %l %u %t "%r" %>s %b', ["IP:connection.client.host",
                                 "BYTES:response.body.bytes"]),
    ('"%{User-Agent}i" %h', ["IP:connection.client.host"]),
]


def _reference_split(program, buf, lengths):
    starts, ends, valid, plausible, esc = ref_pipeline.compute_split(
        program, jnp.asarray(buf), jnp.asarray(lengths), need_plausible=True
    )
    n = len(program.tokens)
    esc = np.zeros(buf.shape[0], bool) if esc is None else np.asarray(esc)
    return (np.stack([np.asarray(s) for s in starts]).reshape(n, -1),
            np.stack([np.asarray(e) for e in ends]).reshape(n, -1),
            np.asarray(valid), np.asarray(plausible), esc)


def _assert_split_equal(program, buf, lengths):
    ref_s, ref_e, ref_v, ref_p, ref_esc = _reference_split(program, buf, lengths)
    ours = program_from_plain(jax_program_plain(program))
    s, e, flags = pipeline.compute_split(
        ours, torch.from_numpy(buf), torch.from_numpy(lengths)
    )
    flags = flags.numpy()
    for t in range(len(program.tokens)):
        np.testing.assert_array_equal(s[t].numpy(), ref_s[t], err_msg=f"token {t} start")
        np.testing.assert_array_equal(e[t].numpy(), ref_e[t], err_msg=f"token {t} end")
    np.testing.assert_array_equal((flags & pipeline.SPLIT_VALID) != 0, ref_v, "valid")
    np.testing.assert_array_equal((flags & pipeline.SPLIT_PLAUSIBLE) != 0, ref_p,
                                  "plausible")
    np.testing.assert_array_equal((flags & pipeline.SPLIT_ESC_HIT) != 0, ref_esc,
                                  "esc_hit")
    return flags


@pytest.mark.parametrize("fmt,fields", FORMATS)
@pytest.mark.parametrize("seed", [7, 11])
def test_split_matches_reference_on_corpus(fmt, fields, seed):
    program = reference_parser(fmt, fields).units[0].program
    buf, lengths, _ = encode_batch(corpus(seed))
    flags = _assert_split_equal(program, buf, lengths)
    if fmt == "combined":
        # The corpus exercises every verdict.
        assert ((flags & 1) != 0).any() and ((flags & 1) == 0).any()
        assert ((flags & 4) != 0).any()
        assert (((flags & 2) != 0) & ((flags & 1) == 0)).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_matches_reference_on_random_buffers(seed):
    """Random bytes drawn from the separator alphabet, lengths anywhere in
    [0, L], and garbage past each line's length (the escape-parity scan
    reads the whole row)."""
    rng = np.random.default_rng(seed)
    program = reference_parser("combined", HEADLINE_FIELDS).units[0].program
    alphabet = np.frombuffer(b' "[]-\\0123456789abc:/+', dtype=np.uint8)
    B, L = 256, 96
    buf = rng.choice(alphabet, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    _assert_split_equal(program, buf, lengths)


def test_split_matches_reference_on_line_length_edges():
    program = reference_parser("combined", HEADLINE_FIELDS).units[0].program
    line = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 0 "x" "'
    lines = [line + "u" * (n - len(line) - 1) + '"' for n in (126, 127, 128)]
    buf, lengths, _ = encode_batch(lines)       # L = 128: the last line fills it
    assert buf.shape[1] == 128 and lengths[-1] == 128
    flags = _assert_split_equal(program, buf, lengths)
    assert ((flags & 1) != 0).all()


def test_encode_batch_matches_reference():
    lines = corpus(5)
    ours = encode_batch(lines)
    ref = ref_runtime.encode_batch(lines)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2] == ref[2]


def test_split_wrapper_runs_the_plain_version_on_cpu():
    units = units_from_reference(
        [jax_unit_plain(u) for u in reference_parser("combined", HEADLINE_FIELDS).units]
    )
    tables = pipeline.SplitTables(units[0].program)
    buf, lengths, _ = encode_batch(corpus(3))
    before = kernels.split.launches
    s, e, f = kernels.split(tables, torch.from_numpy(buf), torch.from_numpy(lengths))
    want = pipeline.compute_split(units[0].program, torch.from_numpy(buf),
                                  torch.from_numpy(lengths))
    assert torch.equal(s, want[0]) and torch.equal(e, want[1]) and torch.equal(f, want[2])
    assert kernels.split.launches == before  # the CPU never counts a launch
    assert unit_to_plain(units[0])["program"]["max_lit_len"] == 3


def test_split_tables_encode_the_program():
    program = reference_parser("combined", HEADLINE_FIELDS).units[0].program
    t = pipeline.SplitTables(program_from_plain(jax_program_plain(program)))
    ops = t.ops.numpy()
    assert ops.shape == (len(program.ops), pipeline.OPW)
    # 4 separator bytes (' ', '"', '[', ']') + 3 bounded charsets.
    assert t.n_planes == 7 and t.has_esc
    # The user-agent op is the final quoted op: escape mode 1 (exact).
    assert ops[-1, 6] == 1 and ops[4, 6] == 2
    cls = t.cls.numpy().view(np.uint32)
    for b in b' "[]':
        assert bin(int(cls[b])).count("1") >= 1


NUL_FORMAT = "%h\x00%u\x00%>s"
NUL_FIELDS = ["IP:connection.client.host", "STRING:connection.client.user",
              "STRING:request.status.last"]


@pytest.mark.parametrize("L", SPLIT_WIDTHS)
def test_split_matches_reference_at_every_kernel_width(L):
    """The card tests' inputs (kernel_ab.seeded_split_case) at each of
    their widths, 1 to 8,191: backslash runs that end before a quote
    across word and 32-word boundaries, lengths 0, L and between.  The
    reference runs its bitplane split; for the NUL-separated program its
    own dispatch to compute_split_dense.  Exact."""
    B = 96 if L <= 384 else 24
    for fmt, fields, nul in (("combined", HEADLINE_FIELDS, False),
                             (NUL_FORMAT, NUL_FIELDS, True)):
        program = reference_parser(fmt, fields).units[0].program
        buf, lengths = seeded_split_case(B, L, seed=L, nul=nul)
        _assert_split_equal(program, buf, lengths)


_COMBINED = re.compile(r'^(\S+) (\S+) (\S+) \[([^\]]*)\] "(.*?)" (\S+) (\S+) "(.*?)" "(.*)"$')
# Each format with the generated combined lines recast to its shape.
PLAUSIBLE_FORMATS = [
    ("combined", HEADLINE_FIELDS, "{0}"),
    ('%h %l %u %t "%r" %>s %b', ["IP:connection.client.host"],
     '{1} {2} {3} [{4}] "{5}" {6} {7}'),
    ('[%t] "%r" %>s', ["STRING:request.status.last"], '[[{4}]] "{5}" {6}'),
    ('"%{User-Agent}i" %h', ["IP:connection.client.host"], '"{9}" {1}'),
    (NUL_FORMAT, NUL_FIELDS, "{1}\x00{3}\x00{6}"),
]


@pytest.mark.parametrize("fmt,fields,shape", PLAUSIBLE_FORMATS)
def test_valid_lines_are_plausible(fmt, fields, shape):
    """The split kernel skips the plausibility pass on a valid line and
    reports it plausible: the pass's cursor never passes the op
    program's, so each of its searches finds the program's separator or
    an earlier one.  The plain version, which runs the pass on every line,
    agrees on generated lines recast to the format, and on seeded
    buffers with backslash runs."""
    from logparser_tpu_torch import TorchBatchParser
    from logparser_tpu_torch.tools.demolog import generate_combined_lines

    lines = []
    for ln in generate_combined_lines(600, seed=3, garbage_fraction=0.05):
        m = _COMBINED.match(ln)
        lines.append(shape.format(ln, *m.groups()) if m else ln)
    tables = TorchBatchParser(fmt, fields, device="cpu").executor.unit_tables
    inputs = [encode_batch(lines)[:2]]
    inputs += [seeded_split_case(200, L, seed=L, nul=nul)
               for L in (33, 384, 1025) for nul in (False, True)]
    n_valid = 0
    for t in tables:
        for buf, lengths in inputs:
            _, _, flags = pipeline.compute_split(t.split.program, torch.from_numpy(buf),
                                                 torch.from_numpy(lengths))
            flags = flags.numpy()
            valid = (flags & pipeline.SPLIT_VALID) != 0
            assert not (valid & ((flags & pipeline.SPLIT_PLAUSIBLE) == 0)).any()
            n_valid += int(valid.sum())
    assert n_valid > 500
