"""mod_unique_id equals the reference.

The plain PyTorch ``parse_mod_unique_id`` (the CPU side of the ``muid``
kernel) against logparser_tpu's on numpy-seeded tokens and spans; the
reference's token list through ``TorchBatchParser(device="cpu")`` with
the reference's type remapping against ``TpuBatchParser`` (packed words,
``to_dict()``, ``needs_host``); the seeded edge tokens of
``tools.kernel_ab.seeded_muid_case`` (the ``muid`` kernel's card tests and
``chip_smoke.py`` hold the kernel to the plain version on the same
tokens); the known decodes; and the port's ``mod_unique_id.decode``
against the reference's dissector.  Every comparison is exact.
"""
import base64

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.dissectors.mod_unique_id import _decode_to_bytes as ref_decode
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.dissectors import mod_unique_id
from logparser_tpu_torch.tools.kernel_ab import (
    MUID_BAD_BYTES,
    MUID_TOKEN,
    seeded_muid_case,
    window_inside,
)
from logparser_tpu_torch.tpu import postproc
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import packed_mismatch

FMT = "%h %{unique_id}e %>s"
REMAP = {"server.environment.unique_id": "MOD_UNIQUE_ID"}
FIELDS = [
    "TIME.EPOCH:server.environment.unique_id.epoch",
    "IP:server.environment.unique_id.ip",
    "PROCESSID:server.environment.unique_id.processid",
    "COUNTER:server.environment.unique_id.counter",
    "THREAD_INDEX:server.environment.unique_id.threadindex",
    "MOD_UNIQUE_ID:server.environment.unique_id",
]
# The reference's tokens (tests/test_tpu_batch.py TestModUniqueIdDevice).
TOKENS = [
    "VaGTKApid0AAALpaNo0AAAAC", "Ucdv38CoEJwAAEusp6EAAADz",
    "AAAAAAAAAAAAAAAAAAAAAAAA", "____________------------", "short",
    "VaGTKApid0AAALpaNo0AAA@C", "VaGTKApid0AAALpaNo0AAA+C",
    "VaGTKApid0AAALpaNo0AAA=C", "-",
]


def _tokens(seed, n=300):
    """The reference's tokens, seeded well-formed ones, and ones of the
    wrong length or with a byte outside the alphabet."""
    rng = np.random.default_rng(seed)
    out = list(TOKENS)
    for _ in range(n):
        tok = base64.urlsafe_b64encode(bytes(rng.integers(0, 256, 18, dtype=np.uint8)
                                             .tolist())).decode()
        r = rng.random()
        if r < 0.1:
            tok = tok[:int(rng.integers(0, 24))]
        elif r < 0.2:
            at = int(rng.integers(0, 24))
            tok = tok[:at] + chr(int(rng.integers(32, 127))) + tok[at + 1:]
        out.append(tok)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("L", [32, 384])
def test_parse_mod_unique_id_matches_reference(L):
    toks = [t.encode() for t in _tokens(L)]
    buf, lengths, _ = encode_batch([b"x " + t + b" 200" for t in toks], line_len=L)
    s = np.full(len(toks), 2, np.int32)
    e = (s + np.array([len(t) for t in toks], np.int32)).clip(max=L)
    rng = np.random.default_rng(L)
    # Random spans too: starts past L - 24 (the gather's wrap and zeros).
    rs = rng.integers(0, L, 60).astype(np.int32)
    buf = np.concatenate([buf, rng.integers(0, 256, (60, L), dtype=np.uint8)])
    s = np.concatenate([s, rs])
    e = np.concatenate([e, np.minimum(rs + 24, L).astype(np.int32)])
    words, ok = postproc.parse_mod_unique_id(_t(buf), _t(s), _t(e))
    ref_words, ref_ok = ref_postproc.parse_mod_unique_id(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    for k in ("time", "ip", "pid", "counter", "thread"):
        np.testing.assert_array_equal(words[k].numpy(), np.asarray(ref_words[k]), err_msg=k)
    assert ok.sum() > 200 and (~ok).sum() > 20


@pytest.mark.parametrize("L", [64, 384, 2048])
def test_seeded_tokens_match_reference(L):
    """The seeded edge tokens (a byte of MUID_BAD_BYTES at each of the 24
    positions, widths 0, 23, 24 and 25, tokens running 0 to 24 bytes past
    L, starts past L below the mask's end at L = 384, all of them again
    with starts above the gather mask; then random rows) through the
    port's parse_mod_unique_id and the reference's, bit for bit: the
    words of tokens that do not decode too."""
    buf, s, e = seeded_muid_case(3000, L, seed=L)
    inside = window_inside(s, L, MUID_TOKEN)
    assert inside.any() and not inside.all()
    assert (s < 0).any() and (s > L).any()
    words, ok = postproc.parse_mod_unique_id(_t(buf), _t(s), _t(e))
    ref_words, ref_ok = ref_postproc.parse_mod_unique_id(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    for k in ("time", "ip", "pid", "counter", "thread"):
        np.testing.assert_array_equal(words[k].numpy(), np.asarray(ref_words[k]), err_msg=k)
    n_bad = MUID_TOKEN * len(MUID_BAD_BYTES)
    assert not ok[:n_bad].any() and ok[n_bad:].any()
    # The words of a token with a bad byte still differ from a good one's.
    assert len(np.unique(words["time"][:n_bad].numpy())) > 1


def test_reference_tokens_match():
    """Packed words, to_dict() and needs_host of the reference's tokens and
    seeded ones, through the remapping, against TpuBatchParser."""
    lines = [f"9.9.9.9 {t} 200" for t in _tokens(5)]
    ref = TpuBatchParser(FMT, FIELDS, type_remappings=REMAP)
    assert ref._unit_oracle_fields == [[]]
    ours_p = TorchBatchParser(FMT, FIELDS, device="cpu", type_remappings=REMAP)
    assert [p.kind for p in ours_p.units[0].plans] == [p.kind for p in ref.units[0].plans]
    assert packed_mismatch(ref, lines) is None
    want = ref.parse_batch(lines)
    ours = ours_p.parse_batch(lines)
    assert ours.needs_host.tolist() == want.oracle_row_ids.tolist() == []
    g, w = ours.to_dict(), want.to_dict()
    for fid in FIELDS:
        assert [(v, type(v)) for v in g[fid]] == [(v, type(v)) for v in w[fid]], fid


def test_known_values():
    p = TorchBatchParser(FMT, FIELDS, device="cpu", type_remappings=REMAP)
    r = p.parse_batch(["9.9.9.9 VaGTKApid0AAALpaNo0AAAAC 200"])
    assert r.to_pylist(FIELDS[0]) == [1436652328000]
    assert r.to_pylist(FIELDS[1]) == ["10.98.119.64"]
    assert r.to_pylist(FIELDS[2]) == [47706]
    assert r.to_pylist(FIELDS[3]) == [13965]
    assert r.to_pylist(FIELDS[4]) == [2]
    assert r.to_pylist(FIELDS[5]) == ["VaGTKApid0AAALpaNo0AAAAC"]


def test_decode_matches_the_reference_dissector():
    for tok in _tokens(9) + ["", "a" * 23, "@" * 24, "é" * 24]:
        raw = ref_decode(tok) if tok else None
        want = None
        if raw is not None and len(raw) == 18:
            want = {"epoch": int.from_bytes(raw[0:4], "big") * 1000,
                    "ip": ".".join(str(b) for b in raw[4:8]),
                    "processid": int.from_bytes(raw[8:12], "big"),
                    "counter": int.from_bytes(raw[12:14], "big"),
                    "threadindex": int.from_bytes(raw[14:18], "big")}
        assert mod_unique_id.decode(tok) == want, tok
