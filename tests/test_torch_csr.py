"""The CSR segment split equals the reference.

The plain PyTorch ``split_csr`` of logparser_tpu_torch (the CPU side of
the ``csr_split`` kernel) against logparser_tpu's on numpy-seeded spans
of ``&`` / ``=`` / ``%`` / ``+`` / encode-set / high bytes, at 16 and 32
slots, unwindowed and windowed, below and above L = 1024 (the
reference's two prefix-count layouts), and on real query strings.  Every
slot output and the overflow flag are compared exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu_torch.tpu import postproc
from logparser_tpu_torch.tpu.runtime import encode_batch

ALPHABET = np.frombuffer(b"&&&===%%++ab09{|\"\x80\xc3\xa9Zx", dtype=np.uint8)
QUERIES = [b"q=caf%C3%A9", b"lang=nl&ref=home", b"id=123&x=", b"broken=50%-off",
           b"empty", b"a=1&b=2&c=3&utm_source=news", b"", b"&&", b"=v", b"k=",
           b"a=b=c", b"%41=1&+=+", b"x={y}", b"&".join(b"k%d=v" % i for i in range(40)),
           b"a&" * 600]


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(L, seed, B=120):
    rng = np.random.default_rng(seed)
    qb, ql, _ = encode_batch(QUERIES, line_len=L)
    buf = rng.choice(ALPHABET, size=(B, L)).astype(np.uint8)
    s = rng.integers(0, L + 4, size=B).astype(np.int32)
    e = (s + rng.integers(-2, min(L, 1200), size=B)).astype(np.int32)
    buf = np.concatenate([qb, buf])
    s = np.concatenate([np.zeros(len(QUERIES), np.int32), np.minimum(s, L)])
    e = np.concatenate([ql, np.clip(e, 0, L)])
    return buf, s, e


@pytest.mark.parametrize("uri_encoded", [True, False])
@pytest.mark.parametrize("slots", [16, 32])
@pytest.mark.parametrize("L,window_per_slot", [(128, None), (384, 8), (1024, None),
                                              (1500, 8), (8191, 8)])
def test_split_csr_matches_reference(L, window_per_slot, slots, uri_encoded):
    buf, s, e = _case(L, seed=L + slots)
    window = None if window_per_slot is None else window_per_slot * slots
    ours = postproc.split_csr(_t(buf), _t(s), _t(e), slots,
                              uri_encoded=uri_encoded, window=window)
    ref = ref_postproc.split_csr(jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e),
                                 slots, uri_encoded=uri_encoded, window=window)
    for k in ("seg_start", "seg_end", "eq_pos", "decode", "name_pct", "name_high"):
        for i, (a, b) in enumerate(zip(ours[k], ref[k])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{k}[{i}]")
    np.testing.assert_array_equal(ours["overflow"].numpy(), np.asarray(ref["overflow"]))
    assert ours["overflow"].any() and (~ours["overflow"]).any()


def test_class_table_matches_reference():
    for enc in (True, False):
        np.testing.assert_array_equal(
            postproc.csr_class_table(enc),
            ref_postproc._csr_class_table(ord("&"), ord("="), enc))


@pytest.mark.parametrize("mode", ["cookie", "query"])
@pytest.mark.parametrize("L,slots", [(2048, 16), (2048, 128), (384, 16), (384, 64),
                                     (130, 16), (8191, 32)])
def test_split_csr_edge_cases_match_reference(mode, L, slots):
    """The seeded edge-case generator (tools.kernel_ab.seeded_csr_case,
    also the card tests' input for the csr_split kernel): a separator
    split by the window's end, a lone ';', ';;' runs, '=' first and last,
    empty segments, '%' / '+' / high bytes in names and values, spans of
    exactly 8 * slots bytes and one more, a lone '-', a leading '?', more
    segments than slots and spans past L, laid out so that some 32-row
    tiles hold only spans of at most 64 bytes and others longer ones.
    Windowed at 8 * slots, as the CSR groups run it (unwindowed where that
    covers L)."""
    from logparser_tpu_torch.tools.kernel_ab import (CSR_SEPARATORS, csr_tile_kinds,
                                                     seeded_csr_case)

    buf, s, e = seeded_csr_case(160, L, slots, mode, seed=L + slots)
    assert min(csr_tile_kinds(s, e)) >= 2
    sep, enc = CSR_SEPARATORS[mode], mode == "query"
    ours = postproc.split_csr(_t(buf), _t(s), _t(e), slots, uri_encoded=enc,
                              window=8 * slots, sep=sep)
    ref = ref_postproc.split_csr(jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e), slots,
                                 sep=sep, uri_encoded=enc, window=8 * slots)
    for k in ("seg_start", "seg_end", "eq_pos", "decode", "name_pct", "name_high"):
        for i, (a, b) in enumerate(zip(ours[k], ref[k])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{k}[{i}]")
    np.testing.assert_array_equal(ours["overflow"].numpy(), np.asarray(ref["overflow"]))
    assert ours["overflow"].any() and (~ours["overflow"]).any()
    assert any(d.any() for d in ours["decode"]) and any(h.any() for h in ours["name_high"])
