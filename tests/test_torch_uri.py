"""The URI split and the protocol-version split equal the reference, and
so do the URI chain's packed rows at every scan-window geometry.

Plain PyTorch versions of logparser_tpu_torch (the CPU side of the
``uri_split`` kernel and of the ``pv`` parts of ``span_stages``) against
logparser_tpu's ``split_uri_fast`` / ``split_protocol_version`` on the
same buffers and spans: URI spans cut from the seed-53 corpus, crafted
URIs (absolute with userinfo and port, opaque, registry, 20-digit port,
``#``, ``;``, two ``?``, bad escapes, encode-set bytes, over-window) and
numpy-seeded random spans, windowed (L > W) and unwindowed (L <= W),
with and without the authority parts and the CLF dash.  Every output is
compared exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.tools.demolog import generate_combined_lines
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch.tools.demolog import URI_CHAIN_FIELDS, uri_edge_lines
from logparser_tpu_torch.tpu import pipeline, postproc
from logparser_tpu_torch.tpu.carry import units_from_reference
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import first_mismatch, jax_unit_plain, reference_packed

CRAFTED_URIS = [
    "/", "/index.html?q=caf%C3%A9", "/a%20b?x=1&y=2", "/p?broken=50%-off",
    "/p?empty", "/p?id=123&x=", "/p&a=1", "/p?a=1?b=2", "/p#frag", "/p;jsessionid=1",
    "http://user:pw@example.com:8080/x/y?a=b", "http://u%41@h.com/", "https://h.com",
    "http://[::1]:80/ipv6", "http://h.com:123456789012345678901/p",
    "http://h.com:9223372036854775808/p", "http://h.com:80x/p", "http://h.com:/p",
    "mailto:someone@example.com", "urn:isbn:0451450523?x", "1abc:/x", "a+b.c-d:rest",
    "example.com/x?y", "-", "", "?", "&", ":", "//host/p", "http:", "http:/", "http://",
    "/ x", "/a|b?c^d", "/q?v=a{b}", "/q?a=%zz&b=%4", "h://a@b@c:1/", "/%", "/x?%41=1",
    "http://h.com?x=1", "http://h.com&x", "/" + "x" * 250 + "?y=1",
    "/p?" + "&".join(f"k{i}=v{i}" for i in range(20)),
]
ALPHABET = np.frombuffer(b"/?&=:%@#;.-+aZ09[]h ", dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spans(L, seed):
    """(buf [B, L], start, end): crafted URIs, the corpus's request URIs
    and referers at their real offsets, and random spans over random
    URI-ish bytes (including empty, negative and out-of-line spans)."""
    lines = [u.encode() for u in CRAFTED_URIS]
    for ln in generate_combined_lines(60, seed=53):
        req = ln.split('"')[1]
        lines.append(req.split(" ")[1].encode())
        lines.append(ln.split('"')[3].encode())
    lines = [x[:L] for x in lines]
    buf, lengths, _ = encode_batch(lines, line_len=L)
    s = np.zeros(len(lines), np.int32)
    e = lengths.astype(np.int32)
    rng = np.random.default_rng(seed)
    rb = rng.choice(ALPHABET, size=(80, L)).astype(np.uint8)
    rs = rng.integers(0, L + 4, size=80).astype(np.int32)
    re_ = (rs + rng.integers(-3, L, size=80)).astype(np.int32)
    buf = np.concatenate([buf, rb])
    s = np.concatenate([s, np.minimum(rs, L)])
    e = np.concatenate([e, np.clip(re_, 0, L)])
    return buf, s, e


@pytest.mark.parametrize("need_authority", [True, False])
@pytest.mark.parametrize("L,window", [(128, 192), (128, None), (384, 192),
                                      (384, 384), (8191, 1536), (256, 24)])
def test_split_uri_matches_reference(L, window, need_authority):
    buf, s, e = _spans(L, seed=L + (window or 0))
    dash = (e - s == 1) & (buf[np.arange(len(s)), np.minimum(s, L - 1)] == ord("-"))
    for d in (None, dash):
        ours = postproc.split_uri_fast(
            _t(buf), _t(s), _t(e), dash=None if d is None else _t(d),
            need_authority=need_authority, window=window)
        ref = ref_postproc.split_uri_fast(
            jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e),
            dash=None if d is None else jnp.asarray(d),
            need_authority=need_authority, window=window)
        assert set(ours) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # The crafted URIs reach every class: fix rows, repair rejects,
    # authority parts, and (windowed) over-window rows.
    assert ours["path_fix"].any() and ours["query_fix"].any()
    assert (~ours["ok"]).any() and (~ours["host_null"]).any() == need_authority
    if window is not None and window < L and window < 250:
        assert ours["overflow"].any()


@pytest.mark.parametrize("L", [64, 128, 384])
def test_split_protocol_version_matches_reference(L):
    protos = [b"HTTP/1.1", b"HTTP/2.0", b"-", b"", b"HTTP", b"/1.0", b"HTTP/",
              b"a/b/c", b"SPDY/3 x"]
    buf, lengths, _ = encode_batch(protos, line_len=L)
    rng = np.random.default_rng(L)
    rb = rng.choice(np.frombuffer(b"HTP/1.-", dtype=np.uint8), size=(40, L)).astype(np.uint8)
    buf = np.concatenate([buf, rb])
    s = np.concatenate([np.zeros(len(protos), np.int32),
                        rng.integers(0, L + 2, size=40).astype(np.int32)])
    e = np.concatenate([lengths, np.clip(s[len(protos):] + rng.integers(-2, 12, size=40),
                                         0, L).astype(np.int32)])
    s = np.minimum(s, L)
    dash = (e - s == 1) & (buf[np.arange(len(s)), np.minimum(s, L - 1)] == ord("-"))
    for d in (None, dash):
        ours = postproc.split_protocol_version(
            _t(buf), _t(s), _t(e), dash=None if d is None else _t(d))
        ref = ref_postproc.split_protocol_version(
            jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e),
            dash=None if d is None else jnp.asarray(d))
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_span_prefix_words_render_the_query_amp():
    from logparser_tpu.tpu import pipeline as ref_pipeline

    buf, s, e = _spans(128, seed=5)
    rng = np.random.default_rng(5)
    ok = rng.random(len(s)) < 0.9
    null = rng.random(len(s)) < 0.1
    amp = rng.random(len(s)) < 0.7
    ours = postproc.span_prefix_words(_t(buf), _t(s), _t(e), _t(ok & ~null), _t(amp))
    ref = ref_pipeline.span_prefix_words(
        jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e), jnp.asarray(ok),
        jnp.asarray(null), jnp.asarray(amp), ref_postproc.gather_span_bytes)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _grown_reference(fields, slots):
    """A fresh reference parser (not the shared one: growing mutates it)
    with its CSR slots doubled up to ``slots``."""
    ref = TpuBatchParser("combined", list(fields))
    while ref.csr_slots < slots:
        assert ref._grow_csr_slots()
    return ref


QUERY_ONLY = ["HTTP.PATH:request.firstline.uri.path",
              "STRING:request.firstline.uri.query.*"]


@pytest.mark.parametrize("L,slots,fields", [
    (128, 16, URI_CHAIN_FIELDS),     # unwindowed: L <= both windows
    (384, 32, URI_CHAIN_FIELDS),     # windowed, after one regrow
    (8191, 128, QUERY_ONLY),         # windowed at the cap: 1536 / 1024 bytes
])
def test_uri_chain_rows_match_reference(L, slots, fields):
    """The URI chain's packed rows bit for bit (the mismatch, if any, is
    named by (field, component) slot), with the overflow bit set exactly
    where the reference sets it."""
    ref = _grown_reference(fields, slots)
    specs = ref._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in ref.units])
    assert units[0].layout.csr_slots == slots
    ex = pipeline.UnitsExecutor(units, specs)
    lines = uri_edge_lines(min(L, 384)) + generate_combined_lines(60, seed=53)
    if L == 8191:
        lines += uri_edge_lines(1500)[-1:] + [
            uri_edge_lines()[0].replace("/x/y?", "/" + "z" * 2000 + "?")]
    buf, lengths, _ = encode_batch(lines, line_len=L)
    want = reference_packed(ref.units, specs, buf, lengths)
    got = ex(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(ref.units, specs, got, want) is None
    over = (got[0] & pipeline.CSR_OVERFLOW_BIT) != 0
    assert over[len(uri_edge_lines()) - 1] and over.sum() < 8


@pytest.mark.parametrize("L", [384, 2048])
@pytest.mark.parametrize("window", [192, None])
def test_split_uri_on_seeded_spans_matches_reference(L, window):
    """The seeded edge cases of the uri_split kernel (tools.kernel_ab.
    seeded_uri_case: '@' and ':' in userinfo and port, 19- and 20-digit
    ports, [::1], mailto:, a +.- scheme, '-', '%' and '%X' at the window's
    end, a span the window cuts, spans across a 16-byte boundary and past
    L), windowed at 192 bytes (16 slots) and unwindowed, with the CLF dash:
    the plain split equals the reference's on every output."""
    from logparser_tpu_torch.tools.kernel_ab import (seeded_uri_case, uri_byte_walks,
                                                     uri_clamped, uri_tile_kinds)

    W = window or L
    buf, s, e = seeded_uri_case(256, L, W, seed=L + W)
    assert uri_tile_kinds(s, e, L, W)[0] >= 1
    assert uri_byte_walks(s, e, L, W) > 0 or uri_clamped(s, e, L, W).any()
    dash = (e - s == 1) & (buf[np.arange(len(s)), np.minimum(s, L - 1)] == ord("-"))
    ours = postproc.split_uri_fast(_t(buf), _t(s), _t(e), dash=_t(dash), window=window)
    ref = ref_postproc.split_uri_fast(jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e),
                                      dash=jnp.asarray(dash), window=window)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert ours["path_fix"].any() and ours["query_fix"].any() and ours["userinfo_fix"].any()
    assert (~ours["ok"]).any() and (~ours["host_null"]).any()
    assert ours["overflow"].any() == (window is not None)
