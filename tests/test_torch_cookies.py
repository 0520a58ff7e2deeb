"""Cookies and Set-Cookie equal the reference.

The plain PyTorch ``split_setcookie_csr`` and the cookie mode of
``split_csr`` (the CPU sides of the ``setcookie_split`` and ``csr_split``
kernels) against logparser_tpu's on numpy-seeded spans and real headers
at 16 and 32 slots; the reference's cookie, Set-Cookie and Set-Cookie
attribute cases through ``TorchBatchParser(device="cpu")`` against
``TpuBatchParser`` (packed words, ``to_dict()``, ``needs_host``, the
16 -> 32 slot growth); the port's cookie dissector functions against the
reference's dissectors; and the ctypes signatures against the C
sources.  ``tests/test_torch_cookies_config.py`` holds the configuration as a
whole.  Every comparison is exact.
"""
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from logparser_tpu.dissectors import cookies as ref_cookies
from logparser_tpu.tpu import postproc as ref_postproc
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.dissectors import cookies
from logparser_tpu_torch.tools.demolog import cookie_lines
from logparser_tpu_torch.tpu import kernels, postproc
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import assert_results_equal, packed_mismatch

ALPHABET = np.frombuffer(b",,  ;;==ExPiREs-setCOOKIE:a0%+", dtype=np.uint8)
PREFIX = '1.1.1.1 - - [07/Mar/2026:10:00:00 +0000] "GET /x HTTP/1.1" 200 5 '
# The reference's own cases (tests/test_query_csr.py).
COOKIES = [
    "sid=abc123; theme=dark", "sid=x%20y; a=b+c", "-", "", "single",
    "sid=1;bad=nospace", "  sid = padded ; x=y", "sid=%u0041",
    "sid=%zz", "a=1; " * 20 + "z=2", "Name=Mixed; UP=1",
]
SETCOOKIES = [
    "sid=abc; path=/", "sid=a, theme=b",
    "sid=1; expires=Thu, 01-Jan-2026 00:00:00 GMT; path=/, theme=d",
    "sid=1; Expires=Thu, 01 Jan 2026 00:00:00 GMT", "sid=1; expires=Thu, ",
    "x=expires=foo, y=2", "a=1, b=2, c=3", "a=x=y; path=/, b=2", "=nameless, b=2",
    " sid = padded , t=1", "-", "", "justaname", "UP=Mixed; Path=/",
    "sid=1; expires=Thu, 01-Jan-2026 00:00:00 GMT, t2=2; expires=Fri, 02-Jan-2026 00:00:00 GMT",
    "a=1; expires=Thu, b=2; expires=Fri, 03-Jan-2026 00:00:00 GMT",
    "set-cookie: sid=5; path=/", "Set-Cookie2: sid=6",
    "sid=abc; path=/; expires=Thu, 01-Jan-2026 00:00:00 GMT, t=1",
    ", ".join(f"c{i}={i}" for i in range(24)), "sid=1",
]
ATTR_VALUES = [
    "sid=abc; path=/shop; expires=Thu, 01-Jan-2027 00:00:00 GMT; domain=ex.com; comment=hi",
    "sid=plain", "sid=1; Expires=Thu, 01 Jan 2027 00:00:00 GMT",
    "sid=1; expires=Thu, 01 Jan 2027 00:00:00 GMT", "sid=1; expires=garbage",
    "other=1; path=/x", "sid=a; path=/1, sid=b; domain=d2", "sid=a; max-age=3600",
    "-", "", "sid=v; path = /sp ; domain= d.e", "SID=case; path=/c",
]
ATTR_FIELDS = [
    "STRING:response.cookies.sid.value", "STRING:response.cookies.sid.expires",
    "TIME.EPOCH:response.cookies.sid.expires", "STRING:response.cookies.sid.path",
    "STRING:response.cookies.sid.domain", "STRING:response.cookies.sid.comment",
]
CASES = {
    "cookie": ('%h %l %u %t "%r" %>s %b "%{Cookie}i"',
               ["HTTP.COOKIE:request.cookies.*", "HTTP.COOKIE:request.cookies.sid"],
               COOKIES),
    "setcookie": ('%h %l %u %t "%r" %>s %b "%{Set-Cookie}o"',
                  ["HTTP.SETCOOKIE:response.cookies.*",
                   "HTTP.SETCOOKIE:response.cookies.sid"], SETCOOKIES),
    "attrs": ('%h %l %u %t "%r" %>s %b "%{Set-Cookie}o"', ATTR_FIELDS, ATTR_VALUES),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _headers(lines):
    """The Cookie and Set-Cookie headers of generated lines."""
    return [h for ln in lines if ln.count('"') == 10 for h in ln.split('"')[7:10:2]]


def _spans(L, seed, B=160):
    """Real Cookie / Set-Cookie headers at offset 0, then random spans
    over separator-heavy bytes (empty, reversed and out-of-line ones
    included)."""
    heads = [h.encode()[:L] for h in COOKIES + SETCOOKIES + ATTR_VALUES]
    heads += [h.encode()[:L] for h in _headers(cookie_lines(60, seed=seed))]
    hb, hl, _ = encode_batch(heads, line_len=L)
    rng = np.random.default_rng(seed)
    buf = rng.choice(ALPHABET, size=(B, L)).astype(np.uint8)
    s = rng.integers(0, L + 4, size=B).astype(np.int32)
    e = np.clip(s + rng.integers(-3, L, size=B), 0, L).astype(np.int32)
    return (np.concatenate([hb, buf]), np.concatenate([np.zeros(len(heads), np.int32),
                                                       np.minimum(s, L)]),
            np.concatenate([hl, e]))


@pytest.mark.parametrize("slots", [16, 32])
@pytest.mark.parametrize("L", [128, 384])
def test_split_setcookie_matches_reference(L, slots):
    buf, s, e = _spans(L, seed=L + slots)
    ours = postproc.split_setcookie_csr(_t(buf), _t(s), _t(e), slots)
    ref = ref_postproc.split_setcookie_csr(jnp.asarray(buf), jnp.asarray(s),
                                           jnp.asarray(e), slots)
    for k in ("seg_start", "seg_end", "name_end", "emit"):
        for i, (a, b) in enumerate(zip(ours[k], ref[k])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{k}[{i}]")
    for k in ("bad", "overflow"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert ours["bad"].any() and (slots > 16 or ours["overflow"].any())


@pytest.mark.parametrize("slots", [16, 32])
@pytest.mark.parametrize("L", [128, 384])
def test_cookie_mode_split_csr_matches_reference(L, slots):
    buf, s, e = _spans(L, seed=3 * L + slots)
    window = 8 * slots
    ours = postproc.split_csr(_t(buf), _t(s), _t(e), slots, window=window, sep=b"; ")
    ref = ref_postproc.split_csr(jnp.asarray(buf), jnp.asarray(s), jnp.asarray(e),
                                 slots, sep=b"; ", window=window)
    for k in ("seg_start", "seg_end", "eq_pos", "decode", "name_pct", "name_high"):
        for i, (a, b) in enumerate(zip(ours[k], ref[k])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{k}[{i}]")
    np.testing.assert_array_equal(ours["overflow"].numpy(), np.asarray(ref["overflow"]))
    np.testing.assert_array_equal(postproc.csr_class_table(False, b"; "),
                                  ref_postproc._csr_class_table(None, ord("="), False))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases_match(case):
    """The reference's cases: packed words at 16 slots (and 32 after the
    growth the 21-cookie / 24-cookie lines force), to_dict(), needs_host."""
    fmt, fields, values = CASES[case]
    lines = [f'{PREFIX}"{v}"' for v in values]
    ref = TpuBatchParser(fmt, fields)
    assert ref._unit_oracle_fields == [[]]
    assert packed_mismatch(ref, lines) is None
    want = ref.parse_batch(lines)
    if ref.csr_slots > 16:   # the packed words again at the grown slots
        assert packed_mismatch(ref, lines) is None
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    host = assert_results_equal(ours, want, fields)
    assert ours.csr_regrows == (0 if case == "attrs" else 1)
    if case == "setcookie":
        assert len(host) == 3       # the double hold and the two prefixes


def test_cookie_dissector_functions_match_reference():
    """The port's per-value cookie semantics against the reference's
    dissectors, on every header of the cases and of a generated corpus."""
    class Rec:
        def __init__(self):
            self.values = {}

    heads = COOKIES + SETCOOKIES + ATTR_VALUES + _headers(cookie_lines(200, seed=7))
    for h in heads:
        for ours_fn, ref_cls in ((cookies.request_cookies, ref_cookies.RequestCookieListDissector),
                                 (cookies.response_setcookies,
                                  ref_cookies.ResponseSetCookieListDissector)):
            d = ref_cls()
            d.want_all = True
            got = {}

            class Parsable:
                class _F:
                    def __init__(self, v):
                        self.value = type("V", (), {"get_string": lambda _s: v})()

                def get_parsable_field(self, _t, _n):
                    return self._F(h)

                def add_dissection(self, _i, _t, name, value):
                    got[name] = value

            try:
                d.dissect(Parsable(), "x")
                want = dict(got)
            except Exception:  # noqa: BLE001 -- the reference fails the value
                want = None
            try:
                mine = ours_fn(h)
            except ValueError:
                mine = None
            assert mine == want, (h, mine, want)
        for part in cookies.response_setcookies(h).values():
            assert cookies.parse_attrs(part) == \
                ref_cookies.ResponseSetCookieDissector.parse_attrs(part), part


def test_ctypes_signatures_match_the_c_sources():
    """Every kernel's ctypes argtypes against its C entry point in csrc:
    one c_void_p per pointer, one c_int per int, the stream last."""
    for name in kernels.KERNELS:
        src = (kernels.CSRC / f"{name}.cu").read_text()
        m = re.search(rf"LP_EXPORT int lp_{name}\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        want = [kernels._P if "*" in p else kernels._INT for p in params]
        assert kernels._SIGNATURES[name] == want, name


@pytest.mark.parametrize("slots", [16, 32])
@pytest.mark.parametrize("L", [384, 2048])
def test_split_setcookie_on_seeded_spans_matches_reference(L, slots):
    """The seeded edge cases of the setcookie_split kernel (tools.kernel_ab.
    seeded_setcookie_case: expires= 14 and 15 bytes before a part's end, a
    double hold, a held last part, SeT-CoOkIe prefixes, one read past the
    span, a ", " as the last two bytes, more parts than slots, spans past
    L): the plain split equals the reference's on every slot output, bad
    and overflow."""
    from logparser_tpu_torch.tools.kernel_ab import (seeded_setcookie_case,
                                                     setcookie_tile_kinds)

    buf, s, e = seeded_setcookie_case(320, L, slots, seed=L + slots)
    kinds = setcookie_tile_kinds(s, e, L)
    assert min(kinds) >= 1   # tiles with nothing to walk, one round, more rounds
    ours = postproc.split_setcookie_csr(_t(buf), _t(s), _t(e), slots)
    ref = ref_postproc.split_setcookie_csr(jnp.asarray(buf), jnp.asarray(s),
                                           jnp.asarray(e), slots)
    for k in ("seg_start", "seg_end", "name_end", "emit"):
        for i, (a, b) in enumerate(zip(ours[k], ref[k])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{k}[{i}]")
    for k in ("bad", "overflow"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert ours["bad"].any() and ours["overflow"].any() and (~ours["overflow"]).any()


@pytest.mark.parametrize("L", [384, 2048])
def test_setcookie_slots_past_the_end_are_zero(L):
    """The premise setcookie_split's dead slots rest on, shown on the plain
    version over the seeded spans: once the cursor has reached the span's
    end, every later slot is two zero words and adds no bad -- the words of
    32 slots are those of 16 followed by zeros wherever the cursor had
    passed the end after 16, and bad is the same there."""
    from logparser_tpu_torch.tools.kernel_ab import seeded_setcookie_case
    from logparser_tpu_torch.tpu import pipeline

    buf, s, e = seeded_setcookie_case(320, L, 16, seed=L)
    B = len(s)
    out = {}
    for slots in (16, 32):
        t = types.SimpleNamespace(token_index=0, slots=slots, words=0, ok=2 * slots,
                                  bad=2 * slots + 1, over=2 * slots + 2)
        comps = torch.zeros((2 * slots + 3, B), dtype=torch.int32)
        pipeline.setcookie_split_plain(t, _t(buf), _t(s)[None], _t(e)[None], comps)
        sc = postproc.split_setcookie_csr(_t(buf), _t(s), _t(e), slots)
        out[slots] = (comps.numpy(), np.stack([c.numpy() for c in sc["seg_start"]]))
    (c16, cur16), (c32, cur32) = out[16], out[32]
    for k in range(32):
        past = cur32[k] >= e
        assert (c32[2 * k][past] == 0).all() and (c32[2 * k + 1][past] == 0).all()
    done = cur32[16] >= e
    assert done.sum() > B // 2 and (~done).any()
    np.testing.assert_array_equal(c32[:32, done], c16[:32, done])
    assert (c32[32:64, done] == 0).all()
    np.testing.assert_array_equal(c32[65, done], c16[33, done])
