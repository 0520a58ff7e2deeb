"""Typed span post-stages, plain PyTorch (the CPU versions the
``span_stages`` kernel is held against), and the host-side long combine.

Port of the reference package's ``tpu/postproc.py`` for the stages the
Apache ``combined`` main path and the URI chain run:

- :func:`gather_span_bytes` — a ``[B, width]`` byte window from a per-row
  start.  The reference builds it from log-shifts (TPU gathers are slow);
  here it is a plain gather with the same result, including the start's
  bits above ``bit_length(L - 1)`` being ignored and zeros past ``L``.
- :func:`parse_long_spans` — digit spans -> a left-aligned 19-digit limb
  frame, CLF ``-`` aware.
- :func:`split_firstline` — ``METHOD URI PROTO`` sub-spans.
- :func:`span_prefix_words` — a span's first 12 bytes as 3 LE int32 words
  (a query span's leading '?' rendered '&').
- :func:`combine_long_limbs` — the exact uint64 host combine.
- :func:`split_protocol_version`, :func:`split_uri_fast`,
  :func:`split_csr` (with :func:`csr_class_table`) — the URI chain: the
  plain versions of the ``pv`` parts of ``span_stages`` and of the
  ``uri_split`` / ``csr_split`` kernels.
- :func:`parse_secmillis_spans` -- NGINX ``$msec`` / ``$request_time``
  (``<seconds>.<3 digits>``): the plain version of the ``secmillis``
  task of ``span_stages``.
- :func:`parse_ipv4_spans` -- strict dotted quads -> uint32: the plain
  version of the ``ipv4_spans`` kernel.
- :func:`split_setcookie_csr` -- Set-Cookie lists with the expires
  rejoin, and :func:`parse_mod_unique_id` -- the 24-character
  mod_unique_id token: the plain versions of the ``setcookie_split`` and
  ``muid`` kernels; :func:`split_csr` with ``sep=b"; "`` is the cookie
  mode of ``csr_split``.
- :func:`unescape_compact_spans` -- the device inverse of Apache's
  ``ap_escape_logitem`` for ``\\"`` and ``\\\\``: the public entry, which
  launches the ``unescape`` kernel on a CUDA tensor;
  :func:`unescape_compact_spans_plain` is its plain version.

Every function reproduces the reference's int32 arithmetic, wraparound
included, so its outputs equal the reference bit for bit on any bytes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

MAX_LONG_DIGITS = 19
LONG_MAX = (1 << 63) - 1
_POW10_U64 = np.array([10 ** k for k in range(MAX_LONG_DIGITS + 1)],
                      dtype=np.uint64)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 with two's-complement wraparound: the result
    of the same arithmetic done in int32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _is_digit(b: torch.Tensor) -> torch.Tensor:
    return (b >= ord("0")) & (b <= ord("9"))


def gather_span_bytes(buf: torch.Tensor, start: torch.Tensor,
                      width: int) -> torch.Tensor:
    """[B, width] uint8: bytes ``(start mod 2**bit_length(L-1)) + i`` of
    each row, 0 at or past ``L``."""
    B, L = buf.shape
    width = min(width, L)
    mask = (1 << max(1, (L - 1).bit_length())) - 1
    idx = (start.to(torch.int64) & mask)[:, None] + torch.arange(
        width, device=buf.device
    )
    inside = idx < L
    vals = torch.gather(buf, 1, torch.where(inside, idx, 0))
    return torch.where(inside, vals, torch.zeros_like(vals))


def parse_long_spans(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor, clf: bool,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Digit spans -> ((hi, lo, d18, ndig), is_null, ok, big).

    ``hi`` / ``lo`` are the dot products of frame columns 0..8 / 9..17
    with descending powers of ten (int32, wrapping like the reference),
    ``d18`` the 19th frame digit, ``ndig`` the digit count clipped to 19;
    bytes past the span count as digit 0.  ``big`` marks spans longer
    than 19 bytes (only the first 19 are digit-checked).  With ``clf`` a
    lone ``-`` is ok and null."""
    n = end - start
    window = gather_span_bytes(buf, start, MAX_LONG_DIGITS)
    col = torch.arange(MAX_LONG_DIGITS, device=buf.device)
    in_span = col[None, :] < n[:, None]
    digits = (window.to(torch.int64) - ord("0")) & 0xFF   # uint8 wrap
    digit_ok = digits <= 9
    d = torch.where(in_span, digits, 0)
    p9 = 10 ** torch.arange(8, -1, -1, device=buf.device, dtype=torch.int64)
    hi = wrap_i32((d[:, :9] * p9).sum(dim=1))
    lo = wrap_i32((d[:, 9:18] * p9).sum(dim=1))
    d18 = d[:, 18].to(torch.int32)
    is_dash = (n == 1) & (window[:, 0] == ord("-"))
    window_digits = (digit_ok | ~in_span).all(dim=1)
    big = n > MAX_LONG_DIGITS
    ok = (n > 0) & window_digits
    if clf:
        ok = ok | is_dash
    is_null = is_dash & clf
    return ((hi, lo, d18, n.clamp(0, MAX_LONG_DIGITS)), is_null, ok, big)


def split_firstline(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """"METHOD URI PROTO" span -> method/uri/protocol sub-spans.

    Method = up to the first space, protocol = after the last space when
    it is ``HTTP/`` + digits with exactly one dot (else the truncated-line
    fallback: no protocol, uri to the end).  ``ok`` is False when the
    span holds no space."""
    B, L = buf.shape
    pos = torch.arange(L, device=buf.device, dtype=torch.int32)[None, :]
    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    is_space = (buf == ord(" ")) & in_span
    first_space = torch.where(is_space, pos, L).amin(dim=1)
    last_space = torch.where(is_space, pos, -1).amax(dim=1)
    has_space = first_space < L
    method_end = torch.where(has_space, first_space, start)

    proto_start = torch.where(has_space, last_space + 1, end)
    head = gather_span_bytes(buf, proto_start, 5)
    http = torch.tensor(list(b"HTTP/"), dtype=torch.uint8, device=buf.device)
    head_ok = (head == http[None, :]).all(dim=1)
    ver = (pos >= (proto_start + 5)[:, None]) & (pos < end[:, None])
    is_dot = buf == ord(".")
    ver_chars_ok = (_is_digit(buf) | is_dot | ~ver).all(dim=1)
    one_dot = (is_dot & ver).sum(dim=1) == 1
    last_b = gather_span_bytes(buf, (end - 1).clamp(min=0), 1)[:, 0]
    first_ver = gather_span_bytes(buf, proto_start + 5, 1)[:, 0]
    ver_ok = (
        ((end - proto_start) >= 8) & ver_chars_ok & one_dot
        & _is_digit(first_ver) & _is_digit(last_b)
    )
    has_protocol = has_space & (last_space > first_space) & head_ok & ver_ok
    return {
        "method_start": start,
        "method_end": method_end,
        "uri_start": torch.where(has_space, first_space + 1, end),
        "uri_end": torch.where(has_protocol, last_space, end),
        "proto_start": torch.where(has_protocol, proto_start, end),
        "proto_end": end,
        "has_protocol": has_protocol,
        "ok": has_space,
    }


def span_prefix_words(
    buf: torch.Tensor, s: torch.Tensor, e: torch.Tensor, live: torch.Tensor,
    amp: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The span's first 12 bytes as 3 little-endian int32 words, bytes at
    or past the span length zeroed, all-zero on rows that are not live.
    On ``amp`` rows a leading '?' renders as '&' (the query
    normalization)."""
    first12 = gather_span_bytes(buf, s, 12).to(torch.int64)
    pos = torch.arange(12, device=buf.device)
    masked = torch.where(
        live[:, None] & (pos[None, :] < (e - s)[:, None]), first12, 0
    )
    if amp is not None:
        amp_row = amp & live & ((e - s) > 0) & (masked[:, 0] == ord("?"))
        masked[:, 0] = torch.where(amp_row, ord("&"), masked[:, 0])
    return tuple(
        wrap_i32(masked[:, 4 * w] | (masked[:, 4 * w + 1] << 8)
                 | (masked[:, 4 * w + 2] << 16) | (masked[:, 4 * w + 3] << 24))
        for w in range(3)
    )


def combine_long_limbs(hi, lo, d18, ndig, is_null):
    """Host-side frame combine -> (int64 values, overflow mask, uint64
    frame values).

    The 19-digit left-aligned value is hi*10^10 + lo*10 + d18 with
    (19 - ndig) trailing zero digits, so dividing by 10^(19-ndig) is
    exact; the combine runs in uint64.  ``overflow`` marks values beyond
    Long.MAX_VALUE (their int64 entry is clamped and never read); null
    slots read -1."""
    hi_u = np.asarray(hi).astype(np.uint64)
    lo_u = np.asarray(lo).astype(np.uint64)
    d_u = np.asarray(d18).astype(np.uint64)
    frame = hi_u * np.uint64(10 ** 10) + lo_u * np.uint64(10) + d_u
    shift = MAX_LONG_DIGITS - np.asarray(ndig, dtype=np.int64)
    wide = frame // _POW10_U64[np.clip(shift, 0, MAX_LONG_DIGITS)]
    overflow = wide > np.uint64(LONG_MAX)
    value = np.where(overflow, np.uint64(LONG_MAX), wide).astype(np.int64)
    value[np.asarray(is_null)] = -1
    return value, overflow, wide



# ---------------------------------------------------------------------------
# The URI chain.  Plain versions of the uri_split / csr_split
# kernels and of the protocol-version split in span_stages; each mirrors
# the reference function named in its docstring, sentinels and windowing
# included, so its outputs equal the reference bit for bit on any input.
# ---------------------------------------------------------------------------


def split_protocol_version(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
    dash: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """"HTTP/1.1" -> protocol (before the FIRST '/') + version (after it);
    ``null`` when the span is empty, a CLF dash, or holds no '/'
    (the reference's split_protocol_version)."""
    B, L = buf.shape
    pos = torch.arange(L, device=buf.device, dtype=torch.int32)[None, :]
    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    slash = torch.where((buf == ord("/")) & in_span, pos, L).amin(dim=1)
    absent = start >= end
    if dash is not None:
        absent = absent | dash
    return {
        "proto_start": start,
        "proto_end": torch.minimum(slash, end),
        "ver_start": torch.minimum(slash + 1, end),
        "ver_end": end,
        "null": absent | (slash >= L),
    }


def _window(buf: torch.Tensor, start: torch.Tensor, W: int) -> torch.Tensor:
    """[B, W]: bytes ``clip(start + i, 0, L - 1)`` of each row (the
    reference's scan-window gather)."""
    L = buf.shape[1]
    idx = (start.to(torch.int64)[:, None]
           + torch.arange(W, device=buf.device)[None, :]).clamp(0, L - 1)
    return torch.gather(buf, 1, idx)


def _is_hex(x: torch.Tensor) -> torch.Tensor:
    return (_is_digit(x) | ((x >= ord("a")) & (x <= ord("f")))
            | ((x >= ord("A")) & (x <= ord("F"))))


def _is_alpha(x: torch.Tensor) -> torch.Tensor:
    return ((x >= ord("A")) & (x <= ord("Z"))) | ((x >= ord("a")) & (x <= ord("z")))


def shift_zero(x: torch.Tensor, k: int) -> torch.Tensor:
    """Left-shift columns by k, zero-filling the tail."""
    if k <= 0:
        return x
    B, L = x.shape
    if k >= L:
        return torch.zeros_like(x)
    return torch.cat([x[:, k:], torch.zeros((B, k), dtype=x.dtype,
                                            device=x.device)], dim=1)


def split_uri_fast(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
    dash: Optional[torch.Tensor] = None, need_authority: bool = True,
    window: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """URI span -> protocol / userinfo / host / port / path / query
    sub-spans, ``ok`` (False: the host repair chain would rewrite the
    span), path / query / userinfo ``fix`` flags, the query ``amp`` flag
    and, windowed, ``overflow`` (the reference's split_uri_fast).

    With ``window`` W < L the span is gathered into a [B, W] buffer, split
    there, and every ``*_start`` / ``*_end`` is rebased by ``start``;
    spans longer than W raise ``overflow`` and hold ``ok`` True."""
    from ..dissectors.uri import ENCODE_PRINTABLE

    B, L = buf.shape
    if window is not None and int(window) < L:
        W = int(window)
        span = end - start
        res = split_uri_fast(
            _window(buf, start, W), torch.zeros_like(start),
            torch.minimum(span, torch.full_like(span, W)),
            dash=dash, need_authority=need_authority,
        )
        for name, v in list(res.items()):
            if name.endswith("_start") or name.endswith("_end"):
                res[name] = v + start
        over = span > W
        res["ok"] = res["ok"] | over
        res["overflow"] = over
        return res
    dev = buf.device
    pos = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    all_null = (end - start) == 0
    if dash is not None:
        all_null = all_null | dash

    def first(mask):
        return torch.where(mask, pos, L).amin(dim=1)

    def last(mask):
        return torch.where(mask, pos, -1).amax(dim=1)

    def any_(mask):
        return mask.any(dim=1)

    is_q = (buf == ord("?")) & in_span
    is_amp = (buf == ord("&")) & in_span
    first_sep = torch.minimum(first(is_q | is_amp), end)

    bad = (buf < 0x20) | (buf >= 0x7F) | (buf == ord("#")) | (buf == ord(";"))
    clean = ~any_(bad & in_span)
    enc = torch.zeros_like(in_span)
    for ch in ENCODE_PRINTABLE:
        enc = enc | (buf == ch)
    enc = enc & in_span
    q_count = is_q.sum(dim=1)
    first_q = first(is_q)
    clean = clean & ((q_count == 0) | ((q_count == 1) & (first_q == first_sep)))

    is_pct = (buf == ord("%")) & in_span
    nxt1 = shift_zero(buf, 1)
    nxt2 = shift_zero(buf, 2)
    pct_bad = is_pct & ~(_is_hex(nxt1) & _is_hex(nxt2) & (pos + 2 < end[:, None]))

    lead = gather_span_bytes(buf, start, 1)[:, 0]
    relative = (~all_null) & (lead == ord("/"))

    is_digit = _is_digit(buf)
    is_alpha = _is_alpha(buf)
    is_colon = (buf == ord(":")) & in_span
    is_slash = (buf == ord("/")) & in_span
    first_colon = first(is_colon)
    first_slash = first(is_slash)
    limit = torch.minimum(torch.minimum(first_slash, first_sep), end)
    has_scheme = (first_colon < limit) & (first_colon > start)
    scheme_cs = is_alpha | is_digit | (buf == ord("+")) | (buf == ord(".")) | (buf == ord("-"))
    in_scheme = (pos > start[:, None]) & (pos < first_colon[:, None])
    scheme_ok = _is_alpha(lead) & (scheme_cs | ~in_scheme).all(dim=1)

    d2 = gather_span_bytes(buf, first_colon + 1, 2)
    dslash = (d2[:, 0] == ord("/")) & (d2[:, 1] == ord("/")) & (first_colon + 3 <= end)
    auth_start = first_colon + 3
    slash_a = first(is_slash & (pos >= auth_start[:, None]))
    auth_end = torch.minimum(torch.minimum(slash_a, first_sep), end)
    if need_authority:
        in_auth = (pos >= auth_start[:, None]) & (pos < auth_end[:, None])
        at = last((buf == ord("@")) & in_auth)
        has_at = at >= 0
        rest_start = torch.where(has_at, at + 1, auth_start)
        colon2 = last(is_colon & (pos >= rest_start[:, None]) & (pos < auth_end[:, None]))
        has_pcolon = colon2 >= 0
        port_start = colon2 + 1
        port_len = auth_end - port_start
        port_empty = port_len <= 0
        in_port = has_pcolon[:, None] & (pos >= port_start[:, None]) & (pos < auth_end[:, None])
        port_digits = (is_digit | ~in_port).all(dim=1)
        host_end = torch.where(has_pcolon & (port_empty | port_digits), colon2, auth_end)
        in_host = (pos >= rest_start[:, None]) & (pos < host_end[:, None])
        host_cs = is_alpha | is_digit | (buf == ord(".")) | (buf == ord("-"))
        host_ok_cs = (host_cs | ~in_host).all(dim=1)
        registry = (~host_ok_cs) | (has_pcolon & ~port_empty & ~port_digits)
        ui_fix = any_(is_pct & (pos >= auth_start[:, None]) & (pos < at[:, None]))
        abs_ok = has_scheme & scheme_ok & dslash & ~(
            has_pcolon & ~port_empty & port_digits & (port_len > MAX_LONG_DIGITS)
        )
    else:
        false_v = torch.zeros(B, dtype=torch.bool, device=dev)
        zero_v = torch.zeros(B, dtype=torch.int32, device=dev)
        has_at = has_pcolon = port_empty = ui_fix = false_v
        at = rest_start = host_end = port_start = zero_v
        registry = torch.ones(B, dtype=torch.bool, device=dev)
        abs_ok = has_scheme & scheme_ok & dslash
    is_abs = has_scheme & abs_ok & ~all_null
    opaque = has_scheme & scheme_ok & ~dslash & ~all_null
    case3 = (~has_scheme) & (~relative) & (~all_null)
    handled = all_null | relative | case3 | is_abs | opaque
    ok = clean & handled

    show_auth = is_abs & ~registry
    path_begin = torch.where(is_abs, auth_end,
                             torch.where(opaque, first_colon + 1, start))
    path_fix = any_(is_pct & (pos >= path_begin[:, None]) & (pos < first_sep[:, None]))
    query_fix = any_((pct_bad | enc) & (pos >= first_sep[:, None]))
    has_query = (~all_null) & (first_sep < end)

    def span(show, s, e):
        return torch.where(show, s, start), torch.where(show, e, start)

    proto_s, proto_e = span(is_abs | opaque, start, first_colon)
    ui_show = show_auth & has_at
    ui_s, ui_e = span(ui_show, auth_start, at)
    host_s, host_e = span(show_auth, rest_start, host_end)
    port_show = show_auth & has_pcolon & ~port_empty
    port_s, port_e = span(port_show, port_start, auth_end)
    return {
        "ok": ok,
        "overflow": torch.zeros(B, dtype=torch.bool, device=dev),
        "all_null": all_null,
        "path_start": torch.where(all_null, start, path_begin),
        "path_end": torch.where(all_null, start, torch.maximum(first_sep, path_begin)),
        "path_null": all_null,
        "query_start": torch.where(all_null, start, first_sep),
        "query_end": torch.where(all_null, start, end),
        "query_null": all_null,
        "query_amp": has_query,
        "proto_start": proto_s,
        "proto_end": proto_e,
        "proto_null": all_null | ~(is_abs | opaque),
        "userinfo_start": ui_s,
        "userinfo_end": ui_e,
        "userinfo_null": all_null | ~ui_show,
        "userinfo_fix": ui_fix & ui_show,
        "host_start": host_s,
        "host_end": host_e,
        "host_null": all_null | ~show_auth,
        "port_start": port_s,
        "port_end": port_e,
        "path_fix": path_fix,
        "query_fix": query_fix,
    }


# csr_split byte classes (the reference's _csr_class_table): bit 0 =
# value-decode trigger, bit 1 = name-escape trigger, bit 2 = high byte,
# bit 3 = the kv byte, bit 4 = the single-byte separator.
CSR_DEC, CSR_PCT, CSR_HIGH, CSR_KV, CSR_SEP = 1, 2, 4, 8, 16


def csr_class_table(uri_encoded: bool, sep: bytes = b"&") -> np.ndarray:
    """256-entry uint8 byte-class table of :func:`split_csr` (key / value
    byte ``=``; the separator's class bit only for a one-byte
    separator)."""
    from ..dissectors.uri import ENCODE_PRINTABLE

    t = np.zeros(256, dtype=np.uint8)
    t[ord("%")] |= CSR_DEC | CSR_PCT
    t[ord("+")] |= CSR_DEC
    t[0x80:] |= CSR_HIGH
    if uri_encoded:
        for ch in ENCODE_PRINTABLE:
            t[ch] |= CSR_DEC | CSR_PCT
    t[ord("=")] |= CSR_KV
    if len(sep) == 1:
        t[sep[0]] |= CSR_SEP
    return t


def split_csr(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
    max_segments: int, uri_encoded: bool = False, window: Optional[int] = None,
    sep: bytes = b"&",
) -> Dict[str, object]:
    """Query string or cookie header span -> up to ``max_segments``
    ``sep``-delimited segments (``&``; cookies ``"; "``), each with its
    first ``=`` and its decode / name-escape / name-high flags, plus
    ``overflow`` (more segments than slots, or, windowed, a span longer
    than the window) -- the reference's split_csr.  Per-slot outputs are
    lists of [B] tensors.  A two-byte separator is the AND of the shifted
    byte planes, both bytes inside the span.  Both of the reference's
    count layouts are kept: one packed 10-bit-field prefix count below
    L = 1024, three prefix counts from there on; they give the same
    flags."""
    B, L = buf.shape
    if window is not None and int(window) < L:
        W = int(window)
        span = end - start
        res = split_csr(
            _window(buf, start, W), torch.zeros_like(start),
            torch.minimum(span, torch.full_like(span, W)), max_segments,
            uri_encoded=uri_encoded, sep=sep,
        )
        for name in ("seg_start", "seg_end", "eq_pos"):
            res[name] = [v + start for v in res[name]]
        res["overflow"] = res["overflow"] | (span > W)
        return res
    dev = buf.device
    pos = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    cls = torch.from_numpy(csr_class_table(uri_encoded, sep)).to(dev)[buf.long()]
    if len(sep) == 1:
        is_sep = (cls & CSR_SEP) != 0
    else:
        is_sep = buf == sep[0]
        for k in range(1, len(sep)):
            is_sep = is_sep & (shift_zero(buf, k) == sep[k])
    is_sep = is_sep & in_span & (pos + len(sep) <= end[:, None])
    is_kv = ((cls & CSR_KV) != 0) & in_span
    is_dec = ((cls & CSR_DEC) != 0) & in_span
    is_pct = ((cls & CSR_PCT) != 0) & in_span
    is_high = ((cls & CSR_HIGH) != 0) & in_span

    def suffix_min(mask):
        m = torch.where(mask, pos, L)
        return torch.flip(torch.cummin(torch.flip(m, [1]), dim=1).values, [1])

    suffix_sep = suffix_min(is_sep)
    suffix_kv = suffix_min(is_kv)

    def excount(m):
        c = torch.cumsum(m.to(torch.int32), dim=1, dtype=torch.int32)
        return torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev), c], dim=1)

    def gat(mat, idx, fill, width):
        v = torch.gather(mat, 1, idx.clamp(0, width - 1).to(torch.int64)[:, None])[:, 0]
        return torch.where(idx >= width, fill, v)

    packed = None
    if L < 1024:
        packed = excount(is_dec.to(torch.int32) | (is_pct.to(torch.int32) << 10)
                         | (is_high.to(torch.int32) << 20))
    else:
        cum_dec, cum_pct, cum_high = excount(is_dec), excount(is_pct), excount(is_high)

    out = {k: [] for k in ("seg_start", "seg_end", "eq_pos", "decode",
                           "name_pct", "name_high")}
    cursor = start
    for _ in range(max_segments):
        s_end = torch.minimum(gat(suffix_sep, cursor, L, L), end)
        eq = torch.minimum(gat(suffix_kv, cursor, L, L), s_end)
        v_lo = torch.minimum(eq + 1, s_end)
        n_lo = torch.minimum(cursor, eq)
        if packed is not None:
            val_d = gat(packed, s_end, 0, L + 1) - gat(packed, v_lo, 0, L + 1)
            nam_d = gat(packed, eq, 0, L + 1) - gat(packed, n_lo, 0, L + 1)
            dec_cnt = val_d & 0x3FF
            np_cnt = (nam_d >> 10) & 0x3FF
            nh_cnt = nam_d >> 20
        else:
            dec_cnt = gat(cum_dec, s_end, 0, L + 1) - gat(cum_dec, v_lo, 0, L + 1)
            np_cnt = gat(cum_pct, eq, 0, L + 1) - gat(cum_pct, n_lo, 0, L + 1)
            nh_cnt = gat(cum_high, eq, 0, L + 1) - gat(cum_high, n_lo, 0, L + 1)
        out["seg_start"].append(cursor)
        out["seg_end"].append(s_end)
        out["eq_pos"].append(eq)
        out["decode"].append(dec_cnt > 0)
        out["name_pct"].append(np_cnt > 0)
        out["name_high"].append(nh_cnt > 0)
        cursor = s_end + len(sep)
    out["overflow"] = (gat(suffix_sep, cursor, L, L) < L) | (cursor < end)
    return out


def _ci_literal_mask(buf: torch.Tensor, lit: bytes, in_span: torch.Tensor) -> torch.Tensor:
    """[B, L] bool: ``lit`` starts here, letters matched case-insensitively
    (``byte | 0x20``), bytes past L read 0; only positions in the span."""
    m = None
    for k, ch in enumerate(lit):
        col = shift_zero(buf, k)
        part = (col | 0x20) == ch if ord("a") <= ch <= ord("z") else col == ch
        m = part if m is None else m & part
    return m & in_span


def split_setcookie_csr(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor, max_segments: int,
) -> Dict[str, object]:
    """Set-Cookie header span -> up to ``max_segments`` ``", "``-separated
    cookies with the reference's expires-comma rejoin: a part whose first
    case-insensitive ``expires=`` (its 8 bytes inside the part) starts
    within ``_MINIMAL_EXPIRES_LENGTH`` bytes of the part's end is glued to
    the next part, which is not checked again; a held last part is
    dropped (``emit`` False); a glued part whose second half holds too,
    or an emitted part starting with a case-insensitive ``set-cookie``,
    sets ``bad``.  Per slot: seg_start, seg_end, name_end (the first '='
    before the first ';', else the first ';', else the end) and emit;
    ``overflow``: a separator at or after the final cursor, or the cursor
    short of the end (the reference's split_setcookie_csr)."""
    from ..dissectors.cookies import _MINIMAL_EXPIRES_LENGTH

    B, L = buf.shape
    pos = torch.arange(L, device=buf.device, dtype=torch.int32)[None, :]
    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    is_sep = ((buf == ord(",")) & (shift_zero(buf, 1) == ord(" ")) & in_span
              & (pos + 2 <= end[:, None]))
    prefix_mask = _ci_literal_mask(buf, b"set-cookie", in_span)

    # Every per-slot search is "the first occurrence at or after a cursor,
    # if it lies below a bound": one suffix minimum per plane answers all
    # slots with [B] gathers (the reference rebuilds a [B, L] mask per
    # search; the answers are the same).
    def suffix_first(mask):
        m = torch.where(mask, pos, L)
        return torch.flip(torch.cummin(torch.flip(m, [1]), dim=1).values, [1])

    def gat(mat, idx):
        v = torch.gather(mat, 1, idx.clamp(0, L - 1).to(torch.int64)[:, None])[:, 0]
        return torch.where((idx >= L) | (idx < 0), L, v)

    sep_at = suffix_first(is_sep)
    exp_at = suffix_first(_ci_literal_mask(buf, b"expires=", in_span))
    semi_at = suffix_first((buf == ord(";")) & in_span)
    eq_at = suffix_first((buf == ord("=")) & in_span)

    def expires(frm, lim):
        q = gat(exp_at, frm)
        return torch.where(q + 8 <= lim, q, L)

    out = {k: [] for k in ("seg_start", "seg_end", "name_end", "emit")}
    bad = torch.zeros(B, dtype=torch.bool, device=buf.device)
    cursor = start
    for _ in range(max_segments):
        s_end = torch.minimum(gat(sep_at, cursor), end)
        exp = expires(cursor, s_end)
        hold = (exp < L) & (exp > s_end - _MINIMAL_EXPIRES_LENGTH)
        last = s_end >= end
        s_end2 = torch.minimum(gat(sep_at, s_end + 2), end)
        exp2 = expires(s_end + 2, s_end2)
        hold2 = (exp2 < L) & (exp2 > s_end2 - _MINIMAL_EXPIRES_LENGTH)
        merged = hold & ~last
        bad = bad | (merged & hold2)
        seg_e = torch.where(merged, s_end2, s_end)
        semi = gat(semi_at, cursor)
        semi = torch.where(semi < seg_e, semi, L)
        eq = gat(eq_at, cursor)
        eq = torch.where(eq < torch.minimum(semi, seg_e), eq, L)
        emit = (cursor < seg_e) & ~(hold & last)
        at = torch.gather(prefix_mask, 1, cursor.clamp(0, L - 1).to(torch.int64)[:, None])[:, 0]
        bad = bad | (emit & at & (cursor >= 0) & (cursor < L))
        out["seg_start"].append(cursor)
        out["seg_end"].append(seg_e)
        out["name_end"].append(torch.minimum(torch.minimum(eq, semi), seg_e))
        out["emit"].append(emit)
        cursor = seg_e + 2
    out["bad"] = bad
    out["overflow"] = (gat(sep_at, cursor) < L) | (cursor < end)
    return out


def parse_mod_unique_id(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """mod_unique_id spans -> ({time, ip, pid, counter, thread}, ok): the
    24 characters of ``[A-Za-z0-9_-]`` ('-' and '_' standing for base64's
    '+' and '/') decode to 18 bytes -- 32-bit seconds, IPv4, pid, 16-bit
    counter, 32-bit thread index.  The u32 words come back bit-cast to
    int32 (the host re-widens them), the counter as int32; ``ok`` needs
    exactly 24 characters of the alphabet (the reference's
    parse_mod_unique_id)."""
    b = gather_span_bytes(buf, start, 24).to(torch.int64)
    w = end - start
    upper = (b >= ord("A")) & (b <= ord("Z"))
    lower = (b >= ord("a")) & (b <= ord("z"))
    digit = _is_digit(b)
    dash, under = b == ord("-"), b == ord("_")
    ok = (w == 24) & (upper | lower | digit | dash | under).all(dim=1)
    v = torch.where(upper, b - ord("A"), torch.where(
        lower, b - ord("a") + 26, torch.where(
            digit, b - ord("0") + 52, torch.where(dash, 62, 63))))
    g = [(v[:, i] << 18) | (v[:, i + 1] << 12) | (v[:, i + 2] << 6) | v[:, i + 3]
         for i in range(0, 24, 4)]
    words = {
        "time": (g[0] << 8) | (g[1] >> 16),
        "ip": ((g[1] & 0xFFFF) << 16) | (g[2] >> 8),
        "pid": ((g[2] & 0xFF) << 24) | g[3],
        "counter": g[4] >> 8,
        "thread": ((g[4] & 0xFF) << 24) | g[5],
    }
    return {k: wrap_i32(x) for k, x in words.items()}, ok


def parse_secmillis_spans(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """``"<seconds>.<3-digit millis>"`` spans -> ((hi, lo, d18, ndig),
    millis, is_null, ok).

    The seconds part goes through :func:`parse_long_spans` (the sub-span
    before the last four bytes), the dot and the three millis digits come
    from one width-4 window at ``max(end - 4, 0)``; the host combines
    ``seconds * 1000 + millis``.  ``millis`` is computed from the window's
    bytes whatever they are (int32, as the reference).  ok needs
    ``5 <= width <= 19``, a seconds part of digits, a '.' and three
    digits."""
    w = end - start
    sec_limbs, _, sec_ok, sec_big = parse_long_spans(
        buf, start, torch.maximum(end - 4, start), clf=False)
    win = gather_span_bytes(buf, (end - 4).clamp(min=0), 4).to(torch.int32)
    md = (win[:, 1:4] - ord("0")) & 0xFF   # uint8 wrap
    m_ok = (md <= 9).all(dim=1)
    millis = md[:, 0] * 100 + md[:, 1] * 10 + md[:, 2]
    ok = ((w >= 5) & (w <= 19) & sec_ok & ~sec_big & m_ok
          & (win[:, 0] == ord(".")))
    is_null = torch.zeros_like(ok)
    return sec_limbs, millis, is_null, ok


MAX_IP = 15   # 255.255.255.255


def parse_ipv4_spans(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dotted-quad spans -> (value, ok, has_colon).

    ``value`` is the address as int32 (the uint32 bit pattern); ok follows
    ``ipaddress.ip_address`` for IPv4 (exactly four octets, 0-255, no
    leading zeros, width 7 to 15).  ``has_colon`` flags a ':' within the
    first 15 bytes of the span (an IPv6 literal, which the host does look
    up).  Octets accumulate in int32 and the value in uint32 with the
    reference's wraparound, so a rejected span's value is the reference's
    too."""
    B = buf.shape[0]
    dev = buf.device
    b = gather_span_bytes(buf, start, MAX_IP).to(torch.int32)
    w = end - start
    octet = torch.zeros(B, dtype=torch.int32, device=dev)
    ndig = torch.zeros(B, dtype=torch.int32, device=dev)
    ndots = torch.zeros(B, dtype=torch.int32, device=dev)
    value = torch.zeros(B, dtype=torch.int64, device=dev)
    lead0 = torch.zeros(B, dtype=torch.bool, device=dev)
    good = torch.ones(B, dtype=torch.bool, device=dev)
    has_colon = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(MAX_IP):
        in_span = i < w
        byte = b[:, i]
        has_colon = has_colon | (in_span & (byte == ord(":")))
        d = (byte - ord("0")) & 0xFF
        is_digit = d <= 9
        is_dot = byte == ord(".")
        lead0 = lead0 | (in_span & is_digit & (ndig == 1) & (octet == 0))
        octet = torch.where(in_span & is_digit, wrap_i32(octet.to(torch.int64) * 10 + d),
                            octet)
        ndig = torch.where(in_span & is_digit, ndig + 1, ndig)
        good = good & (~in_span | is_digit | is_dot)
        good = good & ~(in_span & (octet > 255))
        close = in_span & is_dot
        good = good & ~(close & (ndig == 0))
        u_oct = octet.to(torch.int64) & 0xFFFFFFFF
        value = torch.where(close, ((value << 8) | u_oct) & 0xFFFFFFFF, value)
        ndots = torch.where(close, ndots + 1, ndots)
        octet = torch.where(close, 0, octet)
        ndig = torch.where(close, 0, ndig)
    value = ((value << 8) | (octet.to(torch.int64) & 0xFFFFFFFF)) & 0xFFFFFFFF
    ok = good & (w >= 7) & (w <= MAX_IP) & (ndots == 3) & (ndig > 0) & ~lead0
    return wrap_i32(value), ok, has_colon


_SUBST_ESCAPES = torch.tensor(list(b"bnrtvx"), dtype=torch.int32)


def unescape_compact_spans_plain(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``unescape_compact_spans`` in PyTorch, the plain
    version of the ``unescape`` kernel: (out [B, width'] uint8, out_len
    [B] int32, exact [B] bool) with ``width' = min(width, L)``.

    ``out`` holds the span's bytes (read as :func:`gather_span_bytes`
    reads them) with every escaping backslash dropped, zeros past
    ``out_len``.  In a maximal backslash run the backslashes at even
    offsets are the escaping bytes of ``\\\\`` pairs; an odd run's last
    backslash is dropped only before a quote, kept before an unknown
    byte, and makes the row inexact before a substituting C-escape
    (``\\b \\n \\r \\t \\v \\x``) or at the span's end.  A span wider
    than ``width'`` is inexact too.  The reference's ``out`` is int32 (a
    TPU lane choice); the values are the same bytes."""
    B, L = buf.shape
    dev = buf.device
    width = min(width, L)
    n = (end - start).clamp(min=0)
    win = gather_span_bytes(buf, start, width).to(torch.int32)
    pos = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    in_span = pos < n[:, None]
    is_bs = (win == ord("\\")) & in_span
    # Offset of each backslash in its run: the distance to the last
    # non-backslash before it (a running max).
    last_non_bs = torch.cummax(torch.where(is_bs, -1, pos.expand(B, width)), dim=1).values
    prev_last = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev),
                           last_non_bs[:, :-1]], dim=1)
    even_offset = ((pos - prev_last) & 1) == 1
    nxt = shift_zero(win, 1)
    nxt_in_span = (pos + 1) < n[:, None]
    last_of_run = is_bs & ~(shift_zero(is_bs, 1) & nxt_in_span)
    odd_tail = last_of_run & even_offset
    escapes_quote = odd_tail & nxt_in_span & (nxt == ord('"'))
    subst = torch.isin(nxt, _SUBST_ESCAPES.to(dev))
    inexact_pos = odd_tail & ((subst & nxt_in_span) | ~nxt_in_span)
    drop = is_bs & even_offset & (~odd_tail | escapes_quote)
    keep = in_span & ~drop
    out_len = keep.sum(dim=1, dtype=torch.int32)
    # Stable compaction: kept bytes first, in order.
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    out = torch.gather(win, 1, order)
    out = torch.where(pos < out_len[:, None], out, 0).to(torch.uint8)
    exact = (n <= width) & ~inexact_pos.any(dim=1)
    return out, out_len, exact


def unescape_compact_spans(buf, start, end, width: int, device=None):
    """Device-side inverse of Apache's ``ap_escape_logitem`` for the
    byte-dropping escapes (``\\"`` -> ``"``, ``\\\\`` -> ``\\``) over the
    spans [start, end) of a [B, L] uint8 buffer: (out [B, min(width, L)]
    uint8, out_len [B] int32, exact [B] bool), as
    :func:`unescape_compact_spans_plain` defines them.  ``exact`` marks
    the rows where ``out[:out_len]`` is the reference's host decode
    (``decode_apache_httpd_log_value``).

    Not on the parse path (quoted fields are delivered verbatim, as the
    reference delivers them): a utility for callers that want the decoded
    bytes on the device.  Inputs are tensors or numpy arrays (numpy goes
    to CUDA unless ``device`` says otherwise); on a CUDA tensor it
    launches the ``unescape`` kernel."""
    from . import kernels
    from .runtime import device_tensor

    buf = device_tensor(buf, device)
    start = device_tensor(start, buf.device)
    end = device_tensor(end, buf.device)
    return kernels.unescape(buf, start, end, width)
