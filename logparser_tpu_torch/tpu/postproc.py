"""Typed span post-stages, plain PyTorch (the CPU versions the
``span_stages`` kernel is held against), and the host-side long combine.

Port of the reference package's ``tpu/postproc.py`` for the stages the
Apache ``combined`` main path runs:

- :func:`gather_span_bytes` — a ``[B, width]`` byte window from a per-row
  start.  The reference builds it from log-shifts (TPU gathers are slow);
  here it is a plain gather with the same result, including the start's
  bits above ``bit_length(L - 1)`` being ignored and zeros past ``L``.
- :func:`parse_long_spans` — digit spans -> a left-aligned 19-digit limb
  frame, CLF ``-`` aware.
- :func:`split_firstline` — ``METHOD URI PROTO`` sub-spans.
- :func:`span_prefix_words` — a span's first 12 bytes as 3 LE int32 words.
- :func:`combine_long_limbs` — the exact uint64 host combine.

Every function reproduces the reference's int32 arithmetic, wraparound
included, so its outputs equal the reference bit for bit on any bytes.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The span's first 12 bytes as 3 little-endian int32 words, bytes at
    or past the span length zeroed, all-zero on rows that are not live."""
    first12 = gather_span_bytes(buf, s, 12).to(torch.int64)
    pos = torch.arange(12, device=buf.device)
    masked = torch.where(
        live[:, None] & (pos[None, :] < (e - s)[:, None]), first12, 0
    )
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

