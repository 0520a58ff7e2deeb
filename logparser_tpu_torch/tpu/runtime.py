"""Host framing: lines -> a padded ``[B, L]`` uint8 buffer + lengths.

The port's own copy of the reference package's ``tpu/runtime.py``
(``bucket_length`` and ``encode_batch``'s numpy path).  Lines are padded
into a small set of length buckets; lines longer than the cap are
truncated in the buffer and reported, and go to the host.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

# The packed span slots are 13 bits (pipeline._SPAN_BITS), so the device
# path handles lines up to 8191 bytes; only longer lines overflow.
DEFAULT_MAX_LINE_LEN = 8191


def bucket_length(max_len: int, min_bucket: int = 64,
                  cap: int = DEFAULT_MAX_LINE_LEN) -> int:
    """Smallest bucket >= max_len (>= min_bucket, <= cap): a power of two
    up to 128, multiples of 128 up to 512, multiples of 256 up to 1024,
    then powers of two up to cap."""
    if max_len <= min_bucket:
        return min_bucket
    if max_len <= 128:
        return 128 if min_bucket < 128 else min_bucket
    if max_len <= 512:
        size = -(-max_len // 128) * 128
    elif max_len <= 1024:
        size = -(-max_len // 256) * 256
    else:
        size = 2048
        while size < max_len:
            size *= 2
    return min(size, cap)


def encode_batch(
    lines: Sequence[Union[bytes, str]],
    line_len: int = 0,
    min_bucket: int = 64,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Pack lines into a padded [B, L] uint8 buffer + int32 lengths.

    Returns (buffer, lengths, overflow_indices); overflowing lines are
    truncated in the buffer and reported for host-side handling.  One
    trailing ``\\n`` per line is stripped (the host regex's ``$`` matches
    before it, so the device must not see it either)."""
    raw = []
    for line in lines:
        b = line.encode("utf-8") if isinstance(line, str) else line
        if b.endswith(b"\n"):
            b = b[:-1]
        raw.append(b)
    max_len = max((len(r) for r in raw), default=1)
    if line_len <= 0:
        line_len = bucket_length(max_len, min_bucket)
    buf = np.zeros((len(raw), line_len), dtype=np.uint8)
    lengths = np.zeros(len(raw), dtype=np.int32)
    overflow: List[int] = []
    for i, r in enumerate(raw):
        if len(r) > line_len:
            overflow.append(i)
            r = r[:line_len]
        buf[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
        lengths[i] = len(r)
    return buf, lengths, overflow
