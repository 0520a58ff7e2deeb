"""Host framing and the split-only entry point.

The port's own copy of the reference package's ``tpu/runtime.py``:

- ``encode_batch``: lines -> a padded ``[B, L]`` uint8 buffer + lengths.
  Lines are padded into a small set of length buckets (``native._bucket``);
  lines longer than the cap are truncated in the buffer and reported, and
  go to the host.  When the C++ framer is built and re-framing the joined
  lines gives the list back exactly, it frames; else a numpy loop does.
- ``run_program``: the split alone over such a buffer, the back-compat
  entry that returns each token's cursors and each line's validity.  On
  the card it launches the ``split`` kernel; on the CPU it runs the
  kernel's plain version.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..native import _bucket, encode_blob, native_available
from .program import DeviceProgram

# The packed span slots are 13 bits (pipeline._SPAN_BITS), so the device
# path handles lines up to 8191 bytes; only longer lines overflow.
DEFAULT_MAX_LINE_LEN = 8191


def bucket_length(max_len: int, min_bucket: int = 64,
                  cap: int = DEFAULT_MAX_LINE_LEN) -> int:
    """Smallest bucket >= max_len (>= min_bucket, <= cap); see
    ``native._bucket``, the one implementation."""
    return _bucket(max_len, min_bucket, cap)


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
    return encode_lines(lines, line_len, min_bucket)[:3]


def encode_lines(
    lines: Sequence[Union[bytes, str]],
    line_len: int = 0,
    min_bucket: int = 64,
    alloc=None,
) -> Tuple[np.ndarray, np.ndarray, List[int], str]:
    """``encode_batch`` with ``encode_blob``'s ``alloc`` hook (used only by
    the native framer; the numpy loop allocates its own arrays), and the
    name of the framer that ran: ``"native"`` or ``"numpy"``."""
    raw = [ln.encode("utf-8") if isinstance(ln, str) else ln for ln in lines]
    joined = b"\n".join(raw)
    if b"\n\n" in joined or joined.endswith(b"\n"):
        # Some line may end in '\n' (each such line is followed by a
        # joining '\n', or ends the join): strip one per line.
        raw = [r[:-1] if r.endswith(b"\n") else r for r in raw]
        joined = None
    # The native framer re-frames the joined lines: only exact when no
    # line is empty, holds a newline (the join then holds exactly len - 1)
    # or ends in '\r' (a '\r' before a joining '\n', or at the end), and
    # the framed count is the list's -- the reference's condition, tested
    # on the joined bytes.
    if raw and all(raw) and native_available():
        if joined is None:
            joined = b"\n".join(raw)
        if (joined.count(b"\n") == len(raw) - 1 and b"\r\n" not in joined
                and not joined.endswith(b"\r")):
            buf, lengths, overflow = encode_blob(
                joined, line_len, min_bucket, cap=DEFAULT_MAX_LINE_LEN, alloc=alloc,
            )
            if buf.shape[0] == len(raw):
                return buf, lengths, overflow, "native"
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
    return buf, lengths, overflow, "numpy"


def device_tensor(x, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """A public entry point's input as a tensor: a tensor stays where it
    is (moved when ``device`` is given); anything else goes to CUDA unless
    ``device`` names another device, and asking for CUDA without a card
    raises."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available "
                           "(pass device='cpu' to run the plain PyTorch versions)")
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def run_program(
    program: DeviceProgram,
    buf,
    lengths,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, torch.Tensor]:
    """Execute the split program: per-token ``starts`` / ``ends`` [T, B]
    int32 and a per-line ``valid`` [B] bool mask.

    ``buf`` [B, L] uint8 and ``lengths`` [B] int32 (lengths <= L) are
    tensors or numpy arrays (see :func:`device_tensor`).  On a CUDA tensor
    it launches the ``split`` kernel (L within ``kernels``' line buckets),
    under tables built once per program object and device; on a CPU
    tensor it runs ``pipeline.compute_split``."""
    from . import kernels, pipeline

    buf = device_tensor(buf, device)
    lengths = device_tensor(lengths, buf.device)
    if buf.is_cuda:
        cache = program.__dict__.setdefault("_split_tables", {})
        tables = cache.get(buf.device)
        if tables is None:
            tables = cache[buf.device] = pipeline.SplitTables(program).to(buf.device)
        starts, ends, flags = kernels.split(tables, buf, lengths)
    else:
        starts, ends, flags = pipeline.compute_split(program, buf, lengths)
    return {"starts": starts, "ends": ends,
            "valid": (flags & pipeline.SPLIT_VALID) != 0}
