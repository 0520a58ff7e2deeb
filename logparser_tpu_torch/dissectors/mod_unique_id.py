"""mod_unique_id token decoding: 24 characters -> epoch / ip / processid /
counter / threadindex (the port's own copy of the reference package's
``dissectors/mod_unique_id.py``, as plain functions).

The token is base64 over ``[A-Za-z0-9@-]`` with the alphabet's tail
changed; the reference maps ``+`` and ``/`` to ``@`` and feeds a lenient
decoder that skips characters outside its alphabets, so only 24
characters of ``[A-Za-z0-9_-]`` decode to the 18 bytes: 32-bit seconds,
32-bit IPv4, 32-bit pid, 16-bit counter, 32-bit thread index.  The device
decodes the same tokens (``postproc.parse_mod_unique_id``, the ``muid``
kernel); :func:`decode` is the per-value semantics the tests hold it to.
"""
from __future__ import annotations

import base64
from typing import Dict, Optional, Union

OUTPUTS = {"epoch": "TIME.EPOCH", "ip": "IP", "processid": "PROCESSID",
           "counter": "COUNTER", "threadindex": "THREAD_INDEX"}


def _decode_to_bytes(unique_id: str) -> Optional[bytes]:
    if len(unique_id) != 24:
        return None
    translated = unique_id.replace("+", "@").replace("/", "@")
    std = []
    for c in translated:
        if c.isalnum() or c in "+/=":
            std.append(c)
        elif c == "-":
            std.append("+")
        elif c == "_":
            std.append("/")
        # '@' and anything else: skipped
    data = "".join(std)
    data += "=" * (-len(data) % 4)
    try:
        return base64.b64decode(data)
    except Exception:  # noqa: BLE001 -- the lenient decoder's "nothing"
        return None


def decode(value: Optional[str]) -> Optional[Dict[str, Union[int, str]]]:
    """{output name: value} of one token (epoch in milliseconds, ip
    dotted); None when nothing is delivered."""
    if not value:
        return None
    raw = _decode_to_bytes(value)
    if raw is None or len(raw) != 18:
        return None
    return {
        "epoch": int.from_bytes(raw[0:4], "big") * 1000,
        "ip": ".".join(str(b) for b in raw[4:8]),
        "processid": int.from_bytes(raw[8:12], "big"),
        "counter": int.from_bytes(raw[12:14], "big"),
        "threadindex": int.from_bytes(raw[14:18], "big"),
    }
