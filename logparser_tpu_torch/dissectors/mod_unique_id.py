"""mod_unique_id token decoding: 24 characters -> epoch / ip / processid /
counter / threadindex (the port's own copy of the reference package's
``dissectors/mod_unique_id.py``, as plain functions).

The token is base64 over ``[A-Za-z0-9@-]`` with the alphabet's tail
changed; the reference maps ``+`` and ``/`` to ``@`` and feeds a lenient
decoder that skips characters outside its alphabets, so only 24
characters of ``[A-Za-z0-9_-]`` decode to the 18 bytes: 32-bit seconds,
32-bit IPv4, 32-bit pid, 16-bit counter, 32-bit thread index.  The device
decodes the same tokens (``postproc.parse_mod_unique_id``, the ``muid``
kernel); :func:`decode` is the per-value semantics the tests hold it to,
and :class:`ModUniqueIdDissector` the host oracle's dissector over it
(ModUniqueIdDissector.java).
"""
from __future__ import annotations

import base64
from typing import Dict, FrozenSet, List, Optional, Set, Union

from ..core.casts import Cast, NO_CASTS, STRING_OR_LONG
from ..core.dissector import Dissector, extract_field_name

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


class ModUniqueIdDissector(Dissector):
    INPUT_TYPE = "MOD_UNIQUE_ID"

    def __init__(self):
        self.wanted: Set[str] = set()

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return [f"{t}:{name}" for name, t in OUTPUTS.items()]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        name = extract_field_name(input_name, output_name)
        if name in OUTPUTS:
            self.wanted.add(name)
            return STRING_OR_LONG
        return NO_CASTS

    def get_new_instance(self) -> "Dissector":
        return ModUniqueIdDissector()

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        values = decode(field.value.get_string())
        if values is None:
            return
        for name, out_type in OUTPUTS.items():
            if name in self.wanted:
                parsable.add_dissection(input_name, out_type, name, values[name])
