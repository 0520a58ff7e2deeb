"""Type-converter dissectors auto-inserted into the graph.

The port's own copy of the reference package's ``dissectors/translate.py``.

Rebuild of httpdlog/httpdlog-parser/.../dissectors/translate/*.java:
1:1 type edges (same name, new type) built on SimpleDissector:
- ConvertCLFIntoNumber: '-' (or null) -> 0
- ConvertNumberIntoCLF: "0" -> null
- ConvertMillisecondsIntoMicroseconds: value * 1000
- ConvertSecondsWithMillisString: "1483455396.639" -> epoch millis
"""
from __future__ import annotations

from typing import List

from ..core.casts import STRING_OR_LONG
from ..core.dissector import Dissector, SimpleDissector
from ..core.fields import ParsedField


class TypeConvertBaseDissector(SimpleDissector):
    def __init__(self, input_type: str = None, output_type: str = None):
        outputs = {} if output_type is None else {output_type + ":": STRING_OR_LONG}
        super().__init__(input_type, outputs)
        self.output_type = output_type

    def get_new_instance(self) -> "Dissector":
        return type(self)(self._input_type, self.output_type)


class ConvertCLFIntoNumber(TypeConvertBaseDissector):
    def dissect_field(self, parsable, input_name: str, pf: ParsedField) -> None:
        s = pf.value.get_string()
        if s is None or s == "-":
            parsable.add_dissection(input_name, self.output_type, "", 0)
        else:
            parsable.add_dissection(input_name, self.output_type, "", pf.value)


class ConvertNumberIntoCLF(TypeConvertBaseDissector):
    def dissect_field(self, parsable, input_name: str, pf: ParsedField) -> None:
        if pf.value.get_string() == "0":
            parsable.add_dissection(input_name, self.output_type, "", None)
        else:
            parsable.add_dissection(input_name, self.output_type, "", pf.value)


class ConvertMillisecondsIntoMicroseconds(TypeConvertBaseDissector):
    def dissect_field(self, parsable, input_name: str, pf: ParsedField) -> None:
        parsable.add_dissection(
            input_name, self.output_type, "", pf.value.get_long() * 1000
        )


class ConvertSecondsWithMillisStringDissector(TypeConvertBaseDissector):
    def dissect_field(self, parsable, input_name: str, pf: ParsedField) -> None:
        seconds_str, _, millis_str = pf.value.get_string().partition(".")
        epoch = int(seconds_str) * 1000 + int(millis_str)
        parsable.add_dissection(input_name, self.output_type, "", epoch)
