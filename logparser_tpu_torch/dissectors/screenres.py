"""Screen resolution dissection: "1024x768" -> width/height.

The port's own copy of the reference package's ``dissectors/screenres.py``.

Rebuild of httpdlog/httpdlog-parser/.../dissectors/ScreenResolutionDissector.java
(:59-76; separator configurable via the settings parameter).
"""
from __future__ import annotations

from typing import FrozenSet, List, Set

from ..core.casts import Cast, NO_CASTS, STRING_OR_LONG
from ..core.dissector import Dissector, extract_field_name

SCREENRESOLUTION = "SCREENRESOLUTION"


class ScreenResolutionDissector(Dissector):
    def __init__(self, separator: str = "x"):
        self.separator = separator
        self.wanted: Set[str] = set()

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        if settings:
            self.separator = settings
        return True

    def get_input_type(self) -> str:
        return SCREENRESOLUTION

    def get_possible_output(self) -> List[str]:
        return ["SCREENWIDTH:width", "SCREENHEIGHT:height"]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        name = extract_field_name(input_name, output_name)
        if name in ("width", "height"):
            self.wanted.add(name)
            return STRING_OR_LONG
        return NO_CASTS

    def get_new_instance(self) -> "Dissector":
        return ScreenResolutionDissector(self.separator)

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(SCREENRESOLUTION, input_name)
        value = field.value.get_string()
        if value is None or value == "":
            return
        if self.separator in value:
            parts = value.split(self.separator)
            if "width" in self.wanted:
                parsable.add_dissection(input_name, "SCREENWIDTH", "width", parts[0])
            if "height" in self.wanted:
                parsable.add_dissection(input_name, "SCREENHEIGHT", "height", parts[1])
