"""Dissector SPI — the unit of dissection.

The port's own copy of the reference package's ``core/dissector.py``.

Reference behavior: parser-core/.../core/Dissector.java:29-186.  Three-phase
lifecycle documented at Dissector.java:29-61:

1. setup — construct + configure (e.g. set_log_format), or string-config via
   ``initialize_from_settings_parameter`` (Dissector.java:75) for dynamic loading.
2. per-graph-node instancing — the parser clones a dissector per tree node via
   ``get_new_instance``/``initialize_new_instance`` (Dissector.java:135-165), then
   calls ``prepare_for_dissect(input_name, output_name)`` once per demanded output
   (returns the casts for that output) and finally ``prepare_for_run`` once.
3. run — many ``dissect(parsable, input_name)`` calls, one per input field value.

``create_additional_dissectors`` (Dissector.java:173) lets a dissector register
helper dissectors on the parser (run to fixpoint during assembly).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, FrozenSet, List, Optional

from .casts import Cast, STRING_ONLY
from .fields import ParsedField

if TYPE_CHECKING:  # pragma: no cover
    from .parsable import Parsable
    from .parser import Parser


def extract_field_name(input_name: str, output_name: str) -> str:
    """The relative output name below the input name
    (Dissector.extractFieldName, Dissector.java:147-157): equal names yield
    the empty relative name (used by empty-named outputs)."""
    if input_name == output_name:
        return ""
    if input_name and output_name.startswith(input_name + "."):
        return output_name[len(input_name) + 1 :]
    return output_name


class Dissector:
    """Abstract dissector. Subclasses declare input type + possible outputs and
    implement ``dissect``."""

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        """String-config entry point used by engine adapters that load dissectors
        dynamically from a single string parameter. True = success."""
        return False

    def dissect(self, parsable: "Parsable", input_name: str) -> None:
        raise NotImplementedError

    def get_input_type(self) -> str:
        raise NotImplementedError

    def set_input_type(self, new_input_type: str) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support set_input_type"
        )

    def get_possible_output(self) -> List[str]:
        """List of ``TYPE:name`` outputs this dissector can produce."""
        raise NotImplementedError

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        """Called during assembly for every demanded output; returns its casts.
        Dissectors use this to learn which outputs to actually compute."""
        return STRING_ONLY

    def prepare_for_run(self) -> None:
        """Called once after all prepare_for_dissect calls; compile here."""

    def get_new_instance(self) -> "Dissector":
        new = type(self)()
        self.initialize_new_instance(new)
        return new

    def initialize_new_instance(self, new_instance: "Dissector") -> None:
        """Copy configuration onto a freshly constructed clone."""

    def create_additional_dissectors(self, parser: "Parser") -> None:
        """Register helper dissectors on the parser (may recurse via fixpoint)."""


class SimpleDissector(Dissector):
    """Convenience base with a declarative ``{output path -> casts}`` map.

    Reference behavior: parser-core/.../core/SimpleDissector.java:38-89 — the
    constructor records input type and output map; ``dissect`` fetches the input
    field and delegates to ``dissect_value``.
    """

    def __init__(self, input_type: str, outputs: Dict[str, FrozenSet[Cast]]):
        self._input_type = input_type
        # output config: "TYPE:name" -> (type, name, casts)
        self._output_casts: Dict[str, FrozenSet[Cast]] = {}
        self._outputs: List[str] = []
        for path, casts in outputs.items():
            self._outputs.append(path)
            self._output_casts[path] = casts

    def get_input_type(self) -> str:
        return self._input_type

    def set_input_type(self, new_input_type: str) -> None:
        self._input_type = new_input_type

    def get_possible_output(self) -> List[str]:
        return list(self._outputs)

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        for path, casts in self._output_casts.items():
            name = path.split(":", 1)[1]
            # An empty output name is a 1:1 type edge (the translate/
            # dissectors): the output IS the input path, any name matches
            # (TypeConvertBaseDissector semantics).
            if name == "" or output_name == name or output_name.endswith("." + name):
                return casts
        return STRING_ONLY

    def get_new_instance(self) -> "Dissector":
        import copy

        new = copy.copy(self)
        self.initialize_new_instance(new)
        return new

    def dissect(self, parsable: "Parsable", input_name: str) -> None:
        parsed_field: Optional[ParsedField] = parsable.get_parsable_field(
            self._input_type, input_name
        )
        if parsed_field is not None:
            self.dissect_field(parsable, input_name, parsed_field)

    def dissect_field(
        self, parsable: "Parsable", input_name: str, parsed_field: ParsedField
    ) -> None:
        raise NotImplementedError
