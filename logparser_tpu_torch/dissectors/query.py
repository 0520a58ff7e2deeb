"""Query-string dissection: ``HTTP.QUERYSTRING`` -> ``STRING:*`` per parameter.

The port's own copy of the reference package's ``dissectors/query.py``.

Rebuild of httpdlog/httpdlog-parser/.../dissectors/QueryStringFieldDissector.java:
split on ``&``, then ``=``; parameter names lowercased; values url-decoded with
the resilient decoder (:76-108); invalid encodings fail the line.
"""
from __future__ import annotations

from typing import FrozenSet, List, Set

from ..core.casts import Cast, STRING_ONLY
from ..core.dissector import Dissector, extract_field_name
from ..core.exceptions import DissectionFailure
from .utils import resilient_url_decode


class QueryStringFieldDissector(Dissector):
    INPUT_TYPE = "HTTP.QUERYSTRING"

    def __init__(self):
        self.requested: Set[str] = set()
        self.want_all = False

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return ["STRING:*"]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        self.requested.add(extract_field_name(input_name, output_name))
        return STRING_ONLY

    def prepare_for_run(self) -> None:
        self.want_all = "*" in self.requested

    def get_new_instance(self) -> "Dissector":
        return QueryStringFieldDissector()

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        value = field.value.get_string()
        if value is None or value == "":
            return

        for part in value.split("&"):
            equal_pos = part.find("=")
            if equal_pos == -1:
                if part != "":
                    name = part.lower()
                    if self.want_all or name in self.requested:
                        parsable.add_dissection(input_name, "STRING", name, "")
            else:
                name = part[:equal_pos].lower()
                if self.want_all or name in self.requested:
                    try:
                        parsable.add_dissection(
                            input_name,
                            "STRING",
                            name,
                            resilient_url_decode(part[equal_pos + 1 :]),
                        )
                    except ValueError as e:
                        # Invalid encoding in the line.
                        raise DissectionFailure(str(e)) from e
