"""Per-line mutable parse state for the host (oracle) execution path.

The port's own copy of the reference package's ``core/parsable.py``.

Reference behavior: parser-core/.../core/Parsable.java:40-219 — keeps a cache of
intermediate ParsedFields, a worklist of fields still to be dissected, and routes
finished values to the parser's store().  addDissection computes the complete
dotted name, applies type remappings (recursively, once), caches useful
intermediates, and stores values that are needed directly or via a wildcard
(``TYPE:base.*``) target.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Set, Union

from .exceptions import DissectionFailure
from .fields import ParsedField, make_field_id
from .value import Value

if TYPE_CHECKING:  # pragma: no cover
    from .parser import Parser


class Parsable:
    def __init__(
        self,
        parser: "Parser",
        record: Any,
        type_remappings: Dict[str, Set[str]],
    ):
        self.parser = parser
        self.record = record
        self.type_remappings = type_remappings
        self.needed: Set[str] = parser.get_needed()
        self.useful_intermediates: Set[str] = parser.get_useful_intermediate_fields()
        self._cache: Dict[str, ParsedField] = {}
        self.to_be_parsed: Set[ParsedField] = set()
        # Exact needed ids actually delivered to the record (drives the
        # last-chance converter pass in Parser._run).
        self.delivered: Set[str] = set()
        # Parser._run_ordered's first-in, first-out (phase, field, fast)
        # queue while it runs; None: the generic waves of to_be_parsed.
        self.queue: Optional[list] = None

    def set_root_dissection(self, root_type: str, value: Union[str, Value]) -> None:
        pf = ParsedField(root_type, "", value)  # the root name is an empty string
        self._cache[pf.id] = pf
        self.to_be_parsed.add(pf)

    def add_dissection(
        self,
        base: str,
        ftype: str,
        name: str,
        value: Union[Value, str, int, float, None],
        _recursion: bool = False,
    ) -> "Parsable":
        # Dissectors add every output they produce; most are unwanted, and
        # the routing decision for a given (base, type, name) triple is
        # LINE-INVARIANT — memoize it on the parser so the common unwanted
        # case costs one dict probe and no object construction.
        memo = self.parser.dissection_memo
        entry = memo.get((base, ftype, name))
        if entry is None:
            if base == "":  # the root name is an empty string
                complete_name = name
                needed_wildcard = ftype + ":*"
            else:
                complete_name = base if name == "" else base + "." + name
                needed_wildcard = ftype + ":" + base + ".*"
            needed_name = ftype + ":" + complete_name
            remapped = self.type_remappings.get(complete_name)
            entry = (
                tuple(remapped) if remapped else (),
                complete_name in self.useful_intermediates,
                needed_name in self.needed,
                needed_wildcard in self.needed,
                complete_name,
                needed_name,
                needed_wildcard,
            )
            memo[(base, ftype, name)] = entry
        (remapped_types, is_intermediate, is_needed, is_wild,
         complete_name, needed_name, needed_wildcard) = entry

        if not _recursion:
            for new_type in remapped_types:
                if new_type == ftype:
                    raise DissectionFailure(
                        "[Type Remapping] Trying to map to the same type "
                        f"(mapping definition bug!): base={base} type={ftype} name={name}"
                    )
                self.add_dissection(base, new_type, name, value, _recursion=True)

        if not (is_intermediate or is_needed or is_wild):
            return self

        if not isinstance(value, Value):
            value = Value(value)

        if is_intermediate:
            pf = ParsedField(ftype, complete_name, value)
            self._cache[pf.id] = pf
            if self.queue is not None:
                self.parser._enqueue_phases(self.queue, pf)
            else:
                self.to_be_parsed.add(pf)

        if is_needed:
            self.delivered.add(needed_name)
            self.parser.store(self.record, needed_name, needed_name, value)

        if is_wild:
            self.parser.store(self.record, needed_wildcard, needed_name, value)
        return self

    def get_parsable_field(self, ftype: str, name: str) -> Optional[ParsedField]:
        return self._cache.get(make_field_id(ftype, name))

    def get_record(self) -> Any:
        return self.record

    def set_as_parsed(self, parsed_field: ParsedField) -> None:
        self.to_be_parsed.discard(parsed_field)
