"""The engine: dissector registry, demand-driven graph compiler, host executor.

The port's own copy of the reference package's ``core/parser.py``.

Reference behavior: parser-core/.../core/Parser.java (1016 LoC).  The compiler
semantics replicated here:

- assembly (Parser.java:237-356): fixpoint over create_additional_dissectors,
  explode dissectors into (input_type, output_type, name) phases, compute all
  possible subtargets from requested paths, recursively find useful dissectors
  from the root, prepare_for_run every compiled instance, verify nothing
  requested is unreachable (MissingDissectorsException unless ignored).
- findUsefulDissectorsFromField (Parser.java:360-458): wildcard ``*`` outputs
  match any requested path under the current prefix; per-node dissector clones
  via get_new_instance; casts recorded from prepare_for_dissect; type remappings
  recursed with STRING_ONLY casts.
- parse (Parser.java:700-756): worklist loop over to-be-parsed fields invoking
  each compiled phase.
- store (Parser.java:760-876): setter dispatch honoring Casts and SetterPolicy;
  2-arg setters receive the full ``TYPE:path`` id as the name argument.
- getPossiblePaths (Parser.java:904-965): recursive path expansion with
  max-depth guard and cycle avoidance, plus type-remapping paths.

The Parser object is picklable (the Java parser is Serializable for shipping
into Hadoop/Flink tasks, Parser.java:91-97): targets are stored as method-name
specs, resolved against the record instance at store time.
"""
from __future__ import annotations

import inspect
import logging
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
    Union,
)

from .casts import Cast, STRING_ONLY
from .dissector import Dissector
from .exceptions import (
    DissectionFailure,
    OracleEngineError,
    FatalErrorDuringCallOfSetterMethod,
    InvalidDissectorException,
    InvalidFieldMethodSignature,
    MissingDissectorsException,
)
from .fields import (
    SetterPolicy,
    cleanup_field_value,
    get_field_paths,
    get_field_policy,
)
from .parsable import Parsable
from .value import Value

LOG = logging.getLogger(__name__)


class _DissectorPhase:
    __slots__ = ("input_type", "output_type", "name", "instance")

    def __init__(self, input_type: str, output_type: str, name: str, instance: Dissector):
        self.input_type = input_type
        self.output_type = output_type
        self.name = name
        self.instance = instance

    def __repr__(self) -> str:
        return f"Phase({self.input_type}:->{self.output_type}:{self.name})"


class _TargetSpec:
    """One registered setter: resolved lazily by name against the record."""

    __slots__ = ("method_name", "arg_count", "value_type", "policy")

    def __init__(self, method_name: str, arg_count: int, value_type: str, policy: SetterPolicy):
        self.method_name = method_name
        self.arg_count = arg_count  # 1 = (value), 2 = (name, value)
        self.value_type = value_type  # "STRING" | "LONG" | "DOUBLE" | "AUTO"
        self.policy = policy

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _TargetSpec) and (
            self.method_name,
            self.arg_count,
            self.value_type,
            self.policy,
        ) == (other.method_name, other.arg_count, other.value_type, other.policy)

    def __hash__(self) -> int:
        return hash((self.method_name, self.arg_count, self.value_type, self.policy))


_TYPE_NAMES = {str: "STRING", int: "LONG", float: "DOUBLE"}


def _inspect_setter(record_class: Optional[type], fn: Callable) -> Tuple[int, str]:
    """Return (arg_count, value_type) for a setter callable/method."""
    sig = inspect.signature(fn)
    params = [p for p in sig.parameters.values() if p.name != "self"]
    if len(params) not in (1, 2):
        raise InvalidFieldMethodSignature(
            f"Setter {getattr(fn, '__qualname__', fn)} must take (value) or "
            f"(name, value); got {len(params)} parameters"
        )
    value_param = params[-1]
    ann = value_param.annotation
    if ann is inspect.Parameter.empty:
        vtype = "AUTO"
    elif ann in _TYPE_NAMES:
        vtype = _TYPE_NAMES[ann]
    elif isinstance(ann, str):
        vtype = {"str": "STRING", "int": "LONG", "float": "DOUBLE"}.get(ann, "AUTO")
    else:
        vtype = "AUTO"
    if len(params) == 2:
        first = params[0].annotation
        if first not in (inspect.Parameter.empty, str, "str"):
            raise InvalidFieldMethodSignature(
                f"Setter {getattr(fn, '__qualname__', fn)}: the name parameter must be str"
            )
    return len(params), vtype


class Parser:
    """Demand-driven dissection engine, generic over the record type.

    ``record_class`` may be any class; methods decorated with
    :func:`logparser_tpu_torch.core.fields.field` become parse targets automatically
    (the reference scans ``@Field`` annotations in its constructor,
    Parser.java:496-507).
    """

    def __init__(self, record_class: Optional[type] = None):
        self.record_class = record_class
        self.all_dissectors: List[Dissector] = []
        self.root_type: Optional[str] = None
        # field id -> set of target specs
        self.targets: Dict[str, Set[_TargetSpec]] = {}
        self.casts_of_targets: Dict[str, FrozenSet[Cast]] = {}
        self.type_remappings: Dict[str, Set[str]] = {}
        self._assembled = False
        self._fail_on_missing_dissectors = True
        self._compiled: Dict[str, List[_DissectorPhase]] = {}
        self._useful_intermediates: Set[str] = set()
        self._located_targets: Set[str] = set()
        self._needed_frozen: Optional[FrozenSet[str]] = None
        self._last_chance: Dict[str, Tuple[str, Any]] = {}
        # Line-invariant add_dissection routing decisions, keyed by
        # (base, type, name); reset whenever the parser (re)assembles.
        self.dissection_memo: Dict[tuple, tuple] = {}
        self._store_plans: Dict[Any, Any] = {}

        if record_class is not None:
            for name in dir(record_class):
                try:
                    fn = getattr(record_class, name)
                except AttributeError:
                    continue
                paths = get_field_paths(fn)
                if paths is not None:
                    self.add_parse_target(fn, paths, get_field_policy(fn))

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------

    def add_dissector(self, dissector: Optional[Dissector]) -> "Parser":
        if dissector is not None and dissector not in self.all_dissectors:
            self._assembled = False
            self.all_dissectors.append(dissector)
        return self

    def add_dissectors(self, dissectors: Sequence[Dissector]) -> "Parser":
        for d in dissectors:
            self.add_dissector(d)
        return self

    def drop_dissector(self, dissector_class: type) -> "Parser":
        self._assembled = False
        self.all_dissectors = [
            d for d in self.all_dissectors if type(d) is not dissector_class
        ]
        return self

    def set_root_type(self, new_root_type: str) -> "Parser":
        self._assembled = False
        self.root_type = new_root_type
        return self

    def ignore_missing_dissectors(self) -> "Parser":
        self._fail_on_missing_dissectors = False
        return self

    def fail_on_missing_dissectors(self) -> "Parser":
        self._fail_on_missing_dissectors = True
        return self

    # ------------------------------------------------------------------
    # parse targets
    # ------------------------------------------------------------------

    def add_parse_target(
        self,
        setter: Union[str, Callable],
        field_values: Union[str, Sequence[str]],
        setter_policy: SetterPolicy = SetterPolicy.ALWAYS,
    ) -> "Parser":
        self._assembled = False
        if isinstance(field_values, str):
            field_values = [field_values]

        if isinstance(setter, str):
            if self.record_class is None:
                raise InvalidFieldMethodSignature(
                    "Cannot resolve setter by name without a record class"
                )
            fn = getattr(self.record_class, setter, None)
            if fn is None:
                raise InvalidFieldMethodSignature(
                    f"No method {setter!r} on {self.record_class.__name__}"
                )
            method_name = setter
        else:
            fn = setter
            method_name = setter.__name__

        arg_count, value_type = _inspect_setter(self.record_class, fn)
        spec = _TargetSpec(method_name, arg_count, value_type, setter_policy)

        for fv in field_values:
            if fv is None:
                continue
            cleaned = cleanup_field_value(fv)
            if cleaned != fv:
                LOG.warning("The requested %r was converted into %r", fv, cleaned)
            self.targets.setdefault(cleaned, set()).add(spec)
        return self

    # ------------------------------------------------------------------
    # type remapping
    # ------------------------------------------------------------------

    def set_type_remappings(
        self, remappings: Optional[Dict[str, Set[str]]]
    ) -> "Parser":
        self.type_remappings = dict(remappings) if remappings else {}
        return self

    def add_type_remappings(self, additional: Dict[str, Set[str]]) -> "Parser":
        for inp, new_types in additional.items():
            for nt in new_types:
                self.add_type_remapping(inp, nt)
        return self

    def apply_config(
        self,
        type_remappings: Optional[Dict[str, Any]] = None,
        extra_dissectors: Optional[Sequence[Any]] = None,
    ) -> "Parser":
        """One-call string-config wiring shared by every adapter surface:
        remappings values may be a single type name or a collection."""
        for path, types in (type_remappings or {}).items():
            if isinstance(types, str):
                types = [types]
            for new_type in types:
                self.add_type_remapping(path, new_type)
        for dissector in extra_dissectors or ():
            self.add_dissector(dissector)
        return self

    def add_type_remapping(
        self,
        input_path: str,
        new_type: str,
        new_casts: FrozenSet[Cast] = STRING_ONLY,
    ) -> "Parser":
        self._assembled = False
        the_input = input_path.strip().lower()
        the_type = new_type.strip().upper()
        mappings = self.type_remappings.setdefault(the_input, set())
        if the_type not in mappings:
            mappings.add(the_type)
            self.casts_of_targets[the_type + ":" + the_input] = new_casts
        return self

    # ------------------------------------------------------------------
    # assembly
    # ------------------------------------------------------------------

    def get_needed(self) -> Set[str]:
        # Frozen after assembly so each per-line Parsable shares one set
        # instead of copying the target keys on the hot path.
        if self._assembled and self._needed_frozen is not None:
            return self._needed_frozen
        return set(self.targets.keys())

    def get_useful_intermediate_fields(self) -> Set[str]:
        return self._useful_intermediates

    def _assemble_dissector_phases(self) -> List[_DissectorPhase]:
        phases: List[_DissectorPhase] = []
        for dissector in self.all_dissectors:
            input_type = dissector.get_input_type()
            if input_type is None:
                raise InvalidDissectorException(
                    f"Dissector returns None on get_input_type(): [{type(dissector).__name__}]"
                )
            outputs = dissector.get_possible_output()
            if not outputs:
                raise InvalidDissectorException(
                    f"Dissector cannot create any outputs: [{type(dissector).__name__}]"
                )
            for output in outputs:
                out_type, _, name = output.partition(":")
                phases.append(_DissectorPhase(input_type, out_type, name, dissector))
        return phases

    def set_locale(self, locale) -> "Parser":
        """Timestamp locale for every locale-aware dissector (the rebuild's
        parser-level surface over TimeStampDissector.setLocale,
        TimeStampDissector.java:73-78).  Applies to dissectors already
        registered AND to ones added later during assembly (format tokens
        create their own strftime dissectors), so it may be called any
        time before parsing."""
        self._locale = locale
        for d in self.all_dissectors:
            if hasattr(d, "set_locale"):
                d.set_locale(locale)
        self._assembled = False  # re-prepare compiled instances
        return self

    def assemble_dissectors(self) -> None:
        if self._assembled:
            return
        if self.root_type is None:
            raise InvalidDissectorException("No root type was set")
        self.dissection_memo = {}  # targets may have changed since last run
        self._store_plans = {}

        # Fixpoint: dissectors may register additional dissectors recursively.
        done: Set[int] = set()
        locale = getattr(self, "_locale", None)
        while True:
            pending = [d for d in self.all_dissectors if id(d) not in done]
            if not pending:
                break
            for d in pending:
                done.add(id(d))
                if locale is not None and hasattr(d, "set_locale"):
                    d.set_locale(locale)
                d.create_additional_dissectors(self)

        available = self._assemble_dissector_phases()

        needed = self.get_needed()
        needed.add(self.root_type + ":")  # the root name is an empty string

        all_possible_subtargets: Set[str] = set()
        for need in needed:
            needed_name = need.split(":", 1)[1]
            acc = ""
            for part in needed_name.split("."):
                acc = part if (acc == "" or part == "") else acc + "." + part
                all_possible_subtargets.add(acc)

        self._compiled = {}
        self._useful_intermediates = set()
        self._located_targets = set()
        self._find_useful_dissectors(
            available, all_possible_subtargets, self.root_type, "", True
        )

        for phase_list in self._compiled.values():
            for phase in phase_list:
                phase.instance.prepare_for_run()

        if not self._compiled:
            raise MissingDissectorsException(
                "There are no dissectors at all which makes this a completely useless parser."
            )

        if self._fail_on_missing_dissectors:
            missing = self._get_missing_fields()
            if missing:
                raise MissingDissectorsException("\n".join(sorted(missing)))
        self._needed_frozen = frozenset(self.targets.keys())
        self._prepare_last_chance_converters(available)
        self._assembled = True

    def _prepare_last_chance_converters(
        self, available: List[_DissectorPhase]
    ) -> None:
        """Precompute the per-needed-id converter candidates for the
        last-chance pass (see _last_chance_converters): one prepared,
        stateless instance per (needed id), casts registered HERE so parse()
        never mutates shared parser state."""
        self._last_chance: Dict[str, List[Tuple[str, Any]]] = {}
        for nid in self._needed_frozen:
            if nid.endswith("*"):
                continue
            ftype, _, path = nid.partition(":")
            for phase in available:
                if phase.output_type != ftype or phase.name != "":
                    continue
                # Keep EVERY candidate (not just the first): two converters
                # with different input types can produce the same needed
                # type, and which input is cached depends on the line.
                instance = phase.instance.get_new_instance()
                self.casts_of_targets.setdefault(
                    nid, instance.prepare_for_dissect(path, path)
                )
                instance.prepare_for_run()  # full SPI lifecycle, like any phase
                self._last_chance.setdefault(nid, []).append(
                    (phase.input_type, instance)
                )

    def _find_useful_dissectors(
        self,
        available: List[_DissectorPhase],
        possible_targets: Set[str],
        sub_root_type: str,
        sub_root_name: str,
        this_is_the_root: bool,
    ) -> None:
        sub_root_id = sub_root_type + ":" + sub_root_name
        if sub_root_id in self._located_targets:
            return  # avoid infinite recursion
        self._located_targets.add(sub_root_id)

        for phase in available:
            if phase.input_type != sub_root_type:
                continue

            check_fields: Set[str] = set()
            if phase.name == "*":
                # Wildcard output: match requested paths under this prefix.
                prefix = sub_root_name + "."
                for target in possible_targets:
                    if target.startswith(prefix):
                        check_fields.add(target)
            elif this_is_the_root:
                check_fields.add(phase.name)
            elif phase.name == "":
                check_fields.add(sub_root_name)
            else:
                check_fields.add(sub_root_name + "." + phase.name)

            for check_field in check_fields:
                out_id = phase.output_type + ":" + check_field
                if check_field in possible_targets and out_id not in self._compiled:
                    node_phases = self._compiled.get(sub_root_id)
                    if node_phases is None:
                        node_phases = []
                        self._compiled[sub_root_id] = node_phases
                        self._useful_intermediates.add(sub_root_name)

                    instance_phase = None
                    for p in node_phases:
                        if type(p.instance) is type(phase.instance):
                            instance_phase = p
                            break
                    if instance_phase is None:
                        instance_phase = _DissectorPhase(
                            phase.input_type,
                            phase.output_type,
                            check_field,
                            phase.instance.get_new_instance(),
                        )
                        node_phases.append(instance_phase)

                    self.casts_of_targets[out_id] = instance_phase.instance.prepare_for_dissect(
                        sub_root_name, check_field
                    )
                    self._find_useful_dissectors(
                        available, possible_targets, phase.output_type, check_field, False
                    )

        mappings = self.type_remappings.get(sub_root_name)
        if mappings:
            for mapped_type in mappings:
                if (mapped_type + ":" + sub_root_name) not in self._compiled:
                    # Retyped targets are ALWAYS string-only.
                    self.casts_of_targets[mapped_type + ":" + sub_root_name] = STRING_ONLY
                    self._find_useful_dissectors(
                        available, possible_targets, mapped_type, sub_root_name, False
                    )

    def _get_missing_fields(self) -> Set[str]:
        missing: Set[str] = set()
        for target in self.get_needed():
            if target in self._located_targets:
                continue
            if target.endswith("*"):
                if target.endswith(".*"):
                    if target[:-2] not in self._located_targets:
                        missing.add(target)
                # else: ends with ":*" — always "present"
            else:
                missing.add(target)
        return missing

    # ------------------------------------------------------------------
    # parse
    # ------------------------------------------------------------------

    def create_parsable(self, record: Optional[Any] = None) -> Parsable:
        if record is None:
            if self.record_class is None:
                raise InvalidDissectorException("No record class and no record instance")
            record = self.record_class()
        return Parsable(self, record, self.type_remappings)

    def parse(self, value: str, record: Optional[Any] = None) -> Any:
        """Parse one line; returns the (new or given) record."""
        self.assemble_dissectors()
        parsable = self.create_parsable(record)
        parsable.set_root_dissection(self.root_type, value)
        self._run(parsable)
        return parsable.get_record()

    def parse_many(self, lines, record_factory) -> List[Optional[Any]]:
        """Batched parse: one assembly check for the whole batch, one
        fresh record per line.  Returns the parsed record per line, None where the line
        raised DissectionFailure, and an
        :class:`~logparser_tpu_torch.core.exceptions.OracleEngineError` marker
        where the ENGINE itself raised — the shape the batch runtime's
        rescue path consumes.  One broken line must cost itself a
        reasoned reject, never abort the other N-1 lines of the rescue
        batch (the per-line :meth:`parse` keeps raising for its own
        callers)."""
        self.assemble_dissectors()

        out: List[Optional[Any]] = []
        for line in lines:
            record = record_factory()
            try:
                parsable = self.create_parsable(record)
                parsable.set_root_dissection(self.root_type, line)
                self._run(parsable)
                out.append(parsable.get_record())
            except DissectionFailure:
                out.append(None)
            except Exception as e:  # noqa: BLE001 — engine fault, per line
                out.append(OracleEngineError(f"{type(e).__name__}: {e}"))
        return out

    def _run(self, parsable: Parsable) -> Parsable:
        if self._ordered_root() is not None:
            return self._run_ordered(parsable)
        self._drain(parsable)
        self._last_chance_converters(parsable)
        return parsable

    def _drain(self, parsable: Parsable) -> None:
        """The generic worklist: waves of the fields still to dissect."""
        to_be_parsed = set(parsable.to_be_parsed)
        while to_be_parsed:
            for pf in to_be_parsed:
                parsable.set_as_parsed(pf)
                for phase in self._compiled.get(pf.id, ()):
                    phase.instance.dissect(parsable, pf.name)
            to_be_parsed = set(parsable.to_be_parsed)

    # -- the ordered run of a stateless HTTPD root --------------------
    #
    # The reference runs a parser whose root is a stateless multi-format
    # dissector through its compiled line programs (core/fastline.py),
    # which dissect in a fixed order: the root's outputs in token order,
    # then each intermediate's phases first in, first out -- the phases of
    # the dissectors it compiles to value-level emitters before the others
    # -- and whatever a phase of the others adds through the Parsable in
    # the generic waves right after it.  The records equal the generic
    # engine's, but where two producers deliver one field the order
    # decides which value the record keeps, so this run keeps it.

    def _ordered_root(self):
        """The root dissector when the parser takes the ordered run."""
        from ..httpd.format_dissector import HttpdLogFormatDissector

        if self.root_type is None:
            return None
        phases = self._compiled.get(self.root_type + ":", ())
        if len(phases) != 1:
            return None
        root = phases[0].instance
        if not isinstance(root, HttpdLogFormatDissector) or not root.stateless:
            return None
        return root if root.dissectors else None

    def _enqueue_phases(self, queue: list, pf) -> None:
        phases = self._compiled.get(pf.id, ())
        queue.extend((p, pf, True) for p in phases if _emitter_phase(p.instance))
        queue.extend((p, pf, False) for p in phases if not _emitter_phase(p.instance))

    def _run_ordered(self, parsable: Parsable) -> Parsable:
        queue: list = []
        roots = list(parsable.to_be_parsed)
        parsable.to_be_parsed.clear()
        parsable.queue = queue
        for pf in roots:
            for phase in self._compiled.get(pf.id, ()):
                phase.instance.dissect(parsable, pf.name)
        i = 0
        while i < len(queue):
            phase, pf, emitter = queue[i]
            i += 1
            if emitter:
                # An emitter dissects the value it was delivered with.
                held = parsable._cache.get(pf.id)
                parsable._cache[pf.id] = pf
                phase.instance.dissect(parsable, pf.name)
                if held is not None:
                    parsable._cache[pf.id] = held
            else:
                parsable.queue = None
                phase.instance.dissect(parsable, pf.name)
                parsable.queue = queue
            if parsable.to_be_parsed:
                parsable.queue = None
                self._drain(parsable)
                parsable.queue = queue
        parsable.queue = None
        self._last_chance_converters(parsable)
        return parsable

    def _last_chance_converters(self, parsable: Parsable) -> None:
        """Deliver needed ids the compiled tree missed but a pure type
        converter can still produce from the cache.

        The compile guard (`out_id not in _compiled`) wires only ONE
        direction of a converter cycle — necessary for parse termination —
        so with two producers of the same path under different types (e.g.
        `%B ... %b` across two LogFormats plus the CLF<->number
        translators), the direction a given line needs may be the one that
        lost the compile race.  This one-shot, non-recursive pass applies a
        whole-path converter phase (name == "") to a cached field of the
        same path; it cannot loop and is a no-op when everything was
        delivered."""
        candidates = self._last_chance
        if not candidates:
            return
        for nid, options in candidates.items():
            if nid in parsable.delivered:
                continue
            _, _, path = nid.partition(":")
            for input_type, instance in options:
                if parsable.get_parsable_field(input_type, path) is not None:
                    instance.dissect(parsable, path)
                    break

    # ------------------------------------------------------------------
    # store (setter dispatch)
    # ------------------------------------------------------------------

    def _build_store_plan(self, key: str, name: str):
        """Resolve the per-delivery dispatch for one target key ONCE:
        AUTO value types and cast-membership checks are line-invariant, so
        the hot `store` loop reduces to value conversion + policy check +
        the setter call.  Returns (resolved_specs, casts_to) or None after
        logging (unknown key / no casts — matching the uncached errors)."""
        specs = self.targets.get(key)
        if specs is None:
            LOG.error("NO methods for key=%s name=%s", key, name)
            return None
        casts_to = self.casts_of_targets.get(key)
        if casts_to is None:
            casts_to = self.casts_of_targets.get(name)
            if casts_to is None:
                LOG.error('NO casts for "%s"', name)
                return None
        resolved = []
        for spec in specs:
            vtype = spec.value_type
            if vtype == "AUTO":
                if Cast.STRING in casts_to:
                    vtype = "STRING"
                elif Cast.LONG in casts_to:
                    vtype = "LONG"
                elif Cast.DOUBLE in casts_to:
                    vtype = "DOUBLE"
                else:
                    continue
            if vtype == "STRING" and Cast.STRING not in casts_to:
                continue
            if vtype == "LONG" and Cast.LONG not in casts_to:
                continue
            if vtype == "DOUBLE" and Cast.DOUBLE not in casts_to:
                continue
            resolved.append((
                spec.method_name,
                spec.arg_count,
                vtype,
                spec.policy is not SetterPolicy.ALWAYS,     # skip None
                spec.policy is SetterPolicy.NOT_EMPTY,
            ))
        return tuple(resolved), casts_to

    def store(self, record: Any, key: str, name: str, value: Value) -> None:
        # The dispatch plan is line-invariant per key; wildcard keys fall
        # back to per-name casts, so those cache under (key, name).
        plans = self._store_plans
        plan = plans.get(key)
        if plan is None:
            cache_key: Any = key
            if key not in self.casts_of_targets:
                cache_key = (key, name)
                plan = plans.get(cache_key)
            if plan is None:
                plan = self._build_store_plan(key, name)
                if plan is None:
                    return
                plans[cache_key] = plan
        resolved, casts_to = plan

        called_a_setter = False
        for method_name, arg_count, vtype, skip_null, not_empty in resolved:
            if vtype == "STRING":
                out: Any = value.get_string()
            elif vtype == "LONG":
                out = value.get_long()
            else:
                out = value.get_double()

            if out is None and skip_null:
                called_a_setter = True
                continue
            if not_empty and vtype == "STRING" and out == "":
                called_a_setter = True
                continue

            method = getattr(record, method_name, None)
            if method is None:
                raise FatalErrorDuringCallOfSetterMethod(
                    f"Record {type(record).__name__} has no method {method_name!r}"
                )
            try:
                if arg_count == 2:
                    method(name, out)
                else:
                    method(out)
            except Exception as e:  # noqa: BLE001 — mirror FatalError wrapping
                raise FatalErrorDuringCallOfSetterMethod(
                    f'{e} when calling "{method_name}" for key="{key}" '
                    f'name="{name}" value="{value}" casts_to="{casts_to}"'
                ) from e
            called_a_setter = True

        if not called_a_setter:
            raise FatalErrorDuringCallOfSetterMethod(
                f'No setter called for key="{key}" name="{name}" value="{value}"'
            )

    # ------------------------------------------------------------------
    # discovery
    # ------------------------------------------------------------------

    def get_possible_paths(self, max_depth: int = 15) -> List[str]:
        if not self.all_dissectors:
            return []
        try:
            self.assemble_dissectors()
        except (MissingDissectorsException, InvalidDissectorException):
            pass

        paths: List[str] = []
        path_nodes: Dict[str, List[str]] = {}
        for dissector in self.all_dissectors:
            input_type = dissector.get_input_type()
            if input_type is None:
                LOG.error(
                    "Dissector returns None on get_input_type(): [%s]",
                    type(dissector).__name__,
                )
                return []
            outputs = list(dissector.get_possible_output())
            existing = path_nodes.get(input_type)
            if existing:
                outputs.extend(existing)
            path_nodes[input_type] = outputs

        self._find_additional_possible_paths(path_nodes, paths, "", self.root_type, max_depth)

        for input_path, new_types in self.type_remappings.items():
            for new_type in new_types:
                paths.append(new_type + ":" + input_path)
                self._find_additional_possible_paths(
                    path_nodes, paths, input_path, new_type, max_depth - 1
                )
        return paths

    def _find_additional_possible_paths(
        self,
        path_nodes: Dict[str, List[str]],
        paths: List[str],
        base: str,
        base_type: str,
        max_depth: int,
    ) -> None:
        if max_depth == 0:
            return
        for child_path in path_nodes.get(base_type, ()):
            child_type, _, child_name = child_path.partition(":")
            if base == "":
                child_base = child_name
            elif child_name == "":
                child_base = base
            else:
                child_base = base + "." + child_name
            new_path = child_type + ":" + child_base
            if new_path not in paths:
                paths.append(new_path)
                self._find_additional_possible_paths(
                    path_nodes, paths, child_base, child_type, max_depth - 1
                )

    def get_casts(self, path: str) -> Optional[FrozenSet[Cast]]:
        """Casts available for a path (requires the path to be a parse target)."""
        try:
            self.assemble_dissectors()
        except (MissingDissectorsException, InvalidDissectorException):
            pass
        return self.casts_of_targets.get(cleanup_field_value(path))

    # ------------------------------------------------------------------
    # pickling — drop compiled per-node state; reassemble lazily on load
    # (the Java parser re-resolves reflection Methods the same way,
    # Parser.java:91-97, 242-277)
    # ------------------------------------------------------------------

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state["_assembled"] = False
        state["_compiled"] = {}
        state["_useful_intermediates"] = set()
        state["_located_targets"] = set()
        state["_needed_frozen"] = None
        state["_last_chance"] = {}
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)


_EMITTER_TYPES: Dict[type, bool] = {}


def _emitter_phase(dissector) -> bool:
    """Is this one of the dissectors the reference's compiled line programs
    replay as value-level emitters (timestamps, the first line and its
    protocol, the URI, the number converters, the GeoIP lookups)?"""
    got = _EMITTER_TYPES.get(type(dissector))
    if got is None:
        got = _EMITTER_TYPES[type(dissector)] = _is_emitter(dissector)
    return got


def _is_emitter(dissector) -> bool:
    from ..dissectors.firstline import HttpFirstLineDissector, HttpFirstLineProtocolDissector
    from ..dissectors.strftime_stamp import StrfTimeStampDissector
    from ..dissectors.timestamp import TimeStampDissector
    from ..dissectors.translate import (
        ConvertCLFIntoNumber,
        ConvertMillisecondsIntoMicroseconds,
        ConvertNumberIntoCLF,
        ConvertSecondsWithMillisStringDissector,
    )
    from ..dissectors.uri import HttpUriDissector
    from ..geoip.dissectors import (
        GeoIPASNDissector,
        GeoIPCityDissector,
        GeoIPCountryDissector,
        GeoIPISPDissector,
    )

    return (isinstance(dissector, (
        TimeStampDissector, StrfTimeStampDissector, HttpFirstLineDissector,
        HttpFirstLineProtocolDissector, ConvertCLFIntoNumber, ConvertNumberIntoCLF,
        ConvertMillisecondsIntoMicroseconds, ConvertSecondsWithMillisStringDissector))
        or type(dissector) in (HttpUriDissector, GeoIPCountryDissector, GeoIPCityDissector,
                               GeoIPASNDissector, GeoIPISPDissector))
