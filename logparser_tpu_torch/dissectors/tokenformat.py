"""LogFormat -> token-list compiler and the host (oracle) regex executor
(the port's own copy of the reference package's
``dissectors/tokenformat.py``, the rebuild of the Java tokenformat
package, httpdlog/httpdlog-parser/.../dissectors/tokenformat/):

- :class:`TokenParser` — one format-token definition mapping a literal token
  (e.g. ``%h``) to (output type/name/casts, value regex, priority, optional
  custom dissector).  Regex constant library ported from TokenParser.java:35-65.
- :class:`NamedTokenParser` — token pattern with a regex capture for the field
  *name* (e.g. ``%{referer}i`` -> ``request.header.referer``)
  (NamedTokenParser.java:59-93).
- :class:`ParameterizedTokenParser` — token whose parameter configures a custom
  dissector (e.g. ``%{%d/%b/%Y}t``); a unique TYPE per parameter via an MD5
  suffix so each distinct strftime format gets its own dissector instance
  (ParameterizedTokenParser.java:115-132).
- :class:`TokenFormatDissector` — scans the format with all TokenParsers, sorts
  by position, kicks overlapping/lower-prio duplicates, fills gaps with fixed
  strings (TokenFormatDissector.java:294-379), then compiles ONE anchored regex
  where only demanded tokens get capture groups (:179-213) and runs it per line
  (:243-275).

This host path is the bit-exactness oracle; the device batch path compiles
the same token list into a split program (``tpu/program.py``) through
:func:`tokenize`, which raises :class:`UnsupportedFormatError` for a
directive its caller's token table does not know.
"""
from __future__ import annotations

import hashlib
import re
from typing import TYPE_CHECKING, FrozenSet, List, Optional, Sequence, Set

from ..core.casts import Cast
from ..core.casts import STRING_ONLY, STRING_OR_LONG, STRING_OR_LONG_OR_DOUBLE  # noqa: F401
from ..core.dissector import Dissector
from ..core.exceptions import DissectionFailure

if TYPE_CHECKING:  # pragma: no cover
    from ..core.parsable import Parsable
    from ..core.parser import Parser

# ---------------------------------------------------------------------------
# Regex constant library (TokenParser.java:35-65)
# ---------------------------------------------------------------------------
FORMAT_DIGIT = "[0-9]"
FORMAT_NUMBER = FORMAT_DIGIT + "+"
FORMAT_CLF_NUMBER = FORMAT_NUMBER + "|-"
FORMAT_HEXDIGIT = "[0-9a-fA-F]"
FORMAT_HEXNUMBER = FORMAT_HEXDIGIT + "+"
FORMAT_CLF_HEXNUMBER = FORMAT_HEXNUMBER + "|-"
FORMAT_NON_ZERO_NUMBER = "[1-9][0-9]*"
FORMAT_CLF_NON_ZERO_NUMBER = FORMAT_NON_ZERO_NUMBER + "|-"
FORMAT_EIGHT_BIT_DECIMAL = "(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?)"
FORMAT_IPV4 = "(?:" + FORMAT_EIGHT_BIT_DECIMAL + "\\.){3}" + FORMAT_EIGHT_BIT_DECIMAL
FORMAT_IPV6 = (
    ":?(?:" + FORMAT_HEXDIGIT + "{1,4}(?::|.)?){0,8}(?::|::)?(?:"
    + FORMAT_HEXDIGIT + "{1,4}(?::|.)?){0,8}"
)
FORMAT_IP = FORMAT_IPV4 + "|" + FORMAT_IPV6
FORMAT_CLF_IP = FORMAT_IP + "|-"
FORMAT_STRING = ".*?"
FORMAT_NO_SPACE_STRING = "[^\\s]*"
FIXED_STRING = "FIXED_STRING"
FORMAT_STANDARD_TIME_US = (
    "[0-3][0-9]/(?:[a-zA-Z][a-zA-Z][a-zA-Z])/[1-9][0-9][0-9][0-9]"
    ":[0-9][0-9]:[0-9][0-9]:[0-9][0-9] [\\+|\\-][0-9][0-9][0-9][0-9]"
)
FORMAT_STANDARD_TIME_ISO8601 = (
    "[1-9][0-9][0-9][0-9]-[0-1][0-9]-[0-3][0-9]T[0-9][0-9]:[0-9][0-9]"
    ":[0-9][0-9][\\+|\\-][0-9][0-9]:[0-9][0-9]"
)
FORMAT_NUMBER_DECIMAL = FORMAT_NUMBER + "\\." + FORMAT_NUMBER
FORMAT_NUMBER_OPTIONAL_DECIMAL = FORMAT_NUMBER + "(?:\\." + FORMAT_NUMBER + ")?"


class UnsupportedFormatError(ValueError):
    """The LogFormat cannot be compiled to a device split program by this
    port (an unported token, or two value tokens without a separator)."""


_WARNED: Set[str] = set()


def _warn_once(message: str) -> None:
    """Log a token's warning once per process (every parser build would
    repeat it)."""
    if message not in _WARNED:
        import logging

        _WARNED.add(message)
        logging.getLogger(__name__).warning(message)


class TokenOutputField:
    """Output descriptor (type, name, casts) with optional deprecation warning
    (TokenOutputField.java:58-73)."""

    __slots__ = ("type", "name", "casts", "deprecated_for", "_warned")

    def __init__(self, ftype: str, name: str, casts: FrozenSet[Cast]):
        self.type = ftype
        self.name = name
        self.casts = casts
        self.deprecated_for: Optional[str] = None
        self._warned = False

    def deprecate_for(self, replacement: str) -> "TokenOutputField":
        self.deprecated_for = replacement
        return self

    def was_used(self) -> None:
        if self.deprecated_for and not self._warned:
            self._warned = True
            import logging

            logging.getLogger(__name__).warning(
                "The field %s:%s is deprecated; use %s instead.",
                self.type,
                self.name,
                self.deprecated_for,
            )

    def __repr__(self) -> str:
        return f"{self.type}:{self.name}"


class Token:
    """One matched token instance within a LogFormat (Token.java:30-120)."""

    def __init__(self, regex: str, start_pos: int, length: int, prio: int):
        self.regex = regex
        self.start_pos = start_pos
        self.length = length
        self.prio = prio
        self.output_fields: List[TokenOutputField] = []
        self.custom_dissector: Optional[Dissector] = None
        self.warning_message_when_used: Optional[str] = None
        # A parameterized token's (output type, parameter): the type its
        # custom dissector (e.g. a strftime layout) consumes.
        self.parameter: Optional[tuple] = None

    def add_output_field(
        self, ftype: str, name: str, casts: FrozenSet[Cast]
    ) -> "Token":
        self.output_fields.append(TokenOutputField(ftype, name, casts))
        return self

    def add_output_fields(self, fields: Sequence[TokenOutputField]) -> "Token":
        self.output_fields.extend(fields)
        return self

    def can_produce_a_desired_field_name(self, desired: Set[str]) -> bool:
        return any(f.name in desired for f in self.output_fields)

    def token_was_used(self) -> None:
        if self.warning_message_when_used:
            # slf4j-style: any remaining {} placeholder takes the output
            # fields (the field-name one was filled at token-match time).
            _warn_once(self.warning_message_when_used.replace(
                "{}", str(self.output_fields), 1
            ))

    def __repr__(self) -> str:
        return f"{{{self.output_fields} ({self.start_pos}+{self.length});Prio={self.prio}}}"


class FixedStringToken(Token):
    """A literal separator between value tokens."""


class TokenParser:
    """One format-token definition: literal token -> output spec + value regex."""

    def __init__(
        self,
        log_format_token: str,
        value_name: Optional[str] = None,
        value_type: Optional[str] = None,
        casts: Optional[FrozenSet[Cast]] = None,
        regex: str = "",
        prio: Optional[int] = None,
        custom_dissector: Optional[Dissector] = None,
    ):
        self.log_format_token = log_format_token
        self.regex = regex
        # Java ctor defaults: the value-carrying ctor defaults prio=10, the
        # regex-only ctor defaults prio=0 (TokenParser.java:80-128).
        if prio is None:
            prio = 10 if value_name is not None else 0
        self.prio = prio
        self.custom_dissector = custom_dissector
        self.warning_message_when_used: Optional[str] = None
        self.output_fields: List[TokenOutputField] = []
        if value_name is not None:
            self.add_output_field(value_type, value_name, casts)

    def add_output_field(
        self, ftype: str, name: str, casts: FrozenSet[Cast], deprecate_for: Optional[str] = None
    ) -> "TokenParser":
        f = TokenOutputField(ftype, name, casts)
        if deprecate_for:
            f.deprecate_for(deprecate_for)
        self.output_fields.append(f)
        return self

    def set_warning_message_when_used(self, message: str) -> "TokenParser":
        self.warning_message_when_used = message
        return self

    def get_next_token(self, log_format: str, start_offset: int) -> Optional[Token]:
        pos = log_format.find(self.log_format_token, start_offset)
        if pos == -1:
            return None
        token = Token(self.regex, pos, len(self.log_format_token), self.prio)
        token.add_output_fields(self.output_fields)
        if self.warning_message_when_used:
            token.warning_message_when_used = self.warning_message_when_used
        if not self._add_custom_dissector(
            token, self.output_fields[0].type, self.output_fields[0].name
        ):
            return None
        return token

    def get_tokens(self, log_format: str) -> Optional[List[Token]]:
        if not log_format or not log_format.strip():
            return None
        result: List[Token] = []
        offset = 0
        while True:
            token = self.get_next_token(log_format, offset)
            if token is None:
                break
            result.append(token)
            offset = token.start_pos + token.length
        return result

    def _add_custom_dissector(
        self, token: Token, field_type: str, field_name: str
    ) -> bool:
        if self.custom_dissector is None:
            return True
        try:
            dissector = self.custom_dissector.get_new_instance()
            dissector.set_input_type(field_type)
            if not dissector.initialize_from_settings_parameter(field_name):
                return False
            token.custom_dissector = dissector
        except Exception:  # noqa: BLE001 — any failure invalidates the token
            return False
        return True


class NotImplementedTokenParser(TokenParser):
    """Placeholder for known-but-unsupported variables: output name is
    ``<prefix>_<token mangled>`` of type NOT_IMPLEMENTED
    (TokenFormatDissector.java:89-103)."""

    def __init__(
        self,
        log_format_token: str,
        field_prefix: str,
        regex: str = ".*",
        prio: int = 0,
    ):
        name = field_prefix + "_" + re.sub(
            "[^a-z0-9_]", "_", log_format_token.lower()
        )
        super().__init__(
            log_format_token, name, "NOT_IMPLEMENTED", STRING_ONLY, regex, prio
        )


class FixedStringTokenParser(TokenParser):
    """E.g. ``%%`` -> literal ``%`` (FixedStringTokenParser in the reference)."""

    def __init__(self, log_format_token: str, literal: str):
        super().__init__(log_format_token, regex=literal, prio=0)
        self.literal = literal

    def get_next_token(self, log_format: str, start_offset: int) -> Optional[Token]:
        pos = log_format.find(self.log_format_token, start_offset)
        if pos == -1:
            return None
        return FixedStringToken(
            self.literal, pos, len(self.log_format_token), self.prio
        )


class NamedTokenParser(TokenParser):
    """Token pattern capturing the field name (e.g. ``%{referer}i``)."""

    def __init__(
        self,
        log_format_token_pattern: str,
        value_name_prefix: str,
        value_type: str,
        casts: FrozenSet[Cast],
        regex: str,
        prio: int = 0,
    ):
        super().__init__(
            log_format_token_pattern, value_name_prefix, value_type, casts, regex
        )
        self.prio = prio
        self.pattern = re.compile(log_format_token_pattern)

    def get_next_token(self, log_format: str, start_offset: int) -> Optional[Token]:
        m = self.pattern.search(log_format[start_offset:])
        if m is None:
            return None
        field_name = m.group(1) if m.re.groups > 0 else ""
        token = Token(
            self.regex, start_offset + m.start(), m.end() - m.start(), self.prio
        )
        for f in self.output_fields:
            token.add_output_field(f.type, f.name + field_name, f.casts)
        if self.warning_message_when_used:
            token.warning_message_when_used = self.warning_message_when_used.replace(
                "{}", field_name, 1
            )
        return token


class ParameterizedTokenParser(TokenParser):
    """Token whose ``{parameter}`` configures a custom dissector; the output
    TYPE embeds an MD5 of the parameter so each distinct parameter gets its own
    dissector instance (ParameterizedTokenParser.java:115-132)."""

    def __init__(
        self,
        log_format_token_pattern: str,
        value_name: str,
        value_type: str,
        casts: FrozenSet[Cast],
        regex: str,
        prio: int,
        custom_dissector: Optional[Dissector] = None,
    ):
        super().__init__(
            log_format_token_pattern,
            value_name,
            value_type,
            casts,
            regex,
            custom_dissector=custom_dissector,
        )
        self.prio = prio
        self.pattern = re.compile(log_format_token_pattern)

    def token_parameter_to_type_name(self, parameter: str) -> str:
        md5 = hashlib.md5(parameter.encode("utf-8")).hexdigest()
        cleaned = re.sub("[^A-Za-z0-9]", "", parameter)
        return (self.output_fields[0].type + cleaned + "_" + md5).upper()

    def get_next_token(self, log_format: str, start_offset: int) -> Optional[Token]:
        m = self.pattern.search(log_format[start_offset:])
        if m is None:
            return None
        parameter = m.group(1) if m.re.groups > 0 else ""
        token = Token(
            self.regex, start_offset + m.start(), m.end() - m.start(), self.prio
        )
        field_type = self.token_parameter_to_type_name(parameter)
        for f in self.output_fields:
            token.add_output_field(field_type, f.name, f.casts)
            self._add_custom_dissector_param(token, field_type, parameter)
        token.parameter = (field_type, parameter)
        if self.warning_message_when_used:
            token.warning_message_when_used = self.warning_message_when_used.replace(
                "{}", parameter, 1
            )
        return token

    def _add_custom_dissector_param(
        self, token: Token, field_type: str, parameter: str
    ) -> bool:
        if self.custom_dissector is None:
            return True
        try:
            dissector = self.custom_dissector.get_new_instance()
            dissector.set_input_type(field_type)
            if not dissector.initialize_from_settings_parameter(parameter):
                return False
            token.custom_dissector = dissector
        except Exception:  # noqa: BLE001
            return False
        return True


def tokenize(cleaned: str, token_parsers: Sequence[TokenParser],
             directive: Optional[str] = "%") -> List[Token]:
    """Scan the cleaned format with every token parser, resolve overlaps
    by priority/length and fill the holes with fixed-string separators.

    A hole holding the ``directive`` character (Apache's ``%``) is a
    directive no parser of this port knows: it raises
    :class:`UnsupportedFormatError` instead of becoming a literal
    separator the line would never contain.  NGINX passes None: its
    table ends in a catch-all for unknown ``$variables``."""
    tokens: List[Token] = []
    for tp in token_parsers:
        new_tokens = tp.get_tokens(cleaned)
        if new_tokens:
            tokens.extend(new_tokens)
    tokens.sort(key=lambda t: t.start_pos)

    # Kick duplicates with lower prio / shorter length, and overlaps.
    kicked: List[Token] = []
    prev: Optional[Token] = None
    for token in tokens:
        if prev is None:
            prev = token
            continue
        if prev.start_pos == token.start_pos:
            if prev.length == token.length:
                if prev.prio < token.prio:
                    kicked.append(prev)
                else:
                    kicked.append(token)
                    continue
            elif prev.length < token.length:
                kicked.append(prev)
            else:
                kicked.append(token)
                continue
        elif prev.start_pos + prev.length > token.start_pos:
            kicked.append(token)
            continue
        prev = token
    kicked_ids = {id(t) for t in kicked}
    tokens = [t for t in tokens if id(t) not in kicked_ids]

    def separator(begin: int, end: int) -> FixedStringToken:
        text = cleaned[begin:end]
        if directive is not None and directive in text:
            raise UnsupportedFormatError(
                f"unported LogFormat directive in {text!r} of {cleaned!r}"
            )
        return FixedStringToken(text, begin, end - begin, 0)

    all_tokens: List[Token] = []
    token_end = 0
    for token in tokens:
        if token.start_pos > token_end:
            all_tokens.append(separator(token_end, token.start_pos))
        all_tokens.append(token)
        token_end = token.start_pos + token.length
    if token_end < len(cleaned):
        all_tokens.append(separator(token_end, len(cleaned)))
    return all_tokens


class TokenFormatDissector(Dissector):
    """Abstract format->regex compiler + per-line executor (the oracle path).

    Subclasses provide the token-parser table (``create_all_token_parsers``),
    optional format cleanup, and per-value decoding.
    """

    def __init__(self, log_format: Optional[str] = None):
        self.log_format: Optional[str] = None
        self.log_format_tokens: List[Token] = []
        self.output_types: List[str] = []
        self.requested_fields: Set[str] = set()
        self._input_type: Optional[str] = None
        self._pattern: Optional[re.Pattern] = None
        self._used_tokens: List[Token] = []
        self._regex: Optional[str] = None
        self._usable = False
        if log_format is not None:
            self.set_log_format(log_format)

    # -- abstract hooks -------------------------------------------------

    def create_all_token_parsers(self) -> List[TokenParser]:
        raise NotImplementedError

    def decode_extracted_value(self, token_name: str, value: str) -> Optional[str]:
        """Clean/decode/interpret a raw extracted value."""
        return value

    def cleanup_log_format(self, token_log_format: str) -> str:
        return token_log_format

    # -- configuration --------------------------------------------------

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        self.set_log_format(settings)
        return True

    def initialize_new_instance(self, new_instance: "Dissector") -> None:
        if isinstance(new_instance, TokenFormatDissector) and self.log_format:
            new_instance.set_log_format(self.log_format)

    def set_log_format(self, log_format: str) -> None:
        self.log_format = log_format
        self.log_format_tokens = self._parse_token_log_file_definition(log_format)
        self.output_types = []
        for token in self.log_format_tokens:
            if isinstance(token, FixedStringToken):
                continue
            for f in token.output_fields:
                self.output_types.append(f.type + ":" + f.name)

    def get_log_format(self) -> Optional[str]:
        return self.log_format

    def get_log_format_regex(self) -> Optional[str]:
        return self._regex

    # -- Dissector SPI ---------------------------------------------------

    def set_input_type(self, new_input_type: str) -> None:
        self._input_type = new_input_type

    def get_input_type(self) -> str:
        return self._input_type

    def get_possible_output(self) -> List[str]:
        return list(self.output_types)

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        self.requested_fields.add(output_name)
        for token in self.log_format_tokens:
            for f in token.output_fields:
                if output_name == f.name:
                    f.was_used()
                    return f.casts
        return STRING_ONLY

    def prepare_for_run(self) -> None:
        """Assemble THE anchored regex: capture groups only for demanded tokens
        (TokenFormatDissector.java:179-213)."""
        parts = ["^"]
        self._used_tokens = []
        for token in self.log_format_tokens:
            token.token_was_used()
            if isinstance(token, FixedStringToken):
                parts.append(re.escape(token.regex))
            elif token.can_produce_a_desired_field_name(self.requested_fields):
                self._used_tokens.append(token)
                parts.append("(" + token.regex + ")")
            else:
                parts.append("(?:" + token.regex + ")")
        parts.append("$")
        self._regex = "".join(parts)
        self._pattern = re.compile(self._regex)
        self._usable = True

    def create_additional_dissectors(self, parser: "Parser") -> None:
        for token in self.log_format_tokens:
            if token.custom_dissector is not None:
                parser.add_dissector(token.custom_dissector)

    def dissect(self, parsable: "Parsable", input_name: str) -> None:
        if not self._usable:
            raise DissectionFailure("Dissector in unusable state")
        line_field = parsable.get_parsable_field(self._input_type, input_name)
        line = line_field.value.get_string()

        m = self._pattern.search(line) if line is not None else None
        if m is None:
            raise DissectionFailure(
                "The input line does not match the specified log format."
                f"Line     : {line}\n"
                f"LogFormat: {self.log_format}\n"
                f"RegEx    : {self._regex}"
            )
        for i, token in enumerate(self._used_tokens, start=1):
            matched = m.group(i)
            for f in token.output_fields:
                parsable.add_dissection(
                    input_name,
                    f.type,
                    f.name,
                    self.decode_extracted_value(f.name, matched),
                )

    # -- format compilation ---------------------------------------------

    def _parse_token_log_file_definition(self, token_log_format: str) -> List[Token]:
        """Scan the format with every token parser, resolve overlaps by
        priority/length, fill the gaps with fixed-string separators
        (TokenFormatDissector.java:294-379)."""
        return tokenize(self.cleanup_log_format(token_log_format),
                        self.create_all_token_parsers(), directive=None)

    # -- pickling: compiled patterns regenerate on demand ----------------

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_pattern"] = None
        state["_usable"] = False
        state["_used_tokens"] = []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
