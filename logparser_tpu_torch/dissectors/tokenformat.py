"""LogFormat -> token-list compiler (the port's own copy).

The tokenizer of the reference package's ``dissectors/tokenformat.py``:
every :class:`TokenParser` scans the (cleaned) LogFormat for its literal
token, the matches are sorted by position, overlapping / lower-priority
duplicates are kicked, and the holes are filled with
:class:`FixedStringToken` separators.  The per-line regex executor of the
host oracle is not part of this slice; only the token list the device
program compiler consumes is.

Casts are plain strings here (``"STRING"``, ``"LONG"``, ``"DOUBLE"``).
"""
from __future__ import annotations

from typing import FrozenSet, List, Optional, Sequence

# ---------------------------------------------------------------------------
# Regex constant library (the token value languages; the device program
# maps each to a charset class in tpu/program.py).
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

STRING_ONLY: FrozenSet[str] = frozenset({"STRING"})
STRING_OR_LONG: FrozenSet[str] = frozenset({"STRING", "LONG"})


class UnsupportedFormatError(ValueError):
    """The LogFormat cannot be compiled to a device split program by this
    port (an unported token, or two value tokens without a separator)."""


class TokenOutputField:
    """One (type, name, casts) output of a token."""

    __slots__ = ("type", "name", "casts")

    def __init__(self, ftype: str, name: str, casts: FrozenSet[str]):
        self.type = ftype
        self.name = name
        self.casts = casts

    def __repr__(self) -> str:
        return f"{self.type}:{self.name}"


class Token:
    """One matched token instance within a LogFormat."""

    def __init__(self, regex: str, start_pos: int, length: int, prio: int):
        self.regex = regex
        self.start_pos = start_pos
        self.length = length
        self.prio = prio
        self.output_fields: List[TokenOutputField] = []

    def add_output_fields(self, fields: Sequence[TokenOutputField]) -> "Token":
        self.output_fields.extend(fields)
        return self

    def __repr__(self) -> str:
        return f"{{{self.output_fields} ({self.start_pos}+{self.length});Prio={self.prio}}}"


class FixedStringToken(Token):
    """A literal separator between value tokens."""


class TokenParser:
    """One format-token definition: literal token -> outputs + value regex."""

    def __init__(self, log_format_token: str, regex: str = "", prio: int = 0):
        self.log_format_token = log_format_token
        self.regex = regex
        self.prio = prio
        self.output_fields: List[TokenOutputField] = []

    def add_output_field(
        self, ftype: str, name: str, casts: FrozenSet[str]
    ) -> "TokenParser":
        self.output_fields.append(TokenOutputField(ftype, name, casts))
        return self

    def get_next_token(self, log_format: str, start_offset: int) -> Optional[Token]:
        pos = log_format.find(self.log_format_token, start_offset)
        if pos == -1:
            return None
        token = Token(self.regex, pos, len(self.log_format_token), self.prio)
        token.add_output_fields(self.output_fields)
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


class FixedStringTokenParser(TokenParser):
    """E.g. ``%%`` -> literal ``%``."""

    def __init__(self, log_format_token: str, literal: str):
        super().__init__(log_format_token, regex=literal, prio=0)

    def get_next_token(self, log_format: str, start_offset: int) -> Optional[Token]:
        pos = log_format.find(self.log_format_token, start_offset)
        if pos == -1:
            return None
        return FixedStringToken(
            self.regex, pos, len(self.log_format_token), self.prio
        )


def tokenize(cleaned: str, token_parsers: Sequence[TokenParser]) -> List[Token]:
    """Scan the cleaned format with every token parser, resolve overlaps
    by priority/length and fill the holes with fixed-string separators.

    A hole holding a ``%`` is a directive no parser of this port knows:
    it raises :class:`UnsupportedFormatError` instead of becoming a
    literal separator the line would never contain."""
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
        if "%" in text:
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
