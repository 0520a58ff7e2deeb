"""LogFormat -> device split program (the port's own copy of the reference
package's ``tpu/program.py``; the plausibility-only probe program of
uncompilable formats is a later slice).

This is the device replacement for the reference's per-line regex match
(TokenFormatDissector.java:243-275).  Instead of backtracking over one string,
the compiled token list (dissectors/tokenformat.py) becomes a *split
program*: a short list of vectorizable ops over ``[B, L]`` uint8 buffers —

- ``lit``       match a fixed separator at the cursor,
- ``until_lit`` capture from the cursor to the first occurrence of the next
                separator (the deterministic equivalent of the reference's
                lazy ``.*?`` tokens; greedy tokens are handled optimistically
                the same way),
- ``to_end``    capture the rest of the line.

Every op advances a per-line cursor; validation (separators matched, token
charsets respected, the whole line consumed) yields a per-line validity
mask.  Charsets are supersets of the token regex languages EXCEPT ops
marked ``narrow`` (single-element list approximations): those may
false-invalidate lines the regex accepts — the oracle rescues them —
and must never be used as proof of regex acceptance (plausibility
skips them).
Lines that fail validation but stay plausible are the host oracle's (this
port returns them in ``BatchResult.needs_host``) — the optimistic device
split plus the oracle is bit-exact with the Java regex semantics while
keeping the hot path free of backtracking.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Tuple


import numpy as np

from ..dissectors.tokenformat import (
    FORMAT_CLF_HEXNUMBER,
    FORMAT_CLF_IP,
    FORMAT_CLF_NON_ZERO_NUMBER,
    FORMAT_CLF_NUMBER,
    FORMAT_HEXNUMBER,
    FORMAT_NO_SPACE_STRING,
    FORMAT_NON_ZERO_NUMBER,
    FORMAT_NUMBER,
    FORMAT_NUMBER_DECIMAL,
    FORMAT_NUMBER_OPTIONAL_DECIMAL,
    FORMAT_STANDARD_TIME_ISO8601,
    FORMAT_STANDARD_TIME_US,
    FixedStringToken,
    Token,
    UnsupportedFormatError,
)

# ---------------------------------------------------------------------------
# Charset classes for device-side token validation.  Charsets are SUPERSETS of
# the token regex languages: they can only cause a false-valid on genuinely
# weird lines, never a false-invalid of a line the regex accepts.
# ---------------------------------------------------------------------------

CS_ANY = "any"
CS_NO_SPACE = "no_space"
CS_DIGITS = "digits"
CS_CLF_DIGITS = "clf_digits"        # digits or a lone '-'
CS_HEX = "hex"
CS_CLF_HEX = "clf_hex"
CS_IP = "ip"                        # hex digits, ':', '.', '-'
CS_TIME_US = "time_us"              # 0-9 A-Za-z / : + - and space
CS_TIME_ISO = "time_iso"
CS_NUM_DECIMAL = "num_decimal"      # digits and '.'

_KNOWN_REGEX_CHARSETS = {
    FORMAT_NUMBER: (CS_DIGITS, 1),
    FORMAT_CLF_NUMBER: (CS_CLF_DIGITS, 1),
    FORMAT_NON_ZERO_NUMBER: (CS_DIGITS, 1),
    FORMAT_CLF_NON_ZERO_NUMBER: (CS_CLF_DIGITS, 1),
    FORMAT_HEXNUMBER: (CS_HEX, 1),
    FORMAT_CLF_HEXNUMBER: (CS_CLF_HEX, 1),
    FORMAT_NO_SPACE_STRING: (CS_NO_SPACE, 0),
    FORMAT_CLF_IP: (CS_IP, 1),
    FORMAT_STANDARD_TIME_US: (CS_TIME_US, 26),
    FORMAT_STANDARD_TIME_ISO8601: (CS_TIME_ISO, 25),
    FORMAT_NUMBER_DECIMAL: (CS_NUM_DECIMAL, 3),
    FORMAT_NUMBER_OPTIONAL_DECIMAL: (CS_NUM_DECIMAL, 1),
    "[0-9]+\\.[0-9][0-9][0-9]": (CS_NUM_DECIMAL, 5),  # nginx $msec
    ".*": (CS_ANY, 0),
    ".*?": (CS_ANY, 0),
}

# nginx upstream list regexes (", "-separated elements with ": " redirect
# groups) use their SINGLE-element charset: a one-element list is then
# validated exactly, while any multi-element list (or whitespace-corrupted
# value) contains separator bytes the charset rejects and takes the
# oracle — which is also where multi-element indexing must happen anyway.
# A charset that admitted the separators would make the first-occurrence
# split ambiguous against the regex's backtracking (found by fuzz).


# The three list regexes of the nginx upstream module, as literal values
# (the port does not carry the nginx token table).
_UPSTREAM_LISTS = (
    ("[^\\s]*(?: *, *[^\\s]*(?: *: *[^\\s]*)?)*", CS_NO_SPACE, 0),
    ("[0-9]+(?: *, *[0-9]+(?: *: *[0-9]+)?)*", CS_DIGITS, 1),
    ("[0-9]+\\.[0-9]+(?: *, *[0-9]+\\.[0-9]+(?: *: *[0-9]+\\.[0-9]+)?)*",
     CS_NUM_DECIMAL, 3),
)
_NARROW_REGEXES = {regex for regex, _, _ in _UPSTREAM_LISTS}
for _regex, _cs, _mn in _UPSTREAM_LISTS:
    _KNOWN_REGEX_CHARSETS[_regex] = (_cs, _mn)


def _charset_bytes(name: str) -> np.ndarray:
    """256-entry bool table for a charset class."""
    table = np.zeros(256, dtype=bool)
    if name == CS_ANY:
        table[:] = True
    elif name == CS_NO_SPACE:
        table[:] = True
        for ws in b" \t\n\r\x0b\x0c":
            table[ws] = False
    elif name in (CS_DIGITS,):
        table[ord("0") : ord("9") + 1] = True
    elif name == CS_CLF_DIGITS:
        table[ord("0") : ord("9") + 1] = True
        table[ord("-")] = True
    elif name in (CS_HEX, CS_CLF_HEX):
        table[ord("0") : ord("9") + 1] = True
        table[ord("a") : ord("f") + 1] = True
        table[ord("A") : ord("F") + 1] = True
        if name == CS_CLF_HEX:
            table[ord("-")] = True
    elif name == CS_IP:
        table[ord("0") : ord("9") + 1] = True
        table[ord("a") : ord("f") + 1] = True
        table[ord("A") : ord("F") + 1] = True
        table[ord(":")] = True
        table[ord(".")] = True
        table[ord("-")] = True
    elif name == CS_TIME_US:
        table[ord("0") : ord("9") + 1] = True
        table[ord("a") : ord("z") + 1] = True
        table[ord("A") : ord("Z") + 1] = True
        for c in b"/: +-":
            table[c] = True
    elif name == CS_TIME_ISO:
        table[ord("0") : ord("9") + 1] = True
        for c in b"T:+-":
            table[c] = True
    elif name == CS_NUM_DECIMAL:
        table[ord("0") : ord("9") + 1] = True
        table[ord(".")] = True
    else:  # pragma: no cover
        raise ValueError(name)
    return table


@dataclass(frozen=True)
class SplitOp:
    kind: str                     # "lit" | "until_lit" | "to_end"
    lit: bytes = b""              # separator literal for lit/until_lit
    token_index: int = -1         # capture slot for until_lit/to_end
    charset: str = CS_ANY
    min_len: int = 0
    max_len: int = 0              # 0 = unbounded
    # True when `charset` is NARROWER than the token regex's true set
    # (single-element list approximation): validity may use it to route
    # rejects to the oracle, but PLAUSIBILITY must not — its anchoring
    # assumes charset >= regex so that regex-accept implies plausible.
    narrow: bool = False


@dataclass
class TokenSpec:
    """One captured token: which fields it produces."""

    index: int
    charset: str
    min_len: int
    max_len: int = 0              # 0 = unbounded
    narrow: bool = False
    # (type, name) pairs this token emits (TokenOutputField list)
    outputs: List[Tuple[str, str]] = dataclass_field(default_factory=list)


@dataclass
class DeviceProgram:
    log_format: str
    ops: Tuple[SplitOp, ...]
    tokens: List[TokenSpec]
    charset_table: np.ndarray     # [n_charsets, 256] bool
    charset_ids: Dict[str, int]
    max_lit_len: int


def _token_charset(token: Token) -> Tuple[str, int, int, bool]:
    known = _KNOWN_REGEX_CHARSETS.get(token.regex)
    if known is not None:
        return known[0], known[1], 0, token.regex in _NARROW_REGEXES
    # The "." regex ($pipe) matches EXACTLY one byte; without the max
    # bound the device would accept arbitrarily long spans the real regex
    # rejects — which can silently diverge instead of falling back (a
    # lazy token further left absorbs the difference).  Only the literal
    # dot is modeled: other single-char classes/escapes would need their
    # byte set as the charset to stay sound.
    if token.regex == ".":
        return CS_ANY, 1, 1, False
    return CS_ANY, 0, 0, False


def compile_device_program(dissector) -> DeviceProgram:
    """Compile a (set_log_format-ed) token-format dissector's token list into
    a device split program."""
    tokens = dissector.log_format_tokens
    if not tokens:
        raise UnsupportedFormatError("empty format")

    ops: List[SplitOp] = []
    specs: List[TokenSpec] = []
    i = 0
    n = len(tokens)
    while i < n:
        tok = tokens[i]
        if isinstance(tok, FixedStringToken):
            ops.append(SplitOp("lit", tok.regex.encode("utf-8")))
            i += 1
            continue
        charset, min_len, max_len, narrow = _token_charset(tok)
        spec = TokenSpec(len(specs), charset, min_len, max_len, narrow,
                         [(f.type, f.name) for f in tok.output_fields])
        specs.append(spec)
        # Find the terminating separator: the next fixed token.
        if i + 1 < n:
            nxt = tokens[i + 1]
            if isinstance(nxt, FixedStringToken):
                ops.append(
                    SplitOp("until_lit", nxt.regex.encode("utf-8"),
                            spec.index, charset, min_len, max_len, narrow)
                )
                i += 2  # the separator is consumed by until_lit
                continue
            # Two value tokens back to back: deterministic only if this one
            # has a bounded charset that excludes the next token's first
            # character — not supported in v1.
            raise UnsupportedFormatError(
                f"adjacent value tokens without separator in {dissector.get_log_format()!r}"
            )
        ops.append(SplitOp("to_end", b"", spec.index, charset, min_len,
                           max_len, narrow))
        i += 1

    return _finish_program(dissector, ops, specs)


def compile_plausibility_program(dissector) -> DeviceProgram:
    """Separator-order program for a format compile_device_program
    rejects, used only for the plausibility bit (the multi-format contest
    and the definitely-bad filter), never for values: a run of adjacent
    value tokens collapses into one ``CS_ANY`` capture, a single value
    token keeps its charset, every literal separator stays in order, so
    regex-accept still implies plausible.  An empty format compiles to no
    ops (plausible everywhere)."""
    tokens = dissector.log_format_tokens
    ops: List[SplitOp] = []
    specs: List[TokenSpec] = []
    i = 0
    n = len(tokens)
    while i < n:
        if isinstance(tokens[i], FixedStringToken):
            ops.append(SplitOp("lit", tokens[i].regex.encode("utf-8")))
            i += 1
            continue
        j = i
        while j < n and not isinstance(tokens[j], FixedStringToken):
            j += 1
        if j - i == 1:
            charset, min_len, max_len, narrow = _token_charset(tokens[i])
        else:
            charset, min_len, max_len, narrow = CS_ANY, 0, 0, False
        spec = TokenSpec(len(specs), charset, min_len, max_len, narrow, [])
        specs.append(spec)
        if j < n:
            ops.append(SplitOp("until_lit", tokens[j].regex.encode("utf-8"),
                               spec.index, charset, min_len, max_len, narrow))
            i = j + 1
        else:
            ops.append(SplitOp("to_end", b"", spec.index, charset, min_len,
                               max_len, narrow))
            i = j
    return _finish_program(dissector, ops, specs)


def _finish_program(
    dissector,
    ops: List[SplitOp],
    specs: List[TokenSpec],
) -> DeviceProgram:
    charset_names = sorted({s.charset for s in specs} | {CS_ANY})
    charset_ids = {name: idx for idx, name in enumerate(charset_names)}
    table = np.stack([_charset_bytes(name) for name in charset_names])

    max_lit = max((len(op.lit) for op in ops if op.lit), default=1)
    return DeviceProgram(
        log_format=dissector.get_log_format() or "",
        ops=tuple(ops),
        tokens=specs,
        charset_table=table,
        charset_ids=charset_ids,
        max_lit_len=max_lit,
    )
