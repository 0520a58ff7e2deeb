"""The Apache HTTPD ``%``-token table, cut to the tokens of ``common``,
``combined`` and ``combinedio`` (``%I`` / ``%O``), ``%B``, the strftime
timestamps ``%{format}t`` / ``%{begin:format}t`` / ``%{end:format}t``,
the typed cookie headers, one request cookie ``%{name}C`` and an
environment variable ``%{name}e`` (mod_unique_id's ``%{UNIQUE_ID}e``)
(the port's own copy of the reference package's ``httpd/apache.py``).

Same format cleanup (``%!200,304{...}`` modifiers stripped, header names
lower-cased, ``%t`` -> ``[%t]``, ``%{...}t`` left alone), the same ``<`` /
``>`` original/last twin outputs per token, and the same named-format
aliases for the three formats.  Any other directive raises
:class:`~logparser_tpu_torch.dissectors.tokenformat.UnsupportedFormatError`
from the tokenizer.
"""
from __future__ import annotations

import re
from typing import FrozenSet, List, Optional

from ..dissectors.tokenformat import (
    FORMAT_CLF_NUMBER,
    FORMAT_NO_SPACE_STRING,
    FORMAT_NUMBER,
    FORMAT_STANDARD_TIME_US,
    FORMAT_STRING,
    STRING_ONLY,
    ParameterizedTokenParser,
    STRING_OR_LONG,
    FixedStringTokenParser,
    NamedTokenParser,
    Token,
    TokenOutputField,
    TokenParser,
    tokenize,
)

# %-directives that look at the ORIGINAL request by default; all others
# look at the final ("last") request (mod_log_config modifiers).
_ORIGINAL_DEFAULT_TOKENS = {
    "%s", "%U", "%T", "%{us}T", "%{ms}T", "%{s}T", "%D", "%r",
}

NAMED_FORMATS = {
    "common": '%h %l %u %t "%r" %>s %b',
    "combined": '%h %l %u %t "%r" %>s %b "%{Referer}i" "%{User-Agent}i"',
    "combinedio": '%h %l %u %t "%r" %>s %b "%{Referer}i" "%{User-Agent}i" %I %O',
}



def looks_like_apache_format(log_format: str) -> bool:
    """Chosen before NGINX: any ``%`` or a named Apache format."""
    if "%" in log_format:
        return True
    return log_format.lower() in NAMED_FORMATS


_MODIFIER_RE = re.compile("%!?[0-9]{3}(?:,[0-9]{3})*")
_HEADER_NAME_RE = re.compile(r"%\{([^}]*)\}([^t])")


def cleanup_log_format(token_log_format: str) -> str:
    result = _MODIFIER_RE.sub("%", token_log_format)
    result = _HEADER_NAME_RE.sub(
        lambda m: "%{" + m.group(1).lower() + "}" + m.group(2), result
    )
    # %t maps to the actual time format surrounded by [ ].
    return result.replace("%t", "[%t]")


def _first_and_last(
    token: str,
    name: str,
    ftype: str,
    casts: FrozenSet[str],
    regex: str,
    prio: int = 0,
) -> List[TokenParser]:
    """The %X / %<X / %>X triple with .original/.last twin outputs."""
    base = TokenParser(token, regex=regex, prio=prio)
    base.add_output_field(ftype, name, casts)
    if token in _ORIGINAL_DEFAULT_TOKENS:
        base.add_output_field(ftype, name + ".original", casts)
    else:
        base.add_output_field(ftype, name + ".last", casts)
    original = TokenParser(token.replace("%", "%<", 1), regex=regex, prio=prio)
    original.add_output_field(ftype, name + ".original", casts)
    last = TokenParser(token.replace("%", "%>", 1), regex=regex, prio=prio)
    last.add_output_field(ftype, name + ".last", casts)
    return [base, original, last]


def create_token_parsers() -> List[TokenParser]:
    p: List[TokenParser] = [FixedStringTokenParser("%%", "%")]
    # %B bytes (0 rather than '-').
    p.extend(_first_and_last("%B", "response.body.bytes", "BYTES",
                             STRING_OR_LONG, FORMAT_NUMBER))
    # %b CLF bytes ('-' rather than 0), plus its deprecated BYTES twin.
    bytes_clf = _first_and_last("%b", "response.body.bytes", "BYTESCLF",
                                STRING_OR_LONG, FORMAT_CLF_NUMBER)
    bytes_clf[0].output_fields.append(
        TokenOutputField("BYTES", "response.body.bytesclf", STRING_OR_LONG)
    )
    p.extend(bytes_clf)
    # %{Foobar}C one request cookie, %{FOOBAR}e one environment variable.
    p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}C", "request.cookies.",
                              "HTTP.COOKIE", STRING_ONLY, FORMAT_STRING))
    p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}e", "server.environment.",
                              "VARIABLE", STRING_ONLY, FORMAT_STRING))
    p.extend(_first_and_last("%h", "connection.client.host", "IP",
                             STRING_ONLY, FORMAT_NO_SPACE_STRING))
    p.extend(_first_and_last("%l", "connection.client.logname", "NUMBER",
                             STRING_OR_LONG, FORMAT_CLF_NUMBER))
    # %r: the regex is reduced to survive garbage request lines.
    p.extend(_first_and_last("%r", "request.firstline", "HTTP.FIRSTLINE",
                             STRING_ONLY, ".*"))
    p.extend(_first_and_last("%s", "request.status", "STRING",
                             STRING_ONLY, FORMAT_NO_SPACE_STRING, 0))
    p.extend(_first_and_last("%t", "request.receive.time", "TIME.STAMP",
                             STRING_ONLY, FORMAT_STANDARD_TIME_US))
    # %{format}t strftime timestamps (begin: / end: prefixed at prio 0
    # beat the plain form at prio -1); each distinct format is a type.
    for pattern, name, prio in (
        (r"\%\{([^\}]*%[^\}]*)\}t", "request.receive.time", -1),
        (r"\%\{begin:([^\}]*%[^\}]*)\}t", "request.receive.time.begin", 0),
        (r"\%\{end:([^\}]*%[^\}]*)\}t", "request.receive.time.end", 0),
    ):
        p.append(ParameterizedTokenParser(pattern, name, "TIME.STRFTIME_",
                                          STRING_ONLY, FORMAT_STRING, prio))
    # %I / %O bytes received / sent (mod_logio).
    p.extend(_first_and_last("%I", "request.bytes", "BYTES",
                             STRING_OR_LONG, FORMAT_CLF_NUMBER))
    p.extend(_first_and_last("%O", "response.bytes", "BYTES",
                             STRING_OR_LONG, FORMAT_CLF_NUMBER))
    p.extend(_first_and_last("%u", "connection.client.user", "STRING",
                             STRING_ONLY, FORMAT_NO_SPACE_STRING))
    p.extend(_first_and_last("%{user-agent}i", "request.user-agent",
                             "HTTP.USERAGENT", STRING_ONLY, FORMAT_STRING, 1))
    p.extend(_first_and_last("%{referer}i", "request.referer", "HTTP.URI",
                             STRING_ONLY, FORMAT_STRING, 1))
    p.extend(_first_and_last("%{cookie}i", "request.cookies", "HTTP.COOKIES",
                             STRING_ONLY, FORMAT_STRING, 1))
    p.extend(_first_and_last("%{set-cookie}o", "response.cookies",
                             "HTTP.SETCOOKIES", STRING_ONLY, FORMAT_STRING, 1))
    return p


class ApacheLogFormat:
    """One Apache LogFormat resolved to its token list (the part of the
    reference's ApacheHttpdLogFormatDissector the device compiler reads)."""

    def __init__(self, log_format: str):
        self.log_format = NAMED_FORMATS.get(log_format.lower(), log_format)
        self.log_format_tokens: List[Token] = tokenize(
            cleanup_log_format(self.log_format), create_token_parsers()
        )
        # {TIME.STRFTIME_... type: its strftime format}
        self.strftime_types = dict(t.parameter for t in self.log_format_tokens
                                   if t.parameter is not None)

    def get_log_format(self) -> Optional[str]:
        return self.log_format
