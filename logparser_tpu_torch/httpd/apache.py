"""The Apache HTTPD ``%``-token table (the port's own copy of the reference
package's ``httpd/apache.py``).

Rebuild of httpdlog/httpdlog-parser/.../httpdlog/ApacheHttpdLogFormatDissector.java:
~60 token parsers covering the mod_log_config directive set (createAllTokenParsers
:200-638), named-format aliases common/combined/combinedio/referer/agent (:81-101),
format cleanup (strip ``%!?200,304{...}`` modifiers :137-149, lowercase header
names :121-135, ``%t`` -> ``[%t]`` :151-159), and the ``<``/``>``
original/last modifier semantics producing ``.original``/``.last`` twin outputs
per token (:651-714).

The host oracle runs the whole table.  The device split compiles the
tokens of ``common``, ``combined`` and ``combinedio`` (``%I`` / ``%O``),
``%B``, the strftime timestamps ``%{format}t`` / ``%{begin:format}t`` /
``%{end:format}t``, the typed cookie headers, one request cookie
``%{name}C`` and an environment variable ``%{name}e`` (mod_unique_id's
``%{UNIQUE_ID}e``): :class:`ApacheLogFormat` tokenizes with that part of
the table (:func:`create_token_parsers`), and any other directive raises
:class:`~logparser_tpu_torch.dissectors.tokenformat.UnsupportedFormatError`.
"""
from __future__ import annotations

import re
from typing import FrozenSet, List, Optional

from ..core.casts import Cast, STRING_ONLY, STRING_OR_LONG
from ..dissectors.tokenformat import (
    FORMAT_CLF_HEXNUMBER,
    FORMAT_CLF_IP,
    FORMAT_CLF_NUMBER,
    FORMAT_NO_SPACE_STRING,
    FORMAT_NON_ZERO_NUMBER,
    FORMAT_NUMBER,
    FORMAT_STANDARD_TIME_US,
    FORMAT_STRING,
    FixedStringTokenParser,
    NamedTokenParser,
    ParameterizedTokenParser,
    TokenFormatDissector,
    TokenOutputField,
    TokenParser,
    UnsupportedFormatError,  # noqa: F401 -- raised by tokenize
    Token,
    tokenize,
)
from .utils_apache import decode_extracted_apache_value

INPUT_TYPE = "HTTPLOGLINE"

# %-directives that look at the ORIGINAL request by default; all others look at
# the final ("last") request (mod_log_config modifiers doc,
# ApacheHttpdLogFormatDissector.java:662-689).
_ORIGINAL_DEFAULT_TOKENS = {
    "%s", "%U", "%T", "%{us}T", "%{ms}T", "%{s}T", "%D", "%r",
}

# Commonly used named logformats from the Apache HTTPD manual
# (ApacheHttpdLogFormatDissector.java:74-99).
NAMED_FORMATS = {
    "common": '%h %l %u %t "%r" %>s %b',
    "combined": '%h %l %u %t "%r" %>s %b "%{Referer}i" "%{User-Agent}i"',
    "combinedio": '%h %l %u %t "%r" %>s %b "%{Referer}i" "%{User-Agent}i" %I %O',
    "referer": "%{Referer}i -> %U",
    "agent": "%{User-agent}i",
}

_MODIFIER_RE = re.compile("%!?[0-9]{3}(?:,[0-9]{3})*")
_HEADER_NAME_RE = re.compile(r"%\{([^}]*)\}([^t])")


def looks_like_apache_format(log_format: str) -> bool:
    """Chosen before NGINX: any ``%`` or a named Apache format."""
    if "%" in log_format:
        return True
    return log_format.lower() in NAMED_FORMATS


def cleanup_log_format(token_log_format: str) -> str:
    result = _MODIFIER_RE.sub("%", token_log_format)
    result = _HEADER_NAME_RE.sub(
        lambda m: "%{" + m.group(1).lower() + "}" + m.group(2), result
    )
    # %t maps to the actual time format surrounded by [ ].
    return result.replace("%t", "[%t]")


class ApacheHttpdLogFormatDissector(TokenFormatDissector):
    def __init__(self, log_format: Optional[str] = None):
        super().__init__(log_format)
        self.set_input_type(INPUT_TYPE)

    def set_log_format(self, log_format: str) -> None:
        resolved = NAMED_FORMATS.get(log_format.lower(), log_format)
        super().set_log_format(resolved)

    # -- format cleanup --------------------------------------------------

    def cleanup_log_format(self, token_log_format: str) -> str:
        return cleanup_log_format(token_log_format)

    # -- value decode ----------------------------------------------------

    def decode_extracted_value(self, token_name: str, value: str) -> Optional[str]:
        return decode_extracted_apache_value(token_name, value)

    # -- token table -----------------------------------------------------

    def create_all_token_parsers(self) -> List[TokenParser]:
        p: List[TokenParser] = []

        # %% The percent sign
        p.append(FixedStringTokenParser("%%", "%"))

        # %a Remote IP-address
        p.extend(self._first_and_last("%a", "connection.client.ip", "IP",
                                      STRING_ONLY, FORMAT_CLF_IP))
        # %{c}a Underlying peer IP of the connection (mod_remoteip)
        p.extend(self._first_and_last("%{c}a", "connection.client.peerip", "IP",
                                      STRING_ONLY, FORMAT_CLF_IP))
        # %A Local IP-address
        p.extend(self._first_and_last("%A", "connection.server.ip", "IP",
                                      STRING_ONLY, FORMAT_CLF_IP))
        # %B Size of response in bytes, excluding HTTP headers
        p.extend(self._first_and_last("%B", "response.body.bytes", "BYTES",
                                      STRING_OR_LONG, FORMAT_NUMBER))
        # %b CLF variant: '-' rather than 0 when no bytes are sent
        p.extend(self._first_and_last("%b", "response.body.bytes", "BYTESCLF",
                                      STRING_OR_LONG, FORMAT_CLF_NUMBER))
        self._add_extra_output(
            p, "%b",
            TokenOutputField("BYTES", "response.body.bytesclf", STRING_OR_LONG)
            .deprecate_for("BYTESCLF:response.body.bytes"))

        # %{Foobar}C The contents of cookie Foobar in the request
        p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}C", "request.cookies.",
                                  "HTTP.COOKIE", STRING_ONLY, FORMAT_STRING))
        # %{FOOBAR}e The contents of the environment variable
        p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}e", "server.environment.",
                                  "VARIABLE", STRING_ONLY, FORMAT_STRING))
        # %f Filename
        p.extend(self._first_and_last("%f", "server.filename", "FILENAME",
                                      STRING_ONLY, FORMAT_STRING))
        # %h Remote host
        p.extend(self._first_and_last("%h", "connection.client.host", "IP",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %H The request protocol
        p.extend(self._first_and_last("%H", "request.protocol", "PROTOCOL",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %{Foobar}i Request header contents
        p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}i", "request.header.",
                                  "HTTP.HEADER", STRING_ONLY, FORMAT_STRING))
        # %{VARNAME}^ti Request trailer line(s)
        p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}\^ti", "request.trailer.",
                                  "HTTP.TRAILER", STRING_ONLY, FORMAT_STRING))
        # %k Number of keepalive requests on this connection
        p.extend(self._first_and_last("%k", "connection.keepalivecount", "NUMBER",
                                      STRING_OR_LONG, FORMAT_NUMBER))
        # %l Remote logname (from identd)
        p.extend(self._first_and_last("%l", "connection.client.logname", "NUMBER",
                                      STRING_OR_LONG, FORMAT_CLF_NUMBER))
        # %L The request log ID from the error log
        p.extend(self._first_and_last("%L", "request.errorlogid", "STRING",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %m The request method
        p.extend(self._first_and_last("%m", "request.method", "HTTP.METHOD",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %{Foobar}n The contents of note Foobar from another module
        p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}n", "server.module_note.",
                                  "STRING", STRING_ONLY, FORMAT_STRING))
        # %{Foobar}o Response header contents
        p.append(NamedTokenParser(r"\%\{([a-z0-9\-]*)\}o", "response.header.",
                                  "HTTP.HEADER", STRING_ONLY, FORMAT_STRING))
        # %{VARNAME}^to Response trailer line(s)
        p.append(NamedTokenParser(r"\%\{([a-z0-9\-_]*)\}\^to", "response.trailer.",
                                  "HTTP.TRAILER", STRING_ONLY, FORMAT_STRING))
        # %p The canonical port of the server serving the request
        p.extend(self._first_and_last("%p", "request.server.port.canonical", "PORT",
                                      STRING_OR_LONG, FORMAT_NUMBER))
        # %{format}p canonical/local/remote port
        p.extend(self._first_and_last("%{canonical}p",
                                      "connection.server.port.canonical", "PORT",
                                      STRING_OR_LONG, FORMAT_NUMBER))
        p.extend(self._first_and_last("%{local}p", "connection.server.port", "PORT",
                                      STRING_OR_LONG, FORMAT_NUMBER))
        p.extend(self._first_and_last("%{remote}p", "connection.client.port", "PORT",
                                      STRING_OR_LONG, FORMAT_NUMBER))
        # %P The process ID of the child that serviced the request
        p.extend(self._first_and_last("%P", "connection.server.child.processid",
                                      "NUMBER", STRING_OR_LONG, FORMAT_NUMBER))
        # %{format}P pid/tid/hextid
        p.extend(self._first_and_last("%{pid}P", "connection.server.child.processid",
                                      "NUMBER", STRING_OR_LONG, FORMAT_NUMBER))
        p.extend(self._first_and_last("%{tid}P", "connection.server.child.threadid",
                                      "NUMBER", STRING_OR_LONG, FORMAT_NUMBER))
        p.extend(self._first_and_last("%{hextid}P",
                                      "connection.server.child.hexthreadid",
                                      "NUMBER", STRING_OR_LONG, FORMAT_CLF_HEXNUMBER))
        # %q The query string (prepended with a ? if one exists)
        p.extend(self._first_and_last("%q", "request.querystring",
                                      "HTTP.QUERYSTRING", STRING_ONLY,
                                      FORMAT_NO_SPACE_STRING))
        # %r First line of request (regex reduced to survive garbage,
        # HttpFirstLineDissector.java:56-57)
        p.extend(self._first_and_last("%r", "request.firstline", "HTTP.FIRSTLINE",
                                      STRING_ONLY, ".*"))
        # %R The handler generating the response
        p.extend(self._first_and_last("%R", "request.handler", "STRING",
                                      STRING_ONLY, FORMAT_STRING))
        # %s Status of the *original* request; %>s for the last
        p.extend(self._first_and_last("%s", "request.status", "STRING",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING, 0))
        # %t Time the request was received (standard english format)
        p.extend(self._first_and_last("%t", "request.receive.time", "TIME.STAMP",
                                      STRING_ONLY, FORMAT_STANDARD_TIME_US))

        # %{format}t strftime-format timestamps (possibly begin:/end: prefixed);
        # each distinct format gets a unique TYPE + its own strftime dissector.
        from ..dissectors.strftime_stamp import StrfTimeStampDissector

        p.append(ParameterizedTokenParser(
            r"\%\{([^\}]*%[^\}]*)\}t", "request.receive.time", "TIME.STRFTIME_",
            STRING_ONLY, FORMAT_STRING, -1, StrfTimeStampDissector())
            .set_warning_message_when_used(
                "Only some parts of localized timestamps are supported"))
        p.append(ParameterizedTokenParser(
            r"\%\{begin:([^\}]*%[^\}]*)\}t", "request.receive.time.begin",
            "TIME.STRFTIME_", STRING_ONLY, FORMAT_STRING, 0,
            StrfTimeStampDissector())
            .set_warning_message_when_used(
                "Only some parts of localized timestamps are supported"))
        p.append(ParameterizedTokenParser(
            r"\%\{end:([^\}]*%[^\}]*)\}t", "request.receive.time.end",
            "TIME.STRFTIME_", STRING_ONLY, FORMAT_STRING, 0,
            StrfTimeStampDissector())
            .set_warning_message_when_used(
                "Only some parts of localized timestamps are supported"))

        # %{sec|msec|usec|msec_frac|usec_frac}t epoch variants (+begin:/end:)
        for prefix in ("", "begin:", "end:"):
            name_mid = prefix.rstrip(":")
            dotted = ("." + name_mid) if name_mid else ""
            p.extend(self._first_and_last(
                "%{" + prefix + "sec}t",
                "request.receive.time" + dotted + ".sec",
                "TIME.SECONDS", STRING_OR_LONG, FORMAT_NUMBER))
            p.extend(self._first_and_last(
                "%{" + prefix + "msec}t",
                "request.receive.time" + dotted + ".msec",
                "TIME.EPOCH", STRING_OR_LONG, FORMAT_NUMBER))
            p.extend(self._first_and_last(
                "%{" + prefix + "usec}t",
                "request.receive.time" + dotted + ".usec",
                "TIME.EPOCH.USEC", STRING_OR_LONG, FORMAT_NUMBER))
            p.extend(self._first_and_last(
                "%{" + prefix + "msec_frac}t",
                "request.receive.time" + dotted + ".msec_frac",
                "TIME.EPOCH", STRING_OR_LONG, FORMAT_NUMBER))
            p.extend(self._first_and_last(
                "%{" + prefix + "usec_frac}t",
                "request.receive.time" + dotted + ".usec_frac",
                "TIME.EPOCH.USEC_FRAC", STRING_OR_LONG, FORMAT_NUMBER))

        # Deprecated-name aliases for the epoch variants
        self._add_extra_output(
            p, "%{msec}t",
            TokenOutputField("TIME.EPOCH", "request.receive.time.begin.msec",
                             STRING_OR_LONG)
            .deprecate_for("TIME.EPOCH:request.receive.time.msec"))
        self._add_extra_output(
            p, "%{usec}t",
            TokenOutputField("TIME.EPOCH.USEC", "request.receive.time.begin.usec",
                             STRING_OR_LONG)
            .deprecate_for("TIME.EPOCH.USEC:request.receive.time.usec"))
        self._add_extra_output(
            p, "%{msec_frac}t",
            TokenOutputField("TIME.EPOCH", "request.receive.time.begin.msec_frac",
                             STRING_OR_LONG)
            .deprecate_for("TIME.EPOCH:request.receive.time.msec_frac"))
        self._add_extra_output(
            p, "%{usec_frac}t",
            TokenOutputField("TIME.EPOCH.USEC_FRAC",
                             "request.receive.time.begin.usec_frac", STRING_OR_LONG)
            .deprecate_for("TIME.EPOCH.USEC_FRAC:request.receive.time.usec_frac"))

        # %T Time taken to serve the request, in seconds
        p.extend(self._first_and_last("%T", "response.server.processing.time",
                                      "SECONDS", STRING_OR_LONG, FORMAT_NUMBER))
        # %D Time taken, in microseconds
        p.extend(self._first_and_last("%D", "response.server.processing.time",
                                      "MICROSECONDS", STRING_OR_LONG, FORMAT_NUMBER))
        self._add_extra_output(
            p, "%D",
            TokenOutputField("MICROSECONDS", "server.process.time", STRING_OR_LONG)
            .deprecate_for("MICROSECONDS:response.server.processing.time"))
        # %{UNIT}T us/ms/s
        p.extend(self._first_and_last("%{us}T", "response.server.processing.time",
                                      "MICROSECONDS", STRING_OR_LONG, FORMAT_NUMBER))
        p.extend(self._first_and_last("%{ms}T", "response.server.processing.time",
                                      "MILLISECONDS", STRING_OR_LONG, FORMAT_NUMBER))
        p.extend(self._first_and_last("%{s}T", "response.server.processing.time",
                                      "SECONDS", STRING_OR_LONG, FORMAT_NUMBER))
        # %u Remote user (from auth)
        p.extend(self._first_and_last("%u", "connection.client.user", "STRING",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %U The URL path requested, not including any query string
        p.extend(self._first_and_last("%U", "request.urlpath", "URI",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %v The canonical ServerName
        p.extend(self._first_and_last("%v", "connection.server.name.canonical",
                                      "STRING", STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %V The server name per UseCanonicalName
        p.extend(self._first_and_last("%V", "connection.server.name", "STRING",
                                      STRING_ONLY, FORMAT_NO_SPACE_STRING))
        # %X Connection status when response completed (X/+/-)
        p.extend(self._first_and_last("%X", "response.connection.status",
                                      "HTTP.CONNECTSTATUS", STRING_ONLY,
                                      FORMAT_NO_SPACE_STRING))
        # %I Bytes received (mod_logio); can be 0 on HTTP 408
        p.extend(self._first_and_last("%I", "request.bytes", "BYTES",
                                      STRING_OR_LONG, FORMAT_CLF_NUMBER))
        # %O Bytes sent (mod_logio)
        p.extend(self._first_and_last("%O", "response.bytes", "BYTES",
                                      STRING_OR_LONG, FORMAT_CLF_NUMBER))
        # %S Bytes transferred total (%I + %O)
        p.extend(self._first_and_last("%S", "total.bytes", "BYTES",
                                      STRING_OR_LONG, FORMAT_NON_ZERO_NUMBER))

        # Explicit type overrides for well-known headers (prio 1 beats the
        # generic %{...}i/%{...}o token parsers).
        p.extend(self._first_and_last("%{cookie}i", "request.cookies",
                                      "HTTP.COOKIES", STRING_ONLY, FORMAT_STRING, 1))
        p.extend(self._first_and_last("%{set-cookie}o", "response.cookies",
                                      "HTTP.SETCOOKIES", STRING_ONLY,
                                      FORMAT_STRING, 1))
        p.extend(self._first_and_last("%{user-agent}i", "request.user-agent",
                                      "HTTP.USERAGENT", STRING_ONLY,
                                      FORMAT_STRING, 1))
        p.extend(self._first_and_last("%{referer}i", "request.referer", "HTTP.URI",
                                      STRING_ONLY, FORMAT_STRING, 1))
        return p

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _add_extra_output(
        parsers: List[TokenParser], log_format_token: str, output: TokenOutputField
    ) -> None:
        for tp in parsers:
            if tp.log_format_token == log_format_token:
                tp.output_fields.append(output)
                return

    @staticmethod
    def _first_and_last(
        token: str,
        name: str,
        ftype: str,
        casts: FrozenSet[Cast],
        regex: str,
        prio: int = 0,
    ) -> List[TokenParser]:
        """Create the %X / %<X / %>X triple with .original/.last twin outputs."""
        parsers: List[TokenParser] = []
        base = TokenParser(token, regex=regex, prio=prio)
        base.add_output_field(ftype, name, casts)
        if token in _ORIGINAL_DEFAULT_TOKENS:
            base.add_output_field(ftype, name + ".original", casts)
        else:
            base.add_output_field(ftype, name + ".last", casts)
        parsers.append(base)

        original = TokenParser(token.replace("%", "%<", 1), regex=regex, prio=prio)
        original.add_output_field(ftype, name + ".original", casts)
        parsers.append(original)

        last = TokenParser(token.replace("%", "%>", 1), regex=regex, prio=prio)
        last.add_output_field(ftype, name + ".last", casts)
        parsers.append(last)
        return parsers


# The part of the table the device split compiles: these tokens with their
# %< / %> twins, the %{name}C / %{name}e named tokens and the strftime
# %{format}t tokens.
_DEVICE_TOKENS = frozenset(
    t.replace("%", m, 1)
    for t in ("%%", "%B", "%b", "%h", "%l", "%r", "%s", "%t", "%I", "%O", "%u",
              "%{user-agent}i", "%{referer}i", "%{cookie}i", "%{set-cookie}o")
    for m in ("%", "%<", "%>")
) | {r"\%\{([a-z0-9\-_]*)\}C", r"\%\{([a-z0-9\-_]*)\}e"}


def create_token_parsers() -> List[TokenParser]:
    """The device split's part of the token table (in the table's order)."""
    return [tp for tp in ApacheHttpdLogFormatDissector().create_all_token_parsers()
            if isinstance(tp, ParameterizedTokenParser)
            or tp.log_format_token in _DEVICE_TOKENS]


class ApacheLogFormat:
    """One Apache LogFormat resolved to the device split's token list."""

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
