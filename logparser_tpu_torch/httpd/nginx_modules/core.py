"""NGINX core log module variables.

Rebuild of .../dissectors/nginxmodules/CoreLogModule.java — the ~60 variables
from ngx_http_log_module / ngx_http_core_module.
"""
from __future__ import annotations

from typing import List

from ...core.casts import STRING_ONLY, STRING_OR_LONG
from ...dissectors.tokenformat import (
    FORMAT_CLF_IP,
    FORMAT_CLF_NUMBER,
    FORMAT_HEXDIGIT,
    FORMAT_HEXNUMBER,
    FORMAT_NO_SPACE_STRING,
    FORMAT_NUMBER,
    FORMAT_NUMBER_DECIMAL,
    FORMAT_STANDARD_TIME_ISO8601,
    FORMAT_STANDARD_TIME_US,
    FORMAT_STRING,
    NamedTokenParser,
    NotImplementedTokenParser,
    TokenParser,
)
from . import NginxModule

_HEX_BYTE = "\\\\x" + FORMAT_HEXDIGIT + FORMAT_HEXDIGIT


def _t(token, name, ftype, casts, regex, prio=None) -> TokenParser:
    return TokenParser(token, name, ftype, casts, regex, prio)


class CoreLogModule(NginxModule):
    def get_token_parsers(self) -> List[TokenParser]:
        p: List[TokenParser] = [
            # $bytes_sent: number of bytes sent to a client
            _t("$bytes_sent", "response.bytes", "BYTES", STRING_OR_LONG, FORMAT_NUMBER),
            # $bytes_received: number of bytes received from a client
            _t("$bytes_received", "request.bytes", "BYTES", STRING_OR_LONG, FORMAT_NUMBER),
            # $connection: connection serial number
            _t("$connection", "connection.serial_number", "NUMBER", STRING_OR_LONG,
               FORMAT_CLF_NUMBER, -1),
            # $connection_requests: requests made through a connection
            _t("$connection_requests", "connection.requestnr", "NUMBER",
               STRING_OR_LONG, FORMAT_CLF_NUMBER),
            # $msec: seconds with millisecond resolution, e.g. 1483455396.639
            _t("$msec", "request.receive.time.epoch", "TIME.EPOCH_SECOND_MILLIS",
               STRING_ONLY, "[0-9]+\\.[0-9][0-9][0-9]"),
            # $status: response status
            _t("$status", "request.status.last", "STRING", STRING_ONLY,
               FORMAT_NO_SPACE_STRING),
            # $time_iso8601: local time, ISO 8601
            _t("$time_iso8601", "request.receive.time", "TIME.ISO8601", STRING_ONLY,
               FORMAT_STANDARD_TIME_ISO8601),
            # $time_local: local time in Common Log Format
            _t("$time_local", "request.receive.time", "TIME.STAMP", STRING_ONLY,
               FORMAT_STANDARD_TIME_US),
            # $arg_name: argument in the request line
            NamedTokenParser("\\$arg_([a-z0-9\\-\\_]*)", "request.firstline.uri.query.",
                             "STRING", STRING_ONLY, FORMAT_STRING),
            # $is_args: '?' if the request line has arguments
            _t("$is_args", "request.firstline.uri.is_args", "STRING", STRING_ONLY,
               FORMAT_STRING),
            # $args / $query_string: arguments in the request line
            _t("$args", "request.firstline.uri.query", "HTTP.QUERYSTRING",
               STRING_ONLY, FORMAT_STRING),
            _t("$query_string", "request.firstline.uri.query", "HTTP.QUERYSTRING",
               STRING_ONLY, FORMAT_STRING),
            # $body_bytes_sent: compatible with Apache %B
            _t("$body_bytes_sent", "response.body.bytes", "BYTES", STRING_OR_LONG,
               FORMAT_NUMBER),
            # $content_length / $content_type request headers
            _t("$content_length", "request.header.content_length", "HTTP.HEADER",
               STRING_ONLY, FORMAT_STRING),
            _t("$content_type", "request.header.content_type", "HTTP.HEADER",
               STRING_ONLY, FORMAT_STRING),
            # $cookie_name
            NamedTokenParser("\\$cookie_([a-z0-9\\-_]*)", "request.cookies.",
                             "HTTP.COOKIE", STRING_ONLY, FORMAT_STRING),
            # $document_root / $realpath_root
            _t("$document_root", "request.firstline.document_root", "STRING",
               STRING_ONLY, FORMAT_NO_SPACE_STRING),
            _t("$realpath_root", "request.firstline.realpath_root", "STRING",
               STRING_ONLY, FORMAT_NO_SPACE_STRING),
            # $host: host from request line / Host header / server name
            _t("$host", "connection.server.name", "STRING", STRING_ONLY,
               FORMAT_NO_SPACE_STRING, -1),
            # $hostname: host name
            _t("$hostname", "connection.client.host", "STRING", STRING_ONLY,
               FORMAT_NO_SPACE_STRING),
            # $http_<name>: arbitrary request header
            NamedTokenParser("\\$http_([a-z0-9\\-_]*)", "request.header.",
                             "HTTP.HEADER", STRING_ONLY, FORMAT_STRING),
            _t("$http_user_agent", "request.user-agent", "HTTP.USERAGENT",
               STRING_ONLY, FORMAT_STRING, 1),
            _t("$http_referer", "request.referer", "HTTP.URI", STRING_ONLY,
               FORMAT_NO_SPACE_STRING, 1),
            # $https: 'on' in SSL mode
            _t("$https", "connection.https", "STRING", STRING_ONLY,
               FORMAT_NO_SPACE_STRING),
            # $limit_rate: not intended for logging
            NotImplementedTokenParser("$limit_rate",
                                      "nginx_parameter_not_intended_for_logging",
                                      FORMAT_NO_SPACE_STRING, 0),
            # $nginx_version
            _t("$nginx_version", "server.nginx.version", "STRING", STRING_ONLY,
               FORMAT_STRING),
            # $pid: worker process PID
            _t("$pid", "connection.server.child.processid", "NUMBER", STRING_OR_LONG,
               FORMAT_NUMBER),
            # $protocol: TCP or UDP
            _t("$protocol", "connection.protocol", "STRING", STRING_ONLY,
               FORMAT_NO_SPACE_STRING),
            # $pipe: 'p' if pipelined, '.' otherwise
            _t("$pipe", "connection.nginx.pipe", "STRING", STRING_ONLY, "."),
            # PROXY protocol address/port
            _t("$proxy_protocol_addr", "connection.client.proxy.host", "IP",
               STRING_OR_LONG, FORMAT_CLF_IP),
            _t("$proxy_protocol_port", "connection.client.proxy.port", "PORT",
               STRING_OR_LONG, FORMAT_CLF_NUMBER),
            # $remote_addr: client address
            _t("$remote_addr", "connection.client.host", "IP", STRING_OR_LONG,
               FORMAT_CLF_IP),
            # $binary_remote_addr: client address, 4 escaped bytes
            _t("$binary_remote_addr", "connection.client.host", "IP_BINARY",
               STRING_OR_LONG, _HEX_BYTE + _HEX_BYTE + _HEX_BYTE + _HEX_BYTE),
            # $remote_port / $remote_user
            _t("$remote_port", "connection.client.port", "PORT", STRING_OR_LONG,
               FORMAT_NUMBER),
            _t("$remote_user", "connection.client.user", "STRING", STRING_ONLY,
               FORMAT_STRING),
            # $request: full original request line
            _t("$request", "request.firstline", "HTTP.FIRSTLINE", STRING_ONLY,
               FORMAT_NO_SPACE_STRING + " " + FORMAT_NO_SPACE_STRING + " "
               + FORMAT_NO_SPACE_STRING, -2),
            # $request_body / $request_body_file: not intended for logging
            NotImplementedTokenParser("$request_body",
                                      "nginx_parameter_not_intended_for_logging",
                                      FORMAT_STRING, -1),
            NotImplementedTokenParser("$request_body_file",
                                      "nginx_parameter_not_intended_for_logging",
                                      FORMAT_STRING, -1),
            # $request_completion: 'OK' if completed
            _t("$request_completion", "request.completion", "STRING", STRING_ONLY,
               FORMAT_NO_SPACE_STRING),
            # $request_filename
            _t("$request_filename", "server.filename", "FILENAME", STRING_ONLY,
               FORMAT_STRING),
            # $request_length: request length in bytes
            _t("$request_length", "request.bytes", "BYTES", STRING_OR_LONG,
               FORMAT_CLF_NUMBER),
            # $request_method
            _t("$request_method", "request.firstline.method", "HTTP.METHOD",
               STRING_ONLY, FORMAT_NO_SPACE_STRING),
            # $request_time: seconds with millisecond resolution
            _t("$request_time", "response.server.processing.time", "SECOND_MILLIS",
               STRING_ONLY, FORMAT_NUMBER_DECIMAL),
            # $request_uri: full original URI with arguments
            _t("$request_uri", "request.firstline.uri", "HTTP.URI", STRING_ONLY,
               FORMAT_NO_SPACE_STRING),
            # $request_id: 16 random bytes in hex
            _t("$request_id", "request.id", "STRING", STRING_ONLY, FORMAT_HEXNUMBER),
            # $uri / $document_uri: normalized current URI
            _t("$uri", "request.firstline.uri.normalized", "HTTP.URI", STRING_ONLY,
               FORMAT_STRING),
            _t("$document_uri", "request.firstline.uri.normalized", "HTTP.URI",
               STRING_ONLY, FORMAT_STRING),
            # $scheme: http or https
            _t("$scheme", "request.firstline.uri.protocol", "HTTP.PROTOCOL",
               STRING_ONLY, FORMAT_NO_SPACE_STRING),
            # $sent_http_<name> / $sent_trailer_<name>
            NamedTokenParser("\\$sent_http_([a-z0-9\\-_]*)", "response.header.",
                             "HTTP.HEADER", STRING_ONLY, FORMAT_STRING),
            NamedTokenParser("\\$sent_trailer_([a-z0-9\\-_]*)", "response.trailer.",
                             "HTTP.TRAILER", STRING_ONLY, FORMAT_STRING),
            # $server_addr / $server_name / $server_port / $server_protocol
            _t("$server_addr", "connection.server.ip", "IP", STRING_OR_LONG,
               FORMAT_CLF_IP),
            _t("$server_name", "connection.server.name", "STRING", STRING_ONLY,
               FORMAT_NO_SPACE_STRING),
            _t("$server_port", "connection.server.port", "PORT", STRING_OR_LONG,
               FORMAT_NUMBER),
            _t("$server_protocol", "request.firstline.protocol",
               "HTTP.PROTOCOL_VERSION", STRING_OR_LONG, FORMAT_NO_SPACE_STRING),
            # $session_time: seconds with millisecond resolution
            _t("$session_time", "connection.session.time", "SECOND_MILLIS",
               STRING_ONLY, FORMAT_NUMBER_DECIMAL),
            # $tcpinfo_*: TCP_INFO socket option data
            _t("$tcpinfo_rtt", "connection.tcpinfo.rtt", "MICROSECONDS",
               STRING_OR_LONG, FORMAT_NUMBER, -1),
            _t("$tcpinfo_rttvar", "connection.tcpinfo.rttvar", "MICROSECONDS",
               STRING_OR_LONG, FORMAT_NUMBER),
            _t("$tcpinfo_snd_cwnd", "connection.tcpinfo.send.cwnd", "BYTES",
               STRING_OR_LONG, FORMAT_NUMBER),
            _t("$tcpinfo_rcv_space", "connection.tcpinfo.receive.space", "BYTES",
               STRING_OR_LONG, FORMAT_NUMBER),
            # Fallback for all unknown variables that might appear
            # (CoreLogModule.java:481-486): lowest priority, warns on use,
            # assumes a whitespace-free text value.
            NamedTokenParser("\\$([a-z0-9\\-\\_]*)", "nginx.unknown.",
                             "UNKNOWN_NGINX_VARIABLE", STRING_ONLY,
                             FORMAT_NO_SPACE_STRING, -10)
            .set_warning_message_when_used(
                'Found unknown variable "${}" that was mapped to "{}". It is '
                "assumed the values are text that cannot contain a whitespace."
            ),
        ]
        return p
