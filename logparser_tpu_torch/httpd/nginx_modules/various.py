"""Miscellaneous NGINX module variables (.../nginxmodules/VariousModule.java)."""
from __future__ import annotations

from typing import List

from ...core.casts import STRING_ONLY, STRING_OR_LONG
from ...dissectors.tokenformat import (
    FORMAT_NO_SPACE_STRING,
    FORMAT_NUMBER_OPTIONAL_DECIMAL,
    FORMAT_STRING,
    NamedTokenParser,
    TokenParser,
)
from . import NginxModule

_PREFIX = "nginxmodule"


class VariousModule(NginxModule):
    def get_token_parsers(self) -> List[TokenParser]:
        def t(token, name, ftype, casts, regex):
            return TokenParser(token, _PREFIX + name, ftype, casts, regex)

        return [
            t("$secure_link", ".secure_link.status", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$session_log_id", ".session_log.id", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$slice_range", ".slice_range", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$proxy_host", ".proxy.host", "STRING", STRING_ONLY, FORMAT_NO_SPACE_STRING),
            t("$proxy_port", ".proxy.port", "STRING", STRING_ONLY, FORMAT_NO_SPACE_STRING),
            t("$proxy_add_x_forwarded_for", ".proxy.add_x_forwarded_for", "STRING",
              STRING_ONLY, FORMAT_NO_SPACE_STRING),
            t("$uid_got", ".userid.uid_got", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$uid_reset", ".userid.uid_reset", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$uid_set", ".userid.uid_set", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$modern_browser", ".browser.modern", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$ancient_browser", ".browser.ancient", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$msie", ".browser.msie", "STRING", STRING_ONLY, FORMAT_NO_SPACE_STRING),
            t("$connections_active", ".stub_status.connections.active", "STRING",
              STRING_ONLY, FORMAT_STRING),
            t("$connections_reading", ".stub_status.connections.reading", "STRING",
              STRING_ONLY, FORMAT_STRING),
            t("$connections_writing", ".stub_status.connections.writing", "STRING",
              STRING_ONLY, FORMAT_STRING),
            t("$connections_waiting", ".stub_status.connections.waiting", "STRING",
              STRING_ONLY, FORMAT_STRING),
            t("$date_local", ".date.local", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$date_gmt", ".date.gmt", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$fastcgi_script_name", ".fastcgi.script_name", "STRING", STRING_ONLY,
              FORMAT_STRING),
            t("$fastcgi_path_info", ".fastcgi.path_info", "STRING", STRING_ONLY,
              FORMAT_STRING),
            t("$gzip_ratio", ".gzip.ratio", "STRING", STRING_ONLY,
              FORMAT_NUMBER_OPTIONAL_DECIMAL),
            t("$spdy", ".spdy.version", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$spdy_request_priority", ".spdy.request_priority", "STRING",
              STRING_ONLY, FORMAT_STRING),
            t("$http2", ".http2.negotiated_protocol", "STRING", STRING_ONLY,
              FORMAT_STRING),
            t("$invalid_referer", ".referer.invalid", "STRING", STRING_ONLY, "1?"),
            NamedTokenParser("\\$jwt_header_([a-z0-9\\-_]*)", _PREFIX + ".jwt.header.",
                             "STRING", STRING_ONLY, FORMAT_STRING),
            NamedTokenParser("\\$jwt_claim_([a-z0-9\\-_]*)", _PREFIX + ".jwt.claim.",
                             "STRING", STRING_ONLY, FORMAT_STRING),
            t("$memcached_key", ".memcached.key", "STRING", STRING_ONLY, FORMAT_STRING),
            t("$realip_remote_addr", ".realip.remote_addr", "IP", STRING_ONLY,
              FORMAT_STRING),
            t("$realip_remote_port", ".realip.remote_port", "PORT", STRING_OR_LONG,
              FORMAT_STRING),
        ]
