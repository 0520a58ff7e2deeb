"""NGINX SSL module variables (.../nginxmodules/SslModule.java)."""
from __future__ import annotations

from typing import List

from ...core.casts import STRING_ONLY
from ...dissectors.tokenformat import (
    FORMAT_NO_SPACE_STRING,
    FORMAT_STRING,
    TokenParser,
)
from . import NginxModule

_PREFIX = "nginxmodule.ssl"


class SslModule(NginxModule):
    def get_token_parsers(self) -> List[TokenParser]:
        def t(token, name, ftype, regex):
            return TokenParser(token, _PREFIX + name, ftype, STRING_ONLY, regex)

        return [
            t("$ssl_cipher", ".cipher", "STRING", FORMAT_STRING),
            t("$ssl_ciphers", ".client.ciphers", "STRING", FORMAT_STRING),
            t("$ssl_client_escaped_cert", ".client.cert", "PEM_CERT_URLENCODED",
              FORMAT_NO_SPACE_STRING),
            t("$ssl_client_cert", ".client.cert", "PEM_CERT", FORMAT_STRING),
            t("$ssl_client_raw_cert", ".client.cert", "PEM_CERT_RAW", FORMAT_STRING),
            t("$ssl_client_fingerprint", ".client.cert.fingerprint", "SHA1",
              FORMAT_NO_SPACE_STRING),
            t("$ssl_client_i_dn", ".client.cert.issuer_dn", "STRING", FORMAT_STRING),
            t("$ssl_client_i_dn_legacy", ".client.cert.issuer_dn.legacy", "STRING",
              FORMAT_STRING),
            t("$ssl_client_s_dn", ".client.cert.subject_dn", "STRING", FORMAT_STRING),
            t("$ssl_client_s_dn_legacy", ".client.cert.subject_dn.legacy", "STRING",
              FORMAT_STRING),
            t("$ssl_client_serial", ".client.cert.serial", "STRING", FORMAT_STRING),
            t("$ssl_client_v_end", ".client.cert.end_date", "STRING", FORMAT_STRING),
            t("$ssl_client_v_remain", ".client.cert.remain_days", "STRING",
              FORMAT_STRING),
            t("$ssl_client_v_start", ".client.cert.start_date", "STRING",
              FORMAT_STRING),
            t("$ssl_client_verify", ".client.cert.verify", "STRING", FORMAT_STRING),
            t("$ssl_curves", ".client.curves", "STRING", FORMAT_STRING),
            t("$ssl_early_data", ".early_data", "STRING", "1?"),
            t("$ssl_protocol", ".protocol", "STRING", FORMAT_STRING),
            t("$ssl_server_name", ".server_name", "STRING", FORMAT_STRING),
            t("$ssl_session_id", ".session.id", "STRING", FORMAT_STRING),
            t("$ssl_session_reused", ".session.reused", "STRING", "(r|.)"),
            t("$ssl_preread_protocol", ".preread.protocol", "STRING", FORMAT_STRING),
            t("$ssl_preread_server_name", ".preread.server_name", "STRING",
              FORMAT_STRING),
            t("$ssl_preread_alpn_protocols", ".preread.alpn_protocols", "STRING",
              FORMAT_STRING),
        ]
