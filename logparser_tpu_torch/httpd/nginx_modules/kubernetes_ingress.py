"""Kubernetes ingress NGINX variables (.../nginxmodules/KubernetesIngressModule.java)."""
from __future__ import annotations

from typing import List

from ...core.casts import STRING_ONLY
from ...dissectors.tokenformat import FORMAT_STRING, TokenParser
from . import NginxModule

_PREFIX = "nginxmodule.kubernetes"


class KubernetesIngressModule(NginxModule):
    def get_token_parsers(self) -> List[TokenParser]:
        def t(token, name, ftype="STRING"):
            return TokenParser(token, _PREFIX + name, ftype, STRING_ONLY, FORMAT_STRING)

        return [
            t("$the_real_ip", ".the_real_ip", "IP"),
            t("$proxy_upstream_name", ".proxy_upstream_name"),
            t("$req_id", ".req_id"),
            t("$namespace", ".namespace"),
            t("$ingress_name", ".ingress_name"),
            t("$service_name", ".service.name"),
            t("$service_port", ".service.port", "PORT"),
        ]
