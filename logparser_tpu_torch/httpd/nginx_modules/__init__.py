"""NGINX variable modules (the port's own copy of the reference package's
``httpd/nginx_modules``).

Rebuild of httpdlog/httpdlog-parser/.../dissectors/nginxmodules/: each module
contributes ``$var`` token parsers (and optionally helper dissectors) to the
NGINX format dissector.
"""
from __future__ import annotations

from typing import List

from ...core.dissector import Dissector
from ...dissectors.tokenformat import TokenParser


class NginxModule:
    def get_token_parsers(self) -> List[TokenParser]:
        raise NotImplementedError

    def get_dissectors(self) -> List[Dissector]:
        return []


from .core import CoreLogModule  # noqa: E402
from .upstream import UpstreamModule, UpstreamListDissector  # noqa: E402
from .ssl import SslModule  # noqa: E402
from .geoip import GeoIPModule  # noqa: E402
from .various import VariousModule  # noqa: E402
from .kubernetes_ingress import KubernetesIngressModule  # noqa: E402

ALL_MODULES = [
    CoreLogModule,
    UpstreamModule,
    SslModule,
    GeoIPModule,
    VariousModule,
    KubernetesIngressModule,
]

__all__ = [
    "NginxModule",
    "CoreLogModule",
    "UpstreamModule",
    "UpstreamListDissector",
    "SslModule",
    "GeoIPModule",
    "VariousModule",
    "KubernetesIngressModule",
    "ALL_MODULES",
]
