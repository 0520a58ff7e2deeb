"""NGINX GeoIP module variables (.../nginxmodules/GeoIPModule.java)."""
from __future__ import annotations

from typing import List

from ...core.casts import STRING_ONLY
from ...dissectors.tokenformat import (
    FORMAT_NO_SPACE_STRING,
    FORMAT_STRING,
    TokenParser,
)
from . import NginxModule

_PREFIX = "nginxmodule.geoip"


class GeoIPModule(NginxModule):
    def get_token_parsers(self) -> List[TokenParser]:
        def t(token, name, regex):
            return TokenParser(token, _PREFIX + name, "STRING", STRING_ONLY, regex)

        return [
            t("$geoip_country_code", ".country.code", FORMAT_NO_SPACE_STRING),
            t("$geoip_country_code3", ".country.code3", FORMAT_NO_SPACE_STRING),
            t("$geoip_country_name", ".country.name", FORMAT_STRING),
            t("$geoip_area_code", ".area.code", FORMAT_NO_SPACE_STRING),
            t("$geoip_city_continent_code", ".continent.code", FORMAT_NO_SPACE_STRING),
            t("$geoip_city_country_code", ".country.code", FORMAT_NO_SPACE_STRING),
            t("$geoip_city_country_code3", ".country.code3", FORMAT_NO_SPACE_STRING),
            t("$geoip_city_country_name", ".country.name", FORMAT_STRING),
            t("$geoip_dma_code", ".dma.code", FORMAT_STRING),
            t("$geoip_latitude", ".location.latitude", FORMAT_STRING),
            t("$geoip_longitude", ".location.longitude", FORMAT_STRING),
            t("$geoip_region", ".region.code", FORMAT_NO_SPACE_STRING),
            t("$geoip_region_name", ".region.name", FORMAT_STRING),
            t("$geoip_city", ".city", FORMAT_STRING),
            t("$geoip_postal_code", ".postal.code", FORMAT_STRING),
            t("$geoip_org", ".organization", FORMAT_STRING),
        ]
