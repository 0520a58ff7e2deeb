"""GeoIP dissectors: IP -> continent / country / city / ASN / ISP fields.

The port's copy of the reference package's ``geoip/dissectors.py``, cut
to what plan resolution reads: each dissector's input type (``IP``), its
possible outputs, and the database file it was given.  The device path
turns an ``IP`` token's outputs through these into ``geo`` plans over a
flattened :class:`~logparser_tpu_torch.geoip.device.GeoDeviceTable`; the
per-line ``dissect`` of the reference belongs to the host oracle, a
later slice of the port.
"""
from __future__ import annotations

from typing import List, Optional


class AbstractGeoIPDissector:
    """Base: input type ``IP``, one .mmdb database per dissector."""

    INPUT_TYPE = "IP"

    def __init__(self, database_file_name: Optional[str] = None):
        self.database_file_name = database_file_name

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        self.database_file_name = settings
        return True

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        raise NotImplementedError


class GeoIPCountryDissector(AbstractGeoIPDissector):
    """continent.name / .code + country.name / .iso / .getconfidence /
    .isineuropeanunion."""

    def get_possible_output(self) -> List[str]:
        return [
            "STRING:continent.name",
            "STRING:continent.code",
            "STRING:country.name",
            "STRING:country.iso",
            "NUMBER:country.getconfidence",
            "BOOLEAN:country.isineuropeanunion",
        ]


class GeoIPCityDissector(GeoIPCountryDissector):
    """Adds the subdivision, city, postal and location fields."""

    def get_possible_output(self) -> List[str]:
        return super().get_possible_output() + [
            "STRING:subdivision.name",
            "STRING:subdivision.iso",
            "STRING:city.name",
            "NUMBER:city.confidence",
            "NUMBER:city.geonameid",
            "STRING:postal.code",
            "NUMBER:postal.confidence",
            "STRING:location.latitude",
            "STRING:location.longitude",
            "STRING:location.timezone",
            "NUMBER:location.accuracyradius",
            "NUMBER:location.averageincome",
            "NUMBER:location.metrocode",
            "NUMBER:location.populationdensity",
        ]


class GeoIPASNDissector(AbstractGeoIPDissector):
    """asn.number + asn.organization."""

    def get_possible_output(self) -> List[str]:
        return ["ASN:asn.number", "STRING:asn.organization"]


class GeoIPISPDissector(GeoIPASNDissector):
    """Adds isp.name + isp.organization."""

    def get_possible_output(self) -> List[str]:
        return super().get_possible_output() + [
            "STRING:isp.name",
            "STRING:isp.organization",
        ]
