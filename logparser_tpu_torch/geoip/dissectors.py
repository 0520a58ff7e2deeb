"""GeoIP dissectors: IP -> continent/country/city/ASN/ISP fields (the port's
own copy of the reference package's ``geoip/dissectors.py``).

The device path turns an ``IP`` token's outputs through these into ``geo``
plans over a flattened
:class:`~logparser_tpu_torch.geoip.device.GeoDeviceTable`; the host
oracle runs their per-line ``dissect``.  So one list of
``extra_dissectors`` serves both.

Reference behavior: httpdlog-parser/.../dissectors/geoip/*.java —
``AbstractGeoIPDissector`` (input type ``IP``, db path via ctor or
``initializeFromSettingsParameter``, reader opened in ``prepareForRun``,
AbstractGeoIPDissector.java:56-84), ``GeoIPCountryDissector``
(GeoIPCountryDissector.java:50-58), ``GeoIPCityDissector`` extends it
(GeoIPCityDissector.java:55-71, most-specific subdivision :207),
``GeoIPASNDissector`` (:50-51) and ``GeoIPISPDissector`` extends ASN (:48-49).

The lookup engine is :class:`logparser_tpu_torch.geoip.mmdb.MMDBReader` (own
implementation of the public MaxMind-DB format; the reference links
com.maxmind.geoip2).  Locale for ``names`` maps is ``en``, matching
DatabaseReader's default.
"""
from __future__ import annotations

import ipaddress
from typing import Any, Dict, FrozenSet, List, Optional, Set

from ..core.casts import (
    Cast,
    NO_CASTS,
    STRING_ONLY,
    STRING_OR_DOUBLE,
    STRING_OR_LONG,
)
from ..core.dissector import Dissector, extract_field_name
from ..core.exceptions import InvalidDissectorException
from ..core.parsable import Parsable
from .mmdb import MMDBReader


def _name_en(node: Optional[Dict[str, Any]]) -> Optional[str]:
    if not node:
        return None
    names = node.get("names")
    if not names:
        return None
    return names.get("en")


class AbstractGeoIPDissector(Dissector):
    """Base: parses the IP, opens the reader once, delegates to subclasses."""

    INPUT_TYPE = "IP"

    def __init__(self, database_file_name: Optional[str] = None):
        self.database_file_name = database_file_name
        self._reader: Optional[MMDBReader] = None
        self._wanted: Set[str] = set()

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        self.database_file_name = settings
        return True

    def initialize_new_instance(self, new_instance: "Dissector") -> None:
        new_instance.initialize_from_settings_parameter(self.database_file_name)

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    # {relative field name -> casts}; subclasses extend this table.
    _CASTS_TABLE: Dict[str, FrozenSet[Cast]] = {}

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        name = extract_field_name(input_name, output_name)
        casts = self._CASTS_TABLE.get(name)
        if casts is None:
            return NO_CASTS
        self._wanted.add(name)
        return casts

    def prepare_for_run(self) -> None:
        try:
            self._reader = MMDBReader(self.database_file_name)
        except (OSError, ValueError, TypeError) as e:
            # Same shape as AbstractGeoIPDissector.java:80-82 so the adapters'
            # error surfaces match ("<class>:<message>") — covers missing
            # files, corrupt databases (InvalidDatabaseError) and an unset
            # database path alike.
            detail = getattr(e, "strerror", None) or e
            raise InvalidDissectorException(
                f"{type(self).__name__}:{self.database_file_name} ({detail})"
            )

    def dissect(self, parsable: Parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        if field is None:
            return
        value = field.value.get_string()
        if not value:
            return
        try:
            addr = ipaddress.ip_address(value)
        except ValueError:
            return
        data = self._reader.lookup_address(addr) if self._reader else None
        if data is None:
            return
        self.extract(parsable, input_name, data)

    def extract(self, parsable: Parsable, input_name: str, data: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _want(self, name: str) -> bool:
        return name in self._wanted


class GeoIPCountryDissector(AbstractGeoIPDissector):
    """continent.name/.code + country.name/.iso/.getconfidence/.isineuropeanunion
    (GeoIPCountryDissector.java:50-58, 126-155)."""

    _CASTS_TABLE = {
        "continent.name": STRING_ONLY,
        "continent.code": STRING_ONLY,
        "country.name": STRING_ONLY,
        "country.iso": STRING_ONLY,
        "country.getconfidence": STRING_OR_LONG,
        "country.isineuropeanunion": STRING_OR_LONG,
    }

    def get_possible_output(self) -> List[str]:
        return [
            "STRING:continent.name",
            "STRING:continent.code",
            "STRING:country.name",
            "STRING:country.iso",
            "NUMBER:country.getconfidence",
            "BOOLEAN:country.isineuropeanunion",
        ]

    def extract(self, parsable: Parsable, input_name: str, data: Dict[str, Any]) -> None:
        continent = data.get("continent")
        if continent:
            if self._want("continent.name"):
                parsable.add_dissection(
                    input_name, "STRING", "continent.name", _name_en(continent)
                )
            if self._want("continent.code"):
                parsable.add_dissection(
                    input_name, "STRING", "continent.code", continent.get("code")
                )
        country = data.get("country")
        if country:
            if self._want("country.name"):
                parsable.add_dissection(
                    input_name, "STRING", "country.name", _name_en(country)
                )
            if self._want("country.iso"):
                parsable.add_dissection(
                    input_name, "STRING", "country.iso", country.get("iso_code")
                )
            if self._want("country.getconfidence"):
                parsable.add_dissection(
                    input_name, "NUMBER", "country.getconfidence",
                    country.get("confidence"),
                )
            if self._want("country.isineuropeanunion"):
                parsable.add_dissection(
                    input_name, "BOOLEAN", "country.isineuropeanunion",
                    1 if country.get("is_in_european_union") else 0,
                )


class GeoIPCityDissector(GeoIPCountryDissector):
    """Adds subdivision/city/postal/location fields
    (GeoIPCityDissector.java:55-71, 200-277); subdivision is the most
    specific one, i.e. the last entry (:207)."""

    _CASTS_TABLE = {
        **GeoIPCountryDissector._CASTS_TABLE,
        "subdivision.name": STRING_ONLY,
        "subdivision.iso": STRING_ONLY,
        "city.name": STRING_ONLY,
        "city.confidence": STRING_OR_LONG,
        "city.geonameid": STRING_OR_LONG,
        "postal.code": STRING_ONLY,
        "postal.confidence": STRING_OR_LONG,
        "location.latitude": STRING_OR_DOUBLE,
        "location.longitude": STRING_OR_DOUBLE,
        "location.timezone": STRING_ONLY,
        "location.accuracyradius": STRING_OR_LONG,
        "location.averageincome": STRING_OR_LONG,
        "location.metrocode": STRING_OR_LONG,
        "location.populationdensity": STRING_OR_LONG,
    }

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

    def extract(self, parsable: Parsable, input_name: str, data: Dict[str, Any]) -> None:
        super().extract(parsable, input_name, data)

        subdivisions = data.get("subdivisions") or []
        if subdivisions:
            subdivision = subdivisions[-1]  # most specific
            if self._want("subdivision.name"):
                parsable.add_dissection(
                    input_name, "STRING", "subdivision.name", _name_en(subdivision)
                )
            if self._want("subdivision.iso"):
                parsable.add_dissection(
                    input_name, "STRING", "subdivision.iso",
                    subdivision.get("iso_code"),
                )

        city = data.get("city")
        if city:
            if self._want("city.name"):
                parsable.add_dissection(
                    input_name, "STRING", "city.name", _name_en(city)
                )
            if self._want("city.confidence"):
                parsable.add_dissection(
                    input_name, "NUMBER", "city.confidence", city.get("confidence")
                )
            if self._want("city.geonameid"):
                geoname = city.get("geoname_id")
                parsable.add_dissection(
                    input_name, "NUMBER", "city.geonameid",
                    int(geoname) if geoname is not None else None,
                )

        postal = data.get("postal")
        if postal:
            if self._want("postal.code"):
                parsable.add_dissection(
                    input_name, "STRING", "postal.code", postal.get("code")
                )
            if self._want("postal.confidence"):
                parsable.add_dissection(
                    input_name, "NUMBER", "postal.confidence",
                    postal.get("confidence"),
                )

        location = data.get("location")
        if location:
            if self._want("location.latitude"):
                parsable.add_dissection(
                    input_name, "STRING", "location.latitude",
                    _as_float(location.get("latitude")),
                )
            if self._want("location.longitude"):
                parsable.add_dissection(
                    input_name, "STRING", "location.longitude",
                    _as_float(location.get("longitude")),
                )
            if self._want("location.timezone"):
                parsable.add_dissection(
                    input_name, "STRING", "location.timezone",
                    location.get("time_zone"),
                )
            if self._want("location.accuracyradius"):
                parsable.add_dissection(
                    input_name, "NUMBER", "location.accuracyradius",
                    location.get("accuracy_radius"),
                )
            # The reference only emits these when non-null
            # (GeoIPCityDissector.java:261-276).
            if self._want("location.averageincome"):
                value = location.get("average_income")
                if value is not None:
                    parsable.add_dissection(
                        input_name, "NUMBER", "location.averageincome", value
                    )
            if self._want("location.metrocode"):
                value = location.get("metro_code")
                if value is not None:
                    parsable.add_dissection(
                        input_name, "NUMBER", "location.metrocode", value
                    )
            if self._want("location.populationdensity"):
                value = location.get("population_density")
                if value is not None:
                    parsable.add_dissection(
                        input_name, "NUMBER", "location.populationdensity", value
                    )


def _as_float(v: Any) -> Optional[float]:
    return None if v is None else float(v)


class GeoIPASNDissector(AbstractGeoIPDissector):
    """asn.number + asn.organization (GeoIPASNDissector.java:50-51, 88-96)."""

    _CASTS_TABLE = {
        "asn.number": STRING_OR_LONG,
        "asn.organization": STRING_ONLY,
    }

    def get_possible_output(self) -> List[str]:
        return ["ASN:asn.number", "STRING:asn.organization"]

    def extract(self, parsable: Parsable, input_name: str, data: Dict[str, Any]) -> None:
        number = data.get("autonomous_system_number")
        if number is not None and self._want("asn.number"):
            parsable.add_dissection(input_name, "ASN", "asn.number", number)
        org = data.get("autonomous_system_organization")
        if org is not None and self._want("asn.organization"):
            parsable.add_dissection(input_name, "STRING", "asn.organization", org)


class GeoIPISPDissector(GeoIPASNDissector):
    """Adds isp.name + isp.organization (GeoIPISPDissector.java:48-49, 91-99)."""

    _CASTS_TABLE = {
        **GeoIPASNDissector._CASTS_TABLE,
        "isp.name": STRING_ONLY,
        "isp.organization": STRING_ONLY,
    }

    def get_possible_output(self) -> List[str]:
        return super().get_possible_output() + [
            "STRING:isp.name",
            "STRING:isp.organization",
        ]

    def extract(self, parsable: Parsable, input_name: str, data: Dict[str, Any]) -> None:
        super().extract(parsable, input_name, data)
        isp = data.get("isp")
        if isp is not None and self._want("isp.name"):
            parsable.add_dissection(input_name, "STRING", "isp.name", isp)
        org = data.get("organization")
        if org is not None and self._want("isp.organization"):
            parsable.add_dissection(input_name, "STRING", "isp.organization", org)
