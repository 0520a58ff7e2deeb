"""GeoIP for the port: the .mmdb reader, the dissectors (plan resolution
reads their outputs, the host oracle runs them), and the flattened range table the ``geo_lookup`` kernel joins
against (the reference package's ``geoip/``)."""
from .device import GeoDeviceTable, ipv4_to_u32, lookup_rows_plain
from .dissectors import (
    AbstractGeoIPDissector,
    GeoIPASNDissector,
    GeoIPCityDissector,
    GeoIPCountryDissector,
    GeoIPISPDissector,
)
from .mmdb import InvalidDatabaseError, MMDBReader

__all__ = [
    "AbstractGeoIPDissector",
    "GeoIPASNDissector",
    "GeoIPCityDissector",
    "GeoIPCountryDissector",
    "GeoIPISPDissector",
    "GeoDeviceTable",
    "InvalidDatabaseError",
    "MMDBReader",
    "ipv4_to_u32",
    "lookup_rows_plain",
]
