"""The analytics pushdown's parity sweep on the CPU, part 2: the
reference bench's ``representative_spec`` on the URI chain (its string
field is the client IP) and on both GeoIP configurations, held to
``TpuBatchParser(..., extra_dissectors=[...]).aggregate_batch`` (state,
``needs_host`` = the reference's oracle rows among the folded ones,
whose rescued values are folded in); and
a count_by over a GeoIP country, an ``obj`` field with no device lane,
which folds every row it reads to the row path.
"""
import os

import pytest

from logparser_tpu.geoip import GeoIPASNDissector as RefASN
from logparser_tpu.geoip import GeoIPCityDissector as RefCity
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.geoip import GeoIPASNDissector, GeoIPCityDissector
from logparser_tpu_torch.tools import demolog, geoip_testdata
from test_torch_harness import assert_aggregate_matches_reference

N_LINES = 600
SYNTHETIC_NETWORKS = 2048
SYNTHETIC_SEED = 4


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    fixtures = geoip_testdata.ensure_test_databases()
    syn = geoip_testdata.ensure_synthetic_city_database(
        SYNTHETIC_NETWORKS, SYNTHETIC_SEED, str(tmp_path_factory.mktemp("synthetic")))
    return {"geoip_chain": os.path.join(fixtures, "GeoIP2-City-Test.mmdb"),
            "geoip_synthetic": syn,
            "asn": os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb")}


def _geo(name, dbs):
    """(port parser, reference parser, lines) of one GeoIP configuration."""
    city, asn = dbs[name], dbs["asn"]
    if name == "geoip_chain":
        lines = demolog.geoip_chain_lines(N_LINES)
    else:
        nets = geoip_testdata.synthetic_networks(SYNTHETIC_NETWORKS, SYNTHETIC_SEED)
        lines = demolog.geoip_synthetic_lines(N_LINES, nets)
    ours = TorchBatchParser("combined", demolog.GEOIP_FIELDS, device="cpu",
                            extra_dissectors=[GeoIPCityDissector(city),
                                              GeoIPASNDissector(asn)])
    ref = TpuBatchParser("combined", list(demolog.GEOIP_FIELDS),
                         extra_dissectors=[RefCity(city), RefASN(asn)])
    return ours, ref, lines + demolog.geoip_edge_lines()


@pytest.mark.parametrize("name", ["geoip_chain", "geoip_synthetic"])
def test_representative_spec_matches_the_reference(dbs, name):
    ours, ref, lines = _geo(name, dbs)
    spec = demolog.representative_spec(ours)
    assert spec.ops[1].field == "IP:connection.client.host"
    out = assert_aggregate_matches_reference(ref, ours, lines,
                                             [op.as_dict() for op in spec.ops])
    assert out.device_rows > 0.9 * N_LINES


def test_geo_obj_field_folds_every_row(dbs):
    # The country name is an obj field (a GeoIP vocabulary string): no
    # device lane, so every valid row folds to the row path.
    ours, ref, lines = _geo("geoip_chain", dbs)
    field = "STRING:connection.client.host.country.name"
    out = assert_aggregate_matches_reference(ref, ours, lines,
                                             [{"op": "count"}, {"op": "count_by", "field": field}])
    assert out.device_rows == 0 and out.fold_rows > 0.9 * N_LINES
    assert len(out.state.data[1]) >= 1


def test_uri_chain_representative_spec_matches_the_reference():
    fields = demolog.URI_CHAIN_FIELDS
    ours = TorchBatchParser("combined", fields, device="cpu")
    spec = demolog.representative_spec(ours)
    assert spec.ops[1].field == "IP:connection.client.host"
    # Generated lines only: the URI edge lines would regrow the reference
    # to 128 query-string slots, one compile per doubling.
    lines = demolog.generate_combined_lines(N_LINES, seed=53) + demolog.aggregate_edge_lines()
    out = assert_aggregate_matches_reference(TpuBatchParser("combined", list(fields)), ours,
                                             lines, [op.as_dict() for op in spec.ops])
    assert out.device_rows > 0.9 * N_LINES
