"""The analytics pushdown's parity sweep on the CPU, part 1: the
reference bench's ``representative_spec`` (count, count_by and top_k on
the first string field, sum on the first numeric field, an hourly
time_bucket on the first epoch field) on the strftime and NGINX
configurations, held to ``TpuBatchParser.aggregate_batch`` (state,
``needs_host`` = the reference's oracle rows among the folded ones,
whose rescued values are folded in).
Where the spec's field has no device lane (NGINX's ``$msec`` epoch and
``$request_time`` are seconds-with-millis values) every row folds to the
row path, as in the reference.
"""
import pytest

from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.tools import demolog
from test_torch_harness import assert_aggregate_matches_reference

N_LINES = 600
CONFIGS = {
    "combinedio_strftime": (demolog.COMBINEDIO_STRFTIME_FORMAT,
                            demolog.COMBINEDIO_STRFTIME_FIELDS,
                            demolog.combinedio_strftime_lines,
                            demolog.strftime_edge_lines),
    "strftime_zonetext": (demolog.ZONETEXT_FORMAT, demolog.ZONETEXT_FIELDS,
                          demolog.zonetext_lines, demolog.strftime_edge_lines),
    "nginx_uri": (demolog.NGINX_URI_FORMAT, demolog.NGINX_URI_FIELDS,
                  demolog.nginx_uri_lines, demolog.nginx_edge_lines),
    "nginx_timing": (demolog.NGINX_TIMING_FORMAT, demolog.NGINX_TIMING_FIELDS,
                     demolog.nginx_timing_lines, demolog.nginx_edge_lines),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_representative_spec_matches_the_reference(name):
    fmt, fields, gen, edge = CONFIGS[name]
    lines = gen(N_LINES) + edge()
    ours = TorchBatchParser(fmt, fields, device="cpu")
    spec = demolog.representative_spec(ours)
    assert [op.op for op in spec.ops][:3] == ["count", "count_by", "top_k"]
    out = assert_aggregate_matches_reference(TpuBatchParser(fmt, list(fields)), ours, lines,
                                             [op.as_dict() for op in spec.ops])
    if name == "nginx_timing":
        assert out.device_rows == 0      # every row folds: no device lane
    else:
        assert out.device_rows > 0.9 * N_LINES
