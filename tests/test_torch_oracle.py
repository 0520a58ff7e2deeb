"""The port's host oracle on the CPU, held to the JAX package's.

``logparser_tpu_torch.httpd.parser.HttpdLoglineParser`` (the per-line
engine ``TorchBatchParser`` rescues lines with) against
``logparser_tpu.httpd.parser.HttpdLoglineParser``, with no batch parser
and no JAX compile.  On each format, with every possible path requested:
each line's delivered values (the record dict, types included) or the
``DissectionFailure`` verdict, ``get_possible_paths()`` and ``get_casts``
of every path.  Exact comparisons throughout.
"""
import pickle

import pytest

from logparser_tpu.core.exceptions import DissectionFailure as RefDissectionFailure
from logparser_tpu.httpd.parser import HttpdLoglineParser as RefParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.core.casts import STRING_ONLY
from logparser_tpu_torch.core.dissector import Dissector
from logparser_tpu_torch.core.exceptions import DissectionFailure, OracleEngineError
from logparser_tpu_torch.httpd.parser import HttpdLoglineParser
from logparser_tpu_torch.tools import demolog
from test_torch_harness import corpus

BINARY_FORMAT = demolog.NGINX_URI_FORMAT.replace("$remote_addr", "$binary_remote_addr", 1)


class Record:
    def __init__(self):
        self.values = {}

    def set_value(self, name, value):
        self.values[name] = value


def _binary_lines(n):
    """nginx_uri lines with the client address as $binary_remote_addr's
    escaped bytes (one in eight with three bytes only)."""
    out = []
    for i, line in enumerate(demolog.nginx_uri_lines(n)):
        ip, _, rest = line.partition(" ")
        if ip.count(".") == 3 and ip.replace(".", "").isdigit():
            octets = [int(o) for o in ip.split(".")][:3 if i % 8 == 7 else 4]
            line = "".join(f"\\x{o:02X}" for o in octets) + " " + rest
        out.append(line)
    return out


# name -> (log format, type remappings, the format's own generated lines)
FORMATS = {
    "combined": ("combined", None, []),
    "common": ("common", None, [ln.rsplit(' "', 2)[0]
                                for ln in demolog.generate_combined_lines(40, seed=12)]),
    "combined_common": ("combined\ncommon", None, []),
    "combinedio_strftime": (demolog.COMBINEDIO_STRFTIME_FORMAT, None,
                            demolog.combinedio_strftime_lines(40)
                            + demolog.strftime_edge_lines()),
    "zonetext": (demolog.ZONETEXT_FORMAT, None, demolog.zonetext_lines(40)),
    "cookies": (demolog.COOKIE_FORMAT, demolog.COOKIE_REMAPPINGS, demolog.cookie_lines(40)),
    "nginx_uri": (demolog.NGINX_URI_FORMAT, None, demolog.nginx_uri_lines(40)),
    "nginx_timing": (demolog.NGINX_TIMING_FORMAT, None, demolog.nginx_timing_lines(40)),
    "binary_remote_addr": (BINARY_FORMAT, None, _binary_lines(40)),
    # Two producers of one field: the value of the later one is kept.
    "two_producers": ("$msec [$time_local] $status", None,
                      [f"17040672{i:02d}.{i:03d} [01/Jan/2024:00:00:{i:02d} +0{i % 10}00] 200"
                       for i in range(12)]
                      + ["1.5 [bad] 200", "x [01/Jan/2024:00:00:00 +0000] 200"]),
}

# Lines on which the reference's own LogFormat regex backtracks for
# minutes under the NGINX formats ($remote_addr's IPv6 alternative); no
# batch parser sends them to its oracle (test_backtracking_lines_skip_the_oracle).
BACKTRACKING = ["a" * 100, '1234567890123456 - - [01/Jan/2024:00:00:00 +0000] '
                '"GET /x HTTP/1.1" 200 5 "-" "u"']


def _shared_lines():
    lines = (corpus(11, n=40, n_random=12) + demolog.uri_edge_lines()
             + demolog.cookie_edge_lines() + demolog.nginx_edge_lines()
             + demolog.geoip_edge_lines())
    return [ln.decode("utf-8", errors="replace") if isinstance(ln, bytes) else ln
            for ln in lines]


SHARED_LINES = _shared_lines()


def _pair(fmt, remaps, stateless=False):
    ref, ours = RefParser(Record, fmt), HttpdLoglineParser(Record, fmt)
    for p in (ref, ours):
        p.all_dissectors[0].stateless = stateless
        if remaps:
            p.apply_config(remaps)
    return ref, ours


def _casts(casts):
    return None if casts is None else sorted(c.value for c in casts)


def _outcome(parser, line, failure):
    try:
        return parser.parse(line, Record()).values
    except failure:
        return "DissectionFailure"


@pytest.mark.parametrize("stateless", [False, True])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_oracle_matches_reference(name, stateless):
    """Stateful (the reference's generic engine) and stateless (its
    compiled line programs, which the batch parsers' oracles run): the
    records equal in values, types and delivery order."""
    fmt, remaps, own = FORMATS[name]
    ref, ours = _pair(fmt, remaps, stateless)
    paths = ref.get_possible_paths()
    assert ours.get_possible_paths() == paths
    ref.add_parse_target("set_value", paths)
    ours.add_parse_target("set_value", paths)
    # get_casts reads the casts of a parse target.
    casts = [_casts(ref.get_casts(path)) for path in paths]
    assert [_casts(ours.get_casts(path)) for path in paths] == casts
    assert sum(c is not None for c in casts) >= len(paths) // 2
    lines = [ln for ln in SHARED_LINES + own
             if not ("$" in fmt and ln in BACKTRACKING)]
    parsed = 0
    for line in lines:
        want = _outcome(ref, line, RefDissectionFailure)
        got = _outcome(ours, line, DissectionFailure)
        assert got == want, (line, got, want)
        if isinstance(want, dict):
            parsed += 1
            assert list(got) == list(want), line
            assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert parsed >= 3


class _Faulty(Dissector):
    """An IP dissector whose own code fails on one address."""

    def get_input_type(self):
        return "IP"

    def get_possible_output(self):
        return ["STRING:echo"]

    def prepare_for_dissect(self, input_name, output_name):
        return STRING_ONLY

    def dissect(self, parsable, input_name):
        value = parsable.get_parsable_field("IP", input_name).value.get_string()
        if value == "6.6.6.6":
            raise RuntimeError("broken")
        parsable.add_dissection(input_name, "STRING", "echo", value)


def test_parse_many_marks_each_line():
    """parse_many: a record per parsed line, None per refused line, an
    OracleEngineError where the engine itself fails -- and the other lines
    still parse."""
    fields = ["STRING:connection.client.host.echo", "STRING:request.status.last"]
    p = HttpdLoglineParser(Record, "common")
    p.add_dissector(_Faulty())
    p.add_parse_target("set_value", fields)
    good = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 5'
    out = p.parse_many([good, "garbage", good.replace("1.2.3.4", "6.6.6.6"), good], Record)
    assert out[0].values == {fields[0]: "1.2.3.4", fields[1]: "200"}
    assert out[1] is None and isinstance(out[2], OracleEngineError)
    assert "broken" in out[2].error and out[3].values == out[0].values


def test_pickled_oracle_parses_the_same():
    fmt, remaps, own = FORMATS["cookies"]
    _, ours = _pair(fmt, remaps)
    ours.add_parse_target("set_value", demolog.COOKIE_FIELDS)
    again = pickle.loads(pickle.dumps(ours))
    for line in own[:10]:
        assert again.parse(line, Record()).values == ours.parse(line, Record()).values


@pytest.mark.parametrize("fmt,fields", [
    (demolog.NGINX_URI_FORMAT, demolog.NGINX_URI_FIELDS),
    (demolog.NGINX_TIMING_FORMAT, demolog.NGINX_TIMING_FIELDS),
])
def test_backtracking_lines_skip_the_oracle(fmt, fields):
    res = TorchBatchParser(fmt, fields, device="cpu").parse_batch(BACKTRACKING)
    assert res.needs_host.tolist() == []
