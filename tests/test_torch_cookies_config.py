"""The cookies_uniqueid configuration as a whole equals the reference.

``demolog.COOKIE_FORMAT`` / ``COOKIE_FIELDS`` with the mod_unique_id type
remapping over ``cookie_lines(2000)`` plus ``cookie_edge_lines()``:
``TorchBatchParser(device="cpu")`` against ``TpuBatchParser`` on the
packed ``[K + 4V, B]`` words, ``needs_host``, ``to_dict()`` and Arrow (``strings="copy"`` tables equal,
``strings="view"`` schema and values equal) on every row, the host
oracle's included; the port regrows its slots 16 -> 128 as the
reference does.
"""
import pytest

from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from test_torch_harness import assert_results_equal, packed_mismatch

from logparser_tpu_torch.tools.demolog import (
    COOKIE_FIELDS,
    COOKIE_FORMAT,
    COOKIE_REMAPPINGS,
    cookie_edge_lines,
    cookie_lines,
)


@pytest.fixture(scope="module")
def cookie_reference():
    """One reference parser for the configuration, grown to the 128-slot
    cap before its first batch (one compile instead of four: the results
    do not depend on the slot count the growth passes through)."""
    ref = TpuBatchParser(COOKIE_FORMAT, COOKIE_FIELDS, type_remappings=COOKIE_REMAPPINGS)
    while ref._grow_csr_slots():
        pass
    return ref


def test_cookies_uniqueid_matches_reference(cookie_reference):
    """The slice as a whole: B = 2,000 generated lines plus the edge
    lines.  The port's packed words over the reference's 128-slot units
    equal the reference executor's; the port regrows 16 -> 128 slots;
    needs_host, to_dict(),
    to_arrow(strings="copy") (Table.equals) and the string_view schema
    and values equal the reference's on every row, the host oracle's
    included."""
    ref_p = cookie_reference
    assert ref_p._unit_oracle_fields == [[]]
    lines = cookie_lines(2000) + cookie_edge_lines()
    assert packed_mismatch(ref_p, lines) is None
    want = ref_p.parse_batch(lines)
    ours_p = TorchBatchParser(COOKIE_FORMAT, COOKIE_FIELDS, device="cpu",
                              type_remappings=COOKIE_REMAPPINGS)
    ours = ours_p.parse_batch(lines)
    assert ours.csr_regrows == 3 and ours_p.csr_slots == 128
    host = assert_results_equal(ours, want, COOKIE_FIELDS)
    assert len(lines) - 1 in host          # past the cap: the oracle's values
    assert ours.to_arrow(strings="copy").equals(
        want.to_arrow(include_validity=True, strings="copy"))
    a, b = ours.to_arrow(), want.to_arrow()
    assert a.schema.equals(b.schema)
    assert a.to_pylist() == b.to_pylist()
    sid = ours.to_pylist("HTTP.COOKIE:request.cookies.sid")
    assert sum(v is not None for v in sid) > 400
    exp = ours.to_pylist("TIME.EPOCH:response.cookies.sid.expires")
    assert 1798761600000 in exp      # Thu, 01-Jan-2027 00:00:00 GMT
