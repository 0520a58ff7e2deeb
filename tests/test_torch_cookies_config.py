"""The cookies_uniqueid configuration as a whole equals the reference.

``demolog.COOKIE_FORMAT`` / ``COOKIE_FIELDS`` with the mod_unique_id type
remapping over ``cookie_lines(2000)`` plus ``cookie_edge_lines()``:
``TorchBatchParser(device="cpu")`` against ``TpuBatchParser`` on the
packed ``[K + 4V, B]`` words, ``needs_host``, ``to_dict()`` and Arrow (``strings="copy"`` tables equal,
``strings="view"`` schema and values equal) on every row the reference
decodes on device; the port regrows its slots 16 -> 128 as the
reference does.
"""
import numpy as np
import pytest

from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from test_torch_harness import packed_mismatch

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
    and values equal the reference's on every row it decodes on device."""
    ref_p = cookie_reference
    assert ref_p._unit_oracle_fields == [[]]
    lines = cookie_lines(2000) + cookie_edge_lines()
    assert packed_mismatch(ref_p, lines) is None
    want = ref_p.parse_batch(lines)
    ours_p = TorchBatchParser(COOKIE_FORMAT, COOKIE_FIELDS, device="cpu",
                              type_remappings=COOKIE_REMAPPINGS)
    ours = ours_p.parse_batch(lines)
    assert ours.csr_regrows == 3 and ours_p.csr_slots == 128
    assert ours.needs_host.tolist() == want.oracle_row_ids.tolist()
    assert len(lines) - 1 in ours.needs_host.tolist()          # past the cap
    host = set(ours.needs_host.tolist())
    keep = np.array([i for i in range(len(lines)) if i not in host])
    g, w = ours.to_dict(), want.to_dict()
    for fid in COOKIE_FIELDS:
        for i in keep.tolist():
            assert g[fid][i] == w[fid][i] and type(g[fid][i]) is type(w[fid][i]), \
                (fid, i, g[fid][i], w[fid][i])
    assert ours.to_arrow(strings="copy").take(keep).equals(
        want.to_arrow(include_validity=True, strings="copy").take(keep))
    a, b = ours.to_arrow(), want.to_arrow()
    assert a.schema.equals(b.schema)
    pa_, pb = a.to_pylist(), b.to_pylist()
    assert all(pa_[i] == pb[i] for i in keep.tolist())
    sid = ours.to_pylist("HTTP.COOKIE:request.cookies.sid")
    assert sum(v is not None for v in sid) > 400
    exp = ours.to_pylist("TIME.EPOCH:response.cookies.sid.expires")
    assert 1798761600000 in exp      # Thu, 01-Jan-2027 00:00:00 GMT
