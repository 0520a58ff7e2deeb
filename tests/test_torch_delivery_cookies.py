"""``test_torch_delivery.py``'s checks on cookies_uniqueid, on the CPU.

The same tests -- ``column``, ``span_bytes[_many]``, both Arrow modes, the
device's view rows, ``slice``, ``parse_to_ipc`` across inputs and pool
widths, a held view table -- and the flat wildcard maps of the Cookie and
Set-Cookie ``.*`` fields, on ``COOKIE_FORMAT`` / ``COOKIE_FIELDS`` (seed
50, a few hundred lines plus the cookie edge lines), against
``TpuBatchParser``.  A file of its own: its reference parser compiles at
64 query slots (the corpus here leaves out the edge line past the
128-slot cap, whose host rescue ``test_torch_cookies_config.py`` holds to
the reference), about 45 s on one CPU process.
"""
import pytest

from test_torch_delivery import (  # noqa: F401 -- collected here as well
    _close_parsers,
    check_wildcard_maps,
    get_case,
    test_column_and_ascii_only_match_reference,
    test_device_view_rows_equal_reference_and_are_read,
    test_parse_to_ipc_equal_across_inputs_and_pool_widths,
    test_slice_equals_reference_and_a_solo_parse,
    test_span_bytes_match_reference,
    test_to_arrow_matches_reference_in_both_modes,
    test_view_table_survives_the_next_batch,
)


@pytest.fixture(scope="module")
def case():
    return get_case("cookies_uniqueid")


def test_cookie_wildcard_maps_come_from_the_flat_buffers(case):
    check_wildcard_maps(case)
