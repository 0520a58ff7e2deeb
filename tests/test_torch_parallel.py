"""The port's device mesh (logparser_tpu_torch.parallel) against the
reference's on the CPU, case for case with tests/test_parallel.py.

The port's mesh is laid over ``[cpu] * 8`` (``parallel.mesh.local_devices``
replaced with pytest's monkeypatch), the reference's over its 8 virtual
CPU devices (tests/conftest.py).  On CPU tensors the ``sp_split`` and
``counters`` wrappers run their plain versions.  Inputs come from the
demolog generators and seeded numpy; every output is integers or
booleans, so every comparison is exact (tolerance 0).
"""
import numpy as np
import pytest
import torch

import jax

from logparser_tpu.httpd.apache import ApacheHttpdLogFormatDissector
from logparser_tpu.parallel import aggregate_counters as ref_aggregate_counters
from logparser_tpu.parallel import data_parallel_runner as ref_dp_runner
from logparser_tpu.parallel import make_mesh as ref_make_mesh
from logparser_tpu.parallel import sequence_parallel_runner as ref_sp_runner
from logparser_tpu.tools.demolog import generate_combined_lines
from logparser_tpu.tpu.program import compile_device_program as ref_compile
from logparser_tpu.tpu.runtime import encode_batch
from logparser_tpu.tpu.runtime import run_program as ref_run_program
from logparser_tpu_torch.httpd.apache import ApacheLogFormat
from logparser_tpu_torch.parallel import mesh
from logparser_tpu_torch.tools.demolog import long_combined_lines
from logparser_tpu_torch.tpu import kernels
from logparser_tpu_torch.tpu.program import compile_device_program
from logparser_tpu_torch.tpu.runtime import run_program

CPU = torch.device("cpu")
KEYS = ("valid", "starts", "ends")


@pytest.fixture(autouse=True)
def eight_cpu_devices(monkeypatch):
    monkeypatch.setattr(mesh, "local_devices", lambda: [CPU] * 8)


def _programs(fmt):
    """(reference program, port program) of one LogFormat."""
    return (ref_compile(ApacheHttpdLogFormatDissector(fmt)),
            compile_device_program(ApacheLogFormat(fmt)))


def _encode(lines, line_len):
    buf, lengths, overflow = encode_batch(lines, line_len=line_len)
    assert not overflow
    return buf, lengths


def _assert_equal(got, want):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                      err_msg=key)


def _sp_both(programs, buf, lengths, n_data=2, n_seq=4):
    """(port SP, reference SP) over the same buffer, asserted equal."""
    ref_prog, prog = programs
    L = buf.shape[1]
    want = ref_sp_runner(ref_prog, ref_make_mesh(n_data, n_seq), L)(buf, lengths)
    got = mesh.sequence_parallel_runner(prog, mesh.make_mesh(n_data, n_seq), L)(
        buf, lengths)
    _assert_equal({k: v.numpy() for k, v in got.items()}, want)
    return got


def _assert_sp_matches(programs, buf, lengths, n_data=2, n_seq=4):
    """The port's SP equals the reference's SP and its single-device
    run_program (test_parallel.py's _assert_sp_matches)."""
    got = _sp_both(programs, buf, lengths, n_data, n_seq)
    _assert_equal({k: v.numpy() for k, v in got.items()},
                  ref_run_program(programs[0], buf, lengths))
    return got


@pytest.fixture(scope="module")
def programs():
    return _programs("combined")


@pytest.fixture(scope="module")
def batch():
    lines = generate_combined_lines(64, seed=11, garbage_fraction=0.05)
    buf, lengths, _ = encode_batch(lines, line_len=512)
    return buf, lengths


@pytest.fixture(scope="module")
def sep3_programs():
    # " - " between tokens: a 3-byte separator (halo width 2).
    return _programs("%h - %u - %{Referer}i")


def test_have_8_devices():
    assert len(jax.devices()) == 8
    assert len(mesh.local_devices()) == 8
    m = mesh.make_mesh(n_data=2, n_seq=4)
    assert m.shape == (2, 4) and m.size == 8 and m.axis_names == ("data", "seq")
    assert m.home == CPU and m.data_devices == [CPU, CPU]


def test_data_parallel_matches_single(programs, batch):
    ref_prog, prog = programs
    buf, lengths = batch
    want = ref_run_program(ref_prog, buf, lengths)
    _assert_equal(ref_dp_runner(ref_prog, ref_make_mesh(n_data=8))(buf, lengths), want)
    got = mesh.data_parallel_runner(prog, mesh.make_mesh(n_data=8))(buf, lengths)
    _assert_equal({k: v.numpy() for k, v in got.items()}, want)
    single = run_program(prog, buf, lengths, device="cpu")
    _assert_equal(got, {k: v.numpy() for k, v in single.items()})


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_sequence_parallel_matches_reference(programs, batch, shape):
    buf, lengths = batch
    _assert_sp_matches(programs, buf, lengths, *shape)


# ---------------------------------------------------------------------------
# Boundary-adversarial SP cases (tests/test_parallel.py's
# TestSequenceParallelBoundaries): separators straddling shard edges, lines
# shorter than one shard, shards of pure padding.
# ---------------------------------------------------------------------------


class TestSequenceParallelBoundaries:
    def test_multibyte_separator_straddles_every_offset(self, sep3_programs):
        # L=64, n_seq=4 -> shard width 16: the separator slides across
        # both edges (positions 14..17).
        lines = [f"{'h' * pad} - user{pad % 7} - ref/{pad}" for pad in range(12, 20)]
        _assert_sp_matches(sep3_programs, *_encode(lines, 64))

    def test_line_shorter_than_one_shard(self, sep3_programs):
        lines = ["a - b - c", "x - y - z", "h - u - r", "p - q - s"]
        out = _assert_sp_matches(sep3_programs, *_encode(lines, 64))
        assert out["valid"].all()

    def test_empty_and_garbage_lines(self, sep3_programs):
        lines = ["", " - ", "- -", "a - b - c", "nosep", " - x - y"]
        _assert_sp_matches(sep3_programs, *_encode(lines, 64))

    def test_separator_at_exact_line_end(self, sep3_programs):
        lines = ["a - b - ", "h" * 13 + " - u - "]
        _assert_sp_matches(sep3_programs, *_encode(lines, 64))

    def test_combined_on_narrow_shards(self, programs):
        lines = generate_combined_lines(32, seed=7, garbage_fraction=0.1)
        _assert_sp_matches(programs, *_encode(lines, 512), n_data=1, n_seq=8)

    def test_decoy_separator_before_cursor(self, sep3_programs):
        lines = ["a-b - u - r", "a - b-c - d - e"]
        _assert_sp_matches(sep3_programs, *_encode(lines, 64))

    def test_last_shard_pure_padding(self, sep3_programs):
        lines = ["aa - bb - cc", "dd - ee - ff"]
        out = _assert_sp_matches(sep3_programs, *_encode(lines, 128))
        assert out["valid"].all()


# ---------------------------------------------------------------------------
# Cases the reference's tests do not have.
# ---------------------------------------------------------------------------


def test_escaped_quote_rows_follow_the_reference_sp(programs):
    """The reference's SP body has no escape parity, its run_program has:
    rows with ``\\"`` in the user-agent differ between the two, and the
    port's SP follows the reference's SP."""
    edge = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 0 "x" '
    lines = [edge + '"esc \\" quote"', edge + '"tail\\"', edge + '"even\\\\"',
             edge + '"a \\" b \\" c"'] + generate_combined_lines(4, seed=3)
    buf, lengths = _encode(lines, 256)
    got = _sp_both(programs, buf, lengths)
    single = ref_run_program(programs[0], buf, lengths)
    differ = np.nonzero(got["valid"].numpy() != np.asarray(single["valid"]))[0]
    assert differ.size and all('\\"' in lines[i] for i in differ)


def test_lit_and_to_end_ops():
    """A leading literal (a ``lit`` op, here 10 bytes across the 8-byte
    shard edge) and a last token to the end (``to_end``)."""
    progs = _programs("[[[[[[[[[[%h] %u %>s")
    assert [o.kind for o in progs[1].ops] == ["lit", "until_lit", "until_lit", "to_end"]
    assert [o.kind for o in progs[0].ops] == [o.kind for o in progs[1].ops]
    lines = ["[" * 10 + "1.2.3.4] u 200", "[" * 10 + "h] - 404", "[" * 9 + "x] u 200",
             "[" * 10, "[" * 11 + "] a b", "", "[" * 10 + "] ] 3",
             "[" * 10 + "9.9.9.9] someone 5000000"]
    buf, lengths = _encode(lines, 64)
    for shape in ((2, 4), (1, 8)):
        out = _sp_both(progs, buf, lengths, *shape)
        assert out["valid"].sum() >= 3


def test_nul_separator_format():
    """NUL separators: an unowned byte reads 0, so the ``cursor + len <=
    length`` guard is what rejects a match in the padding."""
    progs = _programs("%h\x00%u\x00%>s")
    lines = [b"1.2.3.4\x00u\x00200", b"1.2.3.4\x00u", b"1.2.3.4\x00\x00200",
             b"a\x00b\x00c\x00\x00", b"", b"x" * 15 + b"\x00" + b"y" * 15 + b"\x00z"]
    buf, lengths = _encode(lines, 64)
    _sp_both(progs, buf, lengths)
    _sp_both(progs, buf, lengths, 1, 8)


def test_long_lines_past_the_span_cap(programs):
    """Lines of 8,192 to 16,000 bytes (past the 8,191-byte bucket the
    split kernel takes) at L = 16,384 on a (1, 4) mesh."""
    lines = long_combined_lines(5, seed=63, max_len=16000) + ["completely broken line"]
    buf, lengths = _encode(lines, 16384)
    out = _sp_both(programs, buf, lengths, 1, 4)
    assert out["valid"].numpy().tolist() == [True] * 5 + [False]
    assert int(lengths[:5].min()) >= 8192


def test_value_errors(programs):
    _, prog = programs
    # L not a multiple of the seq width (the reference's shard_map fails
    # at its call).
    buf, lengths = _encode(["x"] * 8, 250)
    with pytest.raises(ValueError):
        ref_sp_runner(programs[0], ref_make_mesh(2, 4), 250)(buf, lengths)
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh.sequence_parallel_runner(prog, mesh.make_mesh(2, 4), 250)
    # A halo wider than a shard: a 42-byte separator over 8-byte shards
    # (the reference fails while tracing).
    wide = _programs("%h " + "=" * 40 + " %u")
    buf, lengths = _encode(["a " + "=" * 40 + " b"] * 8, 64)
    with pytest.raises(TypeError):
        ref_sp_runner(wide[0], ref_make_mesh(1, 8), 64)(buf, lengths)
    with pytest.raises(ValueError, match="halo"):
        mesh.sequence_parallel_runner(wide[1], mesh.make_mesh(1, 8), 64)
    # Too few devices, with the reference's message.
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        ref_make_mesh(4, 4)
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        mesh.make_mesh(4, 4)
    # A batch the data width does not divide.
    buf, lengths = _encode(["x"] * 63, 64)
    with pytest.raises(ValueError):
        ref_dp_runner(programs[0], ref_make_mesh(8))(buf, lengths)
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh.data_parallel_runner(prog, mesh.make_mesh(8))(buf, lengths)


@pytest.mark.parametrize("n", [64, 61])
@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
def test_aggregate_counters_match_the_reference(n, dtype):
    rng = np.random.default_rng(n)
    good = rng.random(n) < 0.75
    bad = ~good
    if dtype is np.int32:
        good, bad = good.astype(np.int32) * 3, bad.astype(np.int32)
    want = ref_aggregate_counters(ref_make_mesh(8), good, bad)
    kernels.reset_launch_counts()
    got = mesh.aggregate_counters(mesh.make_mesh(8), good, bad)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.dim() == 0
        assert int(g) == int(w) and np.asarray(w).dtype == np.int32
    assert kernels.launch_counts()["counters"] == 0   # CPU: the plain version


_C = [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("devices, B, want", [
    ([_C[0]] * 4, 64, [(_C[0], 0, 64)]),                          # one card: one launch
    (_C, 64, [(_C[i], 16 * i, 16 * (i + 1)) for i in range(4)]),   # four cards: four
    ([_C[0], _C[0], _C[1], _C[1]], 64, [(_C[0], 0, 32), (_C[1], 32, 64)]),
    ([_C[0], _C[1], _C[0], _C[1]], 64, [(_C[i % 2], 16 * i, 16 * (i + 1)) for i in range(4)]),
    ([_C[0]] * 4, 10, [(_C[0], 0, 10)]),                          # cut at B, not the padding
    (_C, 10, [(_C[0], 0, 3), (_C[1], 3, 6), (_C[2], 6, 9), (_C[3], 9, 10)]),
    (_C, 5, [(_C[0], 0, 2), (_C[1], 2, 4), (_C[2], 4, 5)]),       # a shard of padding alone
    (_C, 0, []),
])
def test_counter_runs_one_launch_a_stretch_of_one_device(devices, B, want):
    """counter_runs plans aggregate_counters' launches from the mesh's
    devices alone (no card needed): a maximal stretch of consecutive data
    shards on one device is one run, cut at B."""
    assert mesh.counter_runs(mesh.make_mesh(4, devices=devices), B) == want


@pytest.mark.parametrize("n", [4097, 61, 1])
@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
def test_aggregate_counters_on_one_device_match_the_reference(n, dtype):
    """A 4 x 1 mesh whose shards share one device: one run over the
    unpadded masks (tensors sliced in place, numpy arrays too), equal to
    the reference's sums and dtype; int32 masks wrap at 32 bits."""
    rng = np.random.default_rng(n + 7)
    good = rng.random(n) < 0.6
    bad = ~good
    if dtype is np.int32:
        good = rng.integers(-5, 1 << 30, n, dtype=np.int32)
        bad = rng.integers(0, 3, n, dtype=np.int32)
    m = mesh.make_mesh(4, devices=["cpu"] * 4)
    assert mesh.counter_runs(m, n) == [(CPU, 0, n)]
    want = ref_aggregate_counters(ref_make_mesh(4), good, bad)
    for g_in, b_in in ((good, bad), (torch.from_numpy(good), torch.from_numpy(bad))):
        got = mesh.aggregate_counters(m, g_in, b_in)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.dim() == 0 and g.device == CPU
            assert int(g) == int(w) and np.asarray(w).dtype == np.int32


def test_wrappers_check_their_inputs(programs):
    _, prog = programs
    tables = mesh.sp_tables(prog, CPU)
    buf = torch.zeros((4, 16), dtype=torch.uint8)
    cur = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="SP_BYTES runs a lit op"):
        kernels.sp_split(tables, 0, mesh.SP_BYTES, buf, 0, cur)
    with pytest.raises(ValueError, match="halo"):   # op 2 is ' [': a 1-byte halo
        kernels.sp_split(tables, 2, mesh.SP_FIND, buf, 0, cur, cur)
    with pytest.raises(TypeError):
        kernels.sp_split(tables, 0, mesh.SP_FIND, buf.to(torch.int32), 0, cur, cur)
    with pytest.raises(ValueError, match="unknown"):
        kernels.sp_split(tables, 0, 7, buf, 0, cur, cur)
    with pytest.raises(TypeError):
        kernels.counters(cur.to(torch.int64), cur.to(torch.int64))
    with pytest.raises(TypeError):
        kernels.counters(cur, cur.to(torch.bool))
    assert kernels.sp_split(tables, 0, mesh.SP_FIND, buf, 0, cur, cur + 16,
                            l_total=16).tolist() == [16] * 4
    buf[:, 5] = ord(" ")
    assert kernels.sp_split(tables, 0, mesh.SP_FIND, buf, 0, cur, cur + 16,
                            l_total=16).tolist() == [5] * 4


# ---------------------------------------------------------------------------
# The one-launch route (every seq shard of a data shard on one device: the
# sp_program kernel, here its plain version) against the reference's SP.
# ---------------------------------------------------------------------------

_EDGE = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200 0 "x" '


def _exact(line: str, n: int) -> str:
    """A combined line padded in its user-agent to exactly n bytes."""
    return line[:-1] + "u" * (n - len(line.encode())) + '"'


def _sp_edge_lines(fmt: str, L: int):
    """Lines for the one-launch route over L-byte rows: separators that
    slide across every shard edge of the meshes below (so the halo is
    read), a literal ending exactly at the line's length, lines of length
    0, each shard width and L, user-agents holding an escaped quote, and
    garbage rows; padded to a multiple of 8 rows."""
    if fmt == "combined":
        lines = generate_combined_lines(24, seed=17, garbage_fraction=0.1)
        lines += [_EDGE + '"esc \\" quote"', _EDGE + '"tail\\"', _EDGE + '"a \\" b \\" c"']
        lines += [_exact(_EDGE + '"x"', n) for n in (L // 2, L)]
        lines += [(_EDGE * 2)[:n] for n in (L // 8, L // 4)]
        lines += [_EDGE.replace("/ ", "/" + "p" * pad + " ") + '"y"' for pad in range(20, 44)]
        lines += ["", "completely broken line", '"', "x" * L]
    else:   # "%h - %u - %{Referer}i": a 3-byte separator, halo 2
        lines = [f"{'h' * pad} - u{pad % 5} - r" for pad in range(0, L - 8)]
        lines += ["a - b - ", "h" * 13 + " - u - ", "h" * (L - 8) + " - u - ",
                  " - ", "- -", "", "nosep", "a - b"]
        lines += [("a - b - " + "r" * L)[:n] for n in (8, 16, 32, 64)]
    lines += ["garbage"] * (-len(lines) % 8)
    return lines


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (1, 8), (4, 2)])
@pytest.mark.parametrize("fmt,L", [("combined", 256), ("%h - %u - %{Referer}i", 64)])
def test_one_launch_route_matches_reference(fmt, L, shape):
    """Every seq shard of a data shard on the CPU: the runner takes the
    one-launch route (``kernels.sp_program``, its plain version here) and
    equals the reference's ``sequence_parallel_runner`` bit for bit."""
    lines = _sp_edge_lines(fmt, L)
    buf, lengths = _encode(lines, L)
    assert {0, L, L // shape[1]} <= set(lengths.tolist())
    kernels.reset_launch_counts()
    got = _sp_both(_programs(fmt), buf, lengths, *shape)
    assert kernels.launch_counts()["sp_program"] == 0   # the CPU: the plain version
    assert got["valid"].any() and not got["valid"].all()


def test_one_launch_route_equals_the_per_op_route(programs):
    _, prog = programs
    lines = _sp_edge_lines("combined", 256)
    buf, lengths = _encode(lines, 256)
    for shape in ((2, 4), (1, 8), (4, 2)):
        m = mesh.make_mesh(*shape)
        one = mesh.sequence_parallel_runner(prog, m, 256)(buf, lengths)
        per_op = mesh._sp_runner(prog, m, 256, one_launch=False)(buf, lengths)
        _assert_equal({k: v.numpy() for k, v in one.items()},
                      {k: v.numpy() for k, v in per_op.items()})


def test_one_launch_route_launches_once_per_data_shard(monkeypatch, programs):
    """Routed to the kernels (as CUDA tensors are), the runner launches
    ``sp_program`` once per data shard, on a view of the batch's rows (no
    copy: the row stride is L), with as many arguments as its C entry
    point takes; the per-op runner launches ``sp_split`` per op, mode and
    seq shard.  The launches are recorded instead of made."""
    _, prog = programs
    buf, lengths = _encode(generate_combined_lines(16, seed=2), 256)
    tb, tl = torch.from_numpy(buf), torch.from_numpy(lengths)
    calls = []

    def record(name, device, *args):
        assert len(args) + 1 == len(kernels._SIGNATURES[name]), name
        calls.append((name, args))

    monkeypatch.setattr(kernels, "_route", lambda t: True)
    monkeypatch.setattr(kernels, "_launch", record)
    mesh.sequence_parallel_runner(prog, mesh.make_mesh(2, 4), 256)(tb, tl)
    assert [c[0] for c in calls] == ["sp_program"] * 2
    for d, (_, args) in enumerate(calls):
        assert args[0] == tb.data_ptr() + d * 8 * 256 and args[1:5] == (8, 256, 4, 64)
    calls.clear()
    mesh._sp_runner(prog, mesh.make_mesh(2, 4), 256, one_launch=False)(tb, tl)
    n_steps = sum(2 if op.kind == "until_lit" else 1 for op in prog.ops)
    assert [c[0] for c in calls] == ["sp_split"] * (2 * 4 * n_steps)


def test_sp_program_checks_its_inputs(programs):
    _, prog = programs
    tables = mesh.sp_tables(prog, CPU)
    buf = torch.zeros((4, 64), dtype=torch.uint8)
    lengths = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not split evenly"):
        kernels.sp_program(tables, buf, lengths, 3)
    with pytest.raises(TypeError):
        kernels.sp_program(tables, buf.to(torch.int32), lengths, 4)
    with pytest.raises(ValueError, match="runs of bytes"):
        kernels.sp_program(tables, buf.t(), lengths, 4)
    with pytest.raises(ValueError, match="halo"):   # '" "' needs 2 bytes, a shard has 1
        kernels.sp_program(tables, torch.zeros((4, 64), dtype=torch.uint8), lengths, 64)
    with pytest.raises(TypeError):
        kernels.sp_program(tables, buf, lengths.to(torch.int64), 4)
    out = kernels.sp_program(tables, buf, lengths, 4)
    assert out["valid"].dtype == torch.bool and out["starts"].shape == (len(prog.tokens), 4)
    empty = kernels.sp_program(tables, buf[:0], lengths[:0], 4)
    assert empty["valid"].shape == (0,)
