"""The four CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(decided inside the ``cuda_device`` fixture, never at import).  This file
imports neither jax nor the JAX package, so it also runs on a machine
without them; there, skip the JAX-forcing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.tools.demolog import HEADLINE_FIELDS, generate_combined_lines
from logparser_tpu_torch.tpu import kernels, pipeline
from logparser_tpu_torch.tpu.runtime import encode_batch

pytestmark = pytest.mark.cuda

FIELDS = ["IP:connection.client.host", "BYTES:response.body.bytes",
          "TIME.EPOCH:request.receive.time.epoch", "HTTP.URI:request.firstline.uri"]
_PREFIX = '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET / HTTP/1.0" 200'
EDGE_LINES = [
    _PREFIX + ' 0 "x" "esc \\" quote"',
    '1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET /p\\" HTTP/1.0" 200 0 "x" "y"',
    _PREFIX + ' - "x" "y"',
    _PREFIX + ' 12345678901234567890 "x" "y"',
    '1.2.3.4 - - [01/jan/2024:00:00:00 -0930] "GET /x" 200 5 "x" "y"',
    '1.2.3.4 - - [29/Feb/2023:00:00:00 +1400] "GET / HTTP/1.1" 200 5 "x" "y"',
    _PREFIX + ' 0 "x" "café ☃"',
    "", '"', "completely broken line",
]


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lines(seed=5):
    rng = np.random.default_rng(seed)
    lines = generate_combined_lines(3000, seed=seed, garbage_fraction=0.05) + EDGE_LINES
    common = [ln.rsplit(' "', 2)[0] for ln in generate_combined_lines(200, seed=seed)]
    noise = [bytes(rng.integers(1, 256, size=int(rng.integers(0, 200)), dtype=np.uint8))
             .replace(b"\n", b" ") for _ in range(200)]
    return lines + common + noise


# A separator longer than one 32-bit plane word (the split kernel's
# cross-word literal shift).
LONG_SEP = "%h " + "=" * 40 + ' %u %t "%r" %>s %b'


@pytest.mark.parametrize("fmt", ["combined", "combined\ncommon", LONG_SEP])
@pytest.mark.parametrize("line_len", [0, 8191])
def test_kernels_equal_plain_versions(cuda_device, fmt, line_len):
    ex = TorchBatchParser(fmt, FIELDS, device=cuda_device).executor
    lines = _lines()
    lines += [ln.replace(" - ", " " + "=" * 40 + " ", 1).rsplit(' "', 2)[0]
              for ln in generate_combined_lines(300, seed=9)]
    buf, lengths, _ = encode_batch(lines, line_len=line_len)
    buf = torch.from_numpy(buf).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    for t in ex.unit_tables:
        got = kernels.split(t.split, buf, lengths)
        want = pipeline.compute_split(t.split.program, buf, lengths)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        starts, ends, _ = got
        comps = kernels.span_stages(t.stages, buf, starts, ends)
        assert torch.equal(comps, pipeline.span_stages_plain(
            t.stages, buf, starts, ends, torch.empty_like(comps)))
        for ts in t.ts:
            out = kernels.timestamp(ts, buf, starts, ends)
            assert torch.equal(out, pipeline.timestamp_plain(
                ts, buf, starts, ends, torch.empty_like(out)))
    cpu = TorchBatchParser(fmt, FIELDS, device="cpu").executor
    packed = ex(buf, lengths)
    torch.cuda.synchronize()
    assert np.array_equal(packed.cpu().numpy(), cpu(buf.cpu(), lengths.cpu()).numpy())


@pytest.mark.parametrize("L", [64, 1024, 8191])
def test_kernels_on_random_buffers(cuda_device, L):
    """Separator-heavy random bytes, any length in [0, L], and garbage
    past each line's length (the escape scan reads the whole row)."""
    rng = np.random.default_rng(L)
    alphabet = np.frombuffer(b' "[]\\-0123456789/:+abcGETHTP.=', dtype=np.uint8)
    buf = torch.from_numpy(rng.choice(alphabet, size=(1500, L)).astype(np.uint8))
    lengths = torch.from_numpy(rng.integers(0, L + 1, size=1500).astype(np.int32))
    for fmt in ("combined", LONG_SEP):
        gpu = TorchBatchParser(fmt, FIELDS, device=cuda_device).executor
        cpu = TorchBatchParser(fmt, FIELDS, device="cpu").executor
        packed = gpu(buf.to(cuda_device), lengths.to(cuda_device)).cpu()
        assert torch.equal(packed, cpu(buf, lengths))


def test_parse_batch_on_the_card_equals_the_cpu(cuda_device):
    lines = generate_combined_lines(5000, seed=42, garbage_fraction=0.01) + EDGE_LINES
    kernels.reset_launch_counts()
    gpu = TorchBatchParser("combined", HEADLINE_FIELDS).parse_batch(lines)
    assert all(n == 1 for n in kernels.launch_counts().values())
    cpu = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu").parse_batch(lines)
    assert gpu.to_dict() == cpu.to_dict()
    assert gpu.needs_host.tolist() == cpu.needs_host.tolist()


def test_kernel_rejects_cpu_tables_with_cuda_data(cuda_device):
    ex = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu").executor
    buf, lengths, _ = encode_batch(EDGE_LINES)
    with pytest.raises(ValueError):
        kernels.split(ex.unit_tables[0].split, torch.from_numpy(buf).to(cuda_device),
                      torch.from_numpy(lengths).to(cuda_device))
