"""logparser_tpu_torch: the PyTorch / CUDA port of logparser_tpu.

Parses Apache and NGINX access-log lines into typed columns (GeoIP
enrichment included), or aggregates them on the card (``analytics``), on
an NVIDIA H100 through hand-written CUDA kernels (``tpu/kernels.py``,
sources in ``csrc/``).  The JAX package ``logparser_tpu`` stays the reference the
port is held against; this package imports nothing from it and never
imports ``jax``.
"""
__version__ = "0.1.0"

from .tpu.batch import (  # noqa: F401
    BatchResult,
    TorchBatchParser,
    UnsupportedFieldError,
    UnsupportedFormatError,
)
