"""Device pipeline of the port: program, plans, kernels, batch parser."""
from .runtime import encode_batch, run_program

__all__ = ["encode_batch", "run_program"]
