"""Device-mesh parallel execution (DP over the batch, SP over line length)."""
from .mesh import (
    DeviceMesh,
    aggregate_counters,
    batch_parallel_runner,
    data_parallel_runner,
    dp_device_count,
    dp_shardings,
    local_devices,
    make_mesh,
    sequence_parallel_runner,
)

__all__ = [
    "DeviceMesh",
    "make_mesh",
    "local_devices",
    "batch_parallel_runner",
    "data_parallel_runner",
    "dp_device_count",
    "dp_shardings",
    "sequence_parallel_runner",
    "aggregate_counters",
]
