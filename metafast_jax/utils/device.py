"""Which algorithm a stage runs on the default device.

All device work runs on JAX's default device.  A few stages have two
algorithms whose costs cross over with problem size on a GPU (PERF.md,
"Routing"); `gpu_path` is the one place that makes that choice.
"""

from __future__ import annotations

import jax


def platform() -> str:
    """Platform of JAX's default device: "gpu" or "cpu"."""
    return jax.devices()[0].platform


def gpu_path(size: int, threshold: int) -> bool:
    """Whether a problem of `size` elements takes its GPU algorithm: only
    on a GPU, and from `threshold` elements up."""
    return size >= threshold and platform() == "gpu"
