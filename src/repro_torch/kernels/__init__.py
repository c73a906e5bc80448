"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package has `ref.py` (the plain PyTorch version), `kernel.py` (the
ctypes launch wrapper of its CUDA C++ source in `csrc/`, with a launch
counter) and `ops.py` (the public op in the model's layout: CUDA tensors
to the kernel, CPU tensors to the plain version).
"""
from __future__ import annotations

from typing import Dict


def _launchers():
    from .flash_prefill.kernel import flash_prefill
    from .paged_decode.kernel import paged_decode, paged_insert
    from .prefix_prefill.kernel import prefix_prefill
    return {"paged_decode": paged_decode, "paged_insert": paged_insert,
            "prefix_prefill": prefix_prefill, "flash_prefill": flash_prefill}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last `reset_launch_counts`."""
    return {name: fn.launches for name, fn in _launchers().items()}


def reset_launch_counts():
    for fn in _launchers().values():
        fn.launches = 0
