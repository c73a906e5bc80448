"""Public flash prefill op (port of `repro/kernels/flash_prefill/ops.py`).

Model layout (B, S, H, hd) in and out; the kernel reads transposed views.
A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version; `plain=True` forces the plain version for the whole-model check
of `chip_smoke.py`.
"""
from __future__ import annotations

from . import kernel
from .ref import flash_prefill_ref


def flash_prefill_op(q, k, v, *, causal: bool = True, window: int = 0,
                     block_q: int = 128, block_kv: int = 256,
                     softcap: float = 0.0, plain: bool = False):
    """`block_q`/`block_kv` size the TPU kernel's tiles; the CUDA kernel
    has fixed 64-row tiles, so they are kept for signature parity only."""
    del block_q, block_kv
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if plain or not q.is_cuda:
        ot = flash_prefill_ref(qt, kt, vt, causal=causal, window=window,
                               softcap=softcap)
    else:
        ot = kernel.flash_prefill(qt, kt, vt, causal=causal, window=window,
                                  softcap=softcap)
    return ot.transpose(1, 2)
