"""Public flash prefill op (port of `repro/kernels/flash_prefill/ops.py`).

Model layout (B, S, H, hd) in and out; the kernel reads transposed views.
A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version; `plain=True` forces the plain version for the whole-model check
of `chip_smoke.py`.

Where autograd needs the op's gradient (grad mode on and q, k or v
requiring grad), it runs as `FlashPrefill`, a `torch.autograd.Function`:
on the card the forward kernel also writes the log-sum-exp and the
backward is the hand-written `flash_prefill_bwd` kernel; on the CPU (or
with `plain=True`) the plain forward and `flash_prefill_bwd_ref`.
Otherwise (serving) it takes the plain path below, unchanged.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import flash_prefill_bwd_ref, flash_prefill_ref


class FlashPrefill(torch.autograd.Function):
    """flash_prefill with its gradient; model layout (B, S, heads, hd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, plain):
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kw = dict(causal=causal, window=window, softcap=softcap)
        if plain or not q.is_cuda:
            ot, lse = flash_prefill_ref(qt, kt, vt, return_lse=True, **kw)
        else:
            lse = torch.empty(qt.shape[:3], dtype=torch.float32,
                              device=q.device)
            ot = kernel.flash_prefill(qt, kt, vt, lse=lse, **kw)
        o = ot.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        args = [t.transpose(1, 2) for t in (q, k, v, o)]
        dot = do.contiguous().transpose(1, 2)
        if ctx.plain or not q.is_cuda:
            grads = flash_prefill_bwd_ref(*args, lse, dot, **ctx.kw)
        else:
            grads = kernel.flash_prefill_bwd(*args, lse, dot, **ctx.kw)
        return (*(g.transpose(1, 2) for g in grads), None, None, None, None)


def flash_prefill_op(q, k, v, *, causal: bool = True, window: int = 0,
                     block_q: int = 128, block_kv: int = 256,
                     softcap: float = 0.0, plain: bool = False):
    """`block_q`/`block_kv` size the TPU kernel's tiles; the CUDA kernel
    has fixed 64-row tiles, so they are kept for signature parity only."""
    del block_q, block_kv
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashPrefill.apply(q, k, v, causal, window, softcap, plain)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if plain or not q.is_cuda:
        ot = flash_prefill_ref(qt, kt, vt, causal=causal, window=window,
                               softcap=softcap)
    else:
        ot = kernel.flash_prefill(qt, kt, vt, causal=causal, window=window,
                                  softcap=softcap)
    return ot.transpose(1, 2)
