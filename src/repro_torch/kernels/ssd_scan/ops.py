"""Public SSD scan op (port of `repro/kernels/ssd_scan/ops.py`).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version; `plain=True` forces the plain version for the whole-model check
of `chip_smoke.py`. The kernel takes dt, A, D and h0 in f32 (the model
keeps A and D in its own dtype), so they are cast here; x, B and C are
made contiguous (a no-op on the model's tensors).

Where autograd needs the op's gradient (grad mode on and an input that
requires grad), it runs as `SsdScan`, a `torch.autograd.Function`: on the
card the forward kernel also keeps each chunk's carried-in state, a_cum
and C.B^T, and the backward is the hand-written `ssd_scan_bwd` kernel; on
the CPU (or with `plain=True`) the plain forward and `ssd_scan_bwd_ref`.
The casts above stay outside the Function, so autograd hands each
gradient back in its input's dtype. Otherwise (serving) the op takes the
path below, unchanged.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def _f32(t):
    return t.float().contiguous()


class SsdScan(torch.autograd.Function):
    """ssd_scan with its gradient; x, B, C in one dtype, dt, A, D, h0 f32,
    all contiguous. A gradient of None (an output the loss does not use)
    counts as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk, plain):
        ctx.set_materialize_grads(False)
        if plain or not x.is_cuda:
            y, h = ref.ssd_scan_ref(x, dt, A, B, C, D, chunk=chunk, h0=h0)
            kept = ()
        else:
            y, h, kept = kernel.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                                         h0=h0, keep_scratch=True)
        ctx.save_for_backward(x, dt, A, B, C, D, h0, *kept)
        ctx.chunk, ctx.plain = chunk, plain
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, D, h0, *kept = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else \
            dy.to(x.dtype).contiguous()
        dh = None if dh is None else _f32(dh)
        if ctx.plain or not x.is_cuda:
            grads = ref.ssd_scan_bwd_ref(x, dt, A, B, C, D, dy, dh,
                                         chunk=ctx.chunk, h0=h0)
        else:
            grads = kernel.ssd_scan_bwd(x, dt, A, B, C, D, kept, dy, dh,
                                        chunk=ctx.chunk, h0=h0)
        return (*grads, None, None)


def ssd_scan_op(x, dt, A, B, C, D, *, chunk: int = 128, h0=None,
                plain: bool = False):
    """x: (b, S, nh, hd); dt: (b, S, nh); A, D: (nh,); B, C: (b, S, G, N);
    h0: (b, nh, hd, N) or None (zeros). S is a multiple of `chunk`.
    Returns (y (b, S, nh, hd), h_final (b, nh, hd, N) f32)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        return SsdScan.apply(
            x.contiguous(), _f32(dt), _f32(A), B.contiguous(),
            C.contiguous(), _f32(D), None if h0 is None else _f32(h0),
            chunk, plain)
    if plain or not x.is_cuda:
        return ref.ssd_scan_ref(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    return kernel.ssd_scan(
        x.contiguous(), _f32(dt), _f32(A), B.contiguous(), C.contiguous(),
        _f32(D), chunk=chunk, h0=None if h0 is None else _f32(h0))
