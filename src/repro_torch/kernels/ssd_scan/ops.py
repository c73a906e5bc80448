"""Public SSD scan op (port of `repro/kernels/ssd_scan/ops.py`).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version; `plain=True` forces the plain version for the whole-model check
of `chip_smoke.py`. The kernel takes dt, A, D and h0 in f32 (the model
keeps A and D in its own dtype), so they are cast here; x, B and C are
made contiguous (a no-op on the model's tensors). The kernel has no
backward yet: on the card the op raises where autograd would need one
(`build.require_no_grad`).
"""
from __future__ import annotations

from ..build import require_no_grad
from . import kernel, ref


def _f32(t):
    return t.float().contiguous()


def ssd_scan_op(x, dt, A, B, C, D, *, chunk: int = 128, h0=None,
                plain: bool = False):
    """x: (b, S, nh, hd); dt: (b, S, nh); A, D: (nh,); B, C: (b, S, G, N);
    h0: (b, nh, hd, N) or None (zeros). S is a multiple of `chunk`.
    Returns (y (b, S, nh, hd), h_final (b, nh, hd, N) f32)."""
    if plain or not x.is_cuda:
        return ref.ssd_scan_ref(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    require_no_grad("ssd_scan_op", x, dt, A, B, C, D, h0)
    return kernel.ssd_scan(
        x.contiguous(), _f32(dt), _f32(A), B.contiguous(), C.contiguous(),
        _f32(D), chunk=chunk, h0=None if h0 is None else _f32(h0))
