"""Launch wrapper of the CUDA kernel in `csrc/ssd_scan.cu`.

Takes the JAX layout, x (b, S, nh, hd), dt (b, S, nh) f32, A and D (nh,)
f32, B and C (b, S, G, N), h0 (b, nh, hd, N) f32 or None, all contiguous
on one CUDA device. Each launch adds one to `ssd_scan.launches`.
"""
from __future__ import annotations

import torch

from ..build import DTYPE_CODES, check, library, require_cuda, stream_of

HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_STATE = 128


def ssd_scan(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """-> (y (b, S, nh, hd) in x's dtype, h_final (b, nh, hd, N) f32)."""
    f32 = torch.float32
    tensors = [x, dt, A, B, C, D] + ([h0] if h0 is not None else [])
    require_cuda("ssd_scan", *tensors)
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError("ssd_scan: x, B, C are f32 or bf16, of one dtype")
    if any(t.dtype != f32 for t in (dt, A, D)) or \
            (h0 is not None and h0.dtype != f32):
        raise TypeError("ssd_scan: dt, A, D and h0 are f32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: every tensor must be contiguous")
    if hd not in HEAD_DIMS or N % 16 or N > MAX_STATE or nh % G:
        raise ValueError(f"ssd_scan: unsupported hd={hd}, N={N}, nh={nh}, "
                         f"G={G}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of "
                         f"chunk={chunk}")
    if tuple(dt.shape) != (b, S, nh) or tuple(C.shape) != tuple(B.shape) \
            or tuple(B.shape[:2]) != (b, S) or A.shape != (nh,) \
            or D.shape != (nh,) \
            or (h0 is not None and tuple(h0.shape) != (b, nh, hd, N)):
        raise ValueError("ssd_scan: inconsistent shapes")
    y = torch.empty_like(x)
    h = torch.empty((b, nh, hd, N), dtype=f32, device=x.device)
    check(library().ssd_scan(
        DTYPE_CODES[x.dtype], hd, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        h.data_ptr(), b, S, nh, G, N, chunk, stream_of(x)), "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
