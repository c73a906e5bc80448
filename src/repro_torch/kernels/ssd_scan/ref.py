"""Plain PyTorch versions of the SSD scan (port of
`repro/kernels/ssd_scan/ref.py`).

`ssd_scan_ref` delegates to the model-side chunked implementation, itself
held against the sequential recurrence; `ssd_scan_bwd_ref`, its gradient,
differentiates that implementation. `ssd_scan_split_ref` computes the
same function in the three phases of the CUDA kernel (`csrc/ssd_scan.cu`):
chunk states, state passing, chunk outputs by 64-row query tiles with
C.B^T shared by the heads of a group; it is the kernel's algorithm on the
CPU."""
from __future__ import annotations

import torch

from ...models import ssd as _ssd

TILE = 64          # rows of a query tile and of a source tile


def ssd_scan_ref(x, dt, A, B, C, D, *, chunk: int = 128, h0=None):
    return _ssd.ssd_chunked(x, dt, A, B, C, D, chunk, h0=h0)


def ssd_scan_bwd_ref(x, dt, A, B, C, D, dy, dh_final=None, *,
                     chunk: int = 128, h0=None):
    """The gradient of `ssd_scan_ref` (the plain version of the
    `ssd_scan_bwd` kernel): `torch.autograd.grad` through the model's
    `ssd_chunked`, the function JAX's train step differentiates, for dy
    (like y) and dh_final ((b, nh, hd, N) f32, or None for zeros). Returns
    (dx, ddt, dA, dB, dC, dD, dh0), each in its input's dtype; dh0 None
    where h0 is None."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C, D)]
        h0_ = None if h0 is None else h0.detach().requires_grad_(True)
        y, h = _ssd.ssd_chunked(*ins, chunk, h0=h0_)
        outs, cots = [y], [dy.to(y.dtype)]
        if dh_final is not None:
            outs.append(h)
            cots.append(dh_final.to(h.dtype))
        leaves = ins + ([h0_] if h0_ is not None else [])
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (*grads[:6], grads[6] if h0 is not None else None)


def ssd_scan_sequential(x, dt, A, B, C, D, h0=None):
    return _ssd.ssd_reference(x, dt, A, B, C, D, h0=h0)


def ssd_scan_split_ref(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """x: (b, S, nh, hd); dt: (b, S, nh); A, D: (nh,); B, C: (b, S, G, N);
    h0: (b, nh, hd, N) or None. S is a multiple of `chunk`. Returns (y in
    x's dtype, h_final f32), all arithmetic f32."""
    f32 = torch.float32
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep, Q = nh // G, chunk
    nc = S // Q
    xc = x.to(f32).reshape(b, nc, Q, nh, hd)
    dtc = dt.to(f32).reshape(b, nc, Q, nh)
    Bc = B.to(f32).reshape(b, nc, Q, G, N)
    Cc = C.to(f32).reshape(b, nc, Q, G, N)
    gB = Bc.repeat_interleave(rep, dim=3)           # each head's group's B
    xdt = xc * dtc[..., None]

    # 1. chunk states: a_cum within the chunk, S_c = (x dt w)^T B with
    #    w = exp(a_last - a_cum)
    acum = torch.cumsum(dtc * A.to(f32), dim=2)             # (b, nc, Q, nh)
    w = torch.exp(acum[:, :, -1:] - acum)
    states = torch.einsum("bcqhd,bcqhn->bchdn", xdt * w[..., None], gB)

    # 2. state passing: h_in[c] = h; h = h exp(a_last_c) + S_c
    h = (torch.zeros(b, nh, hd, N, dtype=f32, device=x.device) if h0 is None
         else h0.to(f32).clone())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(acum[:, c, -1])[..., None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                 # (b, nc, nh, hd, N)

    # 3. chunk outputs, one query tile at a time: C.B^T once per (chunk,
    #    group, query tile, source tile), the decay per head for s <= t only
    y = torch.empty(b, nc, Q, nh, hd, dtype=f32, device=x.device)
    for t0 in range(0, Q, TILE):
        t1 = min(t0 + TILE, Q)
        Ct = Cc[:, :, t0:t1]                                # (b, nc, T, G, N)
        at = acum[:, :, t0:t1]                              # (b, nc, T, nh)
        Ch = Ct.repeat_interleave(rep, dim=3)
        acc = torch.einsum("bcthn,bchdn->bcthd", Ch, h_in) \
            * torch.exp(at)[..., None]
        for s0 in range(0, t1, TILE):
            s1 = min(s0 + TILE, Q)
            cb = torch.einsum("bctgn,bcsgn->bcgts", Ct, Bc[:, :, s0:s1])
            cb = cb.repeat_interleave(rep, dim=2)           # (b, nc, nh, T, S)
            tpos = torch.arange(t0, t1, device=x.device)[:, None]
            spos = torch.arange(s0, s1, device=x.device)[None, :]
            causal = spos <= tpos
            diff = at.permute(0, 1, 3, 2)[..., :, None] \
                - acum[:, :, s0:s1].permute(0, 1, 3, 2)[..., None, :]
            decay = torch.exp(torch.where(causal, diff, torch.zeros(())))
            p = torch.where(causal, cb * decay, torch.zeros(()))
            acc = acc + torch.einsum("bchts,bcshd->bcthd", p,
                                     xdt[:, :, s0:s1])
        y[:, :, t0:t1] = acc
    y = y.reshape(b, S, nh, hd) + x.to(f32) * D.to(f32)[:, None]
    return y.to(x.dtype), h
