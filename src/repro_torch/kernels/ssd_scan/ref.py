"""Plain PyTorch versions of the SSD scan (port of
`repro/kernels/ssd_scan/ref.py`).

`ssd_scan_ref` delegates to the model-side chunked implementation, itself
held against the sequential recurrence; `ssd_scan_bwd_ref`, its gradient,
differentiates that implementation. `ssd_scan_split_ref` computes the
same function in the three phases of the CUDA kernel (`csrc/ssd_scan.cu`):
chunk states, state passing, chunk outputs by 64-row query tiles with
C.B^T shared by the heads of a group; it is the kernel's algorithm on the
CPU. `ssd_scan_bwd_split_ref` is the same for the gradient
(`csrc/ssd_scan_bwd.cu`), launch by launch as `ssd_bwd_plan` lays them
out, its products through a hook that can round them as the tensor cores
do (`mm_bf16_split`)."""
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


def mm_f32(a, b, split_a=False, split_b=False):
    """a @ b in f32 (the split flags matter only to `mm_bf16_split`)."""
    return torch.matmul(a, b)


def mm_bf16_split(a, b, split_a=False, split_b=False):
    """a @ b as the bf16 kernel forms it on the tensor cores: each operand
    rounded to bf16 (exact for a bf16 input), an f32 operand flagged split
    entering as hi + lo (hi = bf16(v), lo = bf16(v - hi)) in a second
    product, every product accumulated in f32."""
    bf = torch.bfloat16
    ah, bh = a.to(bf).float(), b.to(bf).float()
    out = torch.matmul(ah, bh)
    if split_a:
        out = out + torch.matmul((a - ah).to(bf).float(), bh)
    if split_b:
        out = out + torch.matmul(ah, (b - bh).to(bf).float())
    return out


def ssd_scan_bwd_split_ref(x, dt, A, B, C, D, dy, dh_final=None, *,
                           chunk: int, h0=None, sm_count: int = 132,
                           mm=mm_f32):
    """The gradient of the scan in the seven launches of
    `csrc/ssd_scan_bwd.cu`, heads per block from `ssd_bwd_plan` (for
    `sm_count` SMs): (1) G_c = C^T (exp(a_cum) dy) by 64-row tiles; (2) the
    reverse state pass, the decay's dot in parts of 256 state elements
    ([n][d] order); (3) per (head block, source tile s): each head's state
    term of dB_s, then for each query tile t >= s and head dP^T = x_s
    dy_t^T dt_s, formed once, dCB^T = dP^T o L^T for s <= t, its colsum and
    rowsum with C.B^T, and the head block's sum of dCB^T times C_t; (4)
    per (head, source tile s): d xdt_s = w_s B_s dS^T + sum_t M^T dy_t, q,
    dx, sum_d d xdt x, dy . x; (5) per (head block, query tile t): the
    state term of dC_t and y_off, then dC_t += dCB B_s over the source
    tiles s <= t from (3)'s summed tiles; (6) d a_cum, its reverse
    cumulative sum, ddt and the chunk parts of dA, dD; (7) dB, dC over
    each group's head blocks, dA, dD over batch and chunks. Every product goes through `mm(a, b,
    split_a, split_b)` with the kernel's split flags (an f32 operand on
    the contracted index). -> (dx, ddt, dA, dB, dC, dD, dh0) as
    `ssd_scan_bwd_ref`, all arithmetic f32."""
    from .kernel import ssd_bwd_plan
    f32 = torch.float32
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep, Q = nh // G, chunk
    nc, BC = S // Q, b * (S // Q)
    plan = ssd_bwd_plan(b, S, nh, hd, G, N, chunk, sm_count)
    hb, nqt = plan.heads_per_block, plan.q_tiles
    QP = nqt * TILE
    dev = x.device

    def rows(t):        # (b, S, ...) -> (b nc, QP, ...), rows past Q zero
        t = t.to(f32).reshape(BC, Q, *t.shape[2:])
        if QP > Q:
            t = torch.cat([t, t.new_zeros(BC, QP - Q, *t.shape[2:])], 1)
        return t
    xc, dyc, dtc, Bc, Cc = rows(x), rows(dy), rows(dt), rows(B), rows(C)
    A, D = A.to(f32), D.to(f32)
    acum = torch.cumsum(dtc * A, 1)                        # (BC, QP, nh)
    a_last = acum[:, Q - 1]                                # (BC, nh)
    pos = torch.arange(QP, device=dev)
    real = (pos < Q).to(f32)

    # what the forward keeps: C.B^T ([s][t]) and each chunk's h_in
    cb = torch.einsum("btgn,bsgn->bgst", Cc, Bc)           # (BC, G, QP, QP)
    w = torch.exp(a_last[:, None] - acum) * real[:, None]
    Bh = Bc.repeat_interleave(rep, 2)                      # (BC, QP, nh, N)
    st = torch.einsum("bqhd,bqhn->bhdn", xc * (dtc * w)[..., None], Bh)
    st = st.reshape(b, nc, nh, hd, N)
    h = torch.zeros(b, nh, hd, N, dtype=f32, device=dev) if h0 is None \
        else h0.to(f32)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(a_last.reshape(b, nc, nh)[:, c])[..., None, None] \
            + st[:, c]
    hin_nd = torch.stack(h_in, 1).transpose(-1, -2).reshape(BC, nh, N, hd)

    # 1. dstate: G_c^T[n][d] = sum_t C_t[n] exp(a_cum_t) dy_t[d]
    Y = torch.exp(acum)[..., None] * dyc                   # (BC, QP, nh, hd)
    Ch = Cc.repeat_interleave(rep, 2)
    GT = torch.zeros(BC, nh, N, hd, dtype=f32, device=dev)
    for t0 in range(0, QP, TILE):
        tl = slice(t0, t0 + TILE)
        GT = GT + mm(Ch[:, tl].permute(0, 2, 3, 1),
                     Y[:, tl].permute(0, 2, 1, 3), False, True)

    # 2. reverse pass over [n][d], the decay's dot in parts of 256
    npass = plan.grid_pass[0]
    GT = GT.reshape(b, nc, nh, N * hd)
    hin_flat = hin_nd.reshape(b, nc, nh, N * hd)
    dh = torch.zeros(b, nh, N * hd, dtype=f32, device=dev) \
        if dh_final is None else \
        dh_final.to(f32).transpose(-1, -2).reshape(b, nh, N * hd)
    dS = [None] * nc
    decay = torch.zeros(b, nc, nh, dtype=f32, device=dev)
    al = a_last.reshape(b, nc, nh)
    padn = npass * 256 - N * hd
    for c in reversed(range(nc)):
        dS[c] = dh
        prod = torch.nn.functional.pad(dh * hin_flat[:, c], (0, padn))
        parts = prod.reshape(b, nh, npass, 256).sum(-1)
        decay[:, c] = torch.exp(al[:, c]) * parts.sum(-1)
        dh = dh * torch.exp(al[:, c])[..., None] + GT[:, c]
    dh0 = dh.reshape(b, nh, N, hd).transpose(-1, -2)
    dS = torch.stack(dS, 1).reshape(BC, nh, N, hd)

    # 3-5. source, head and query sides by (head block, 64-row tile)
    nhb = nh // hb
    dBp = torch.zeros(BC, QP, nhb, N, dtype=f32, device=dev)
    dCp = torch.zeros(BC, QP, nhb, N, dtype=f32, device=dev)
    gxs = torch.zeros(BC, QP, nh, hd, dtype=f32, device=dev)
    rowv = torch.zeros(nqt, BC, nh, QP, dtype=f32, device=dev)
    col, qv, xg, yo = (torch.zeros(BC, nh, QP, dtype=f32, device=dev)
                       for _ in range(4))
    dyx = torch.zeros(nqt, BC, nh, dtype=f32, device=dev)
    ach = acum.permute(0, 2, 1)                            # (BC, nh, QP)
    dth = dtc.permute(0, 2, 1)
    for j in range(nhb):
        hs = slice(j * hb, (j + 1) * hb)
        g = j * hb // rep
        a_h, d_h = ach[:, hs], dth[:, hs]                  # (BC, hb, QP)
        wl = torch.exp(a_last[:, hs, None] - a_h) * real   # w_s
        dsum = {}
        for si in range(nqt):
            sl = slice(si * TILE, (si + 1) * TILE)
            xs = xc[:, sl, hs].permute(0, 2, 1, 3)         # (BC, hb, 64, hd)
            dSh = dS[:, hs]                                 # (BC, hb, N, hd)
            # 3. source side: each head's state term of dB_s, then per
            # query tile each head's dP^T and the heads' sum of dCB^T
            tmp = mm(xs, dSh.transpose(-1, -2), False, True)
            dB_s = (tmp * (d_h[:, :, sl] * wl[:, :, sl])[..., None]).sum(1)
            for tj in range(si, nqt):
                tl = slice(tj * TILE, (tj + 1) * TILE)
                yt = dyc[:, tl, hs].permute(0, 2, 1, 3)
                mask = (pos[sl, None] <= pos[None, tl]) & (pos[None, tl] < Q)
                ex = torch.exp(torch.where(
                    mask, a_h[:, :, None, tl] - a_h[:, :, sl, None], 0.0))
                pT = mm(xs, yt.transpose(-1, -2), False, False) \
                    * d_h[:, :, sl, None]
                dcbT = torch.where(mask, pT * ex, 0.0)      # (BC, hb, s, t)
                R = dcbT * cb[:, g, None, sl, tl]
                col[:, hs, sl] += R.sum(-1)
                rowv[si][:, hs, tl] = R.sum(-2)
                dsum[si, tj] = dcbT.sum(1)                  # (BC, s, t)
                dB_s = dB_s + mm(dsum[si, tj], Cc[:, tl, g], True, False)
            dBp[:, sl, j] = dB_s
            # 4. head side, each head on its own: d xdt_s, q, xg, dy . x
            gx = mm(Bc[:, None, sl, g], dSh, False, True) \
                * wl[:, :, sl, None]
            qv[:, hs, sl] = (gx * xs).sum(-1) * d_h[:, :, sl]
            for tj in range(si, nqt):
                tl = slice(tj * TILE, (tj + 1) * TILE)
                yt = dyc[:, tl, hs].permute(0, 2, 1, 3)
                mask = (pos[sl, None] <= pos[None, tl]) & (pos[None, tl] < Q)
                MT = torch.where(mask, cb[:, g, None, sl, tl] * torch.exp(
                    torch.where(mask, a_h[:, :, None, tl]
                                - a_h[:, :, sl, None], 0.0)), 0.0)
                gx = gx + mm(MT, yt, True, False)
            gxs[:, sl, hs] = gx.permute(0, 2, 1, 3)
            xg[:, hs, sl] = (gx * xs).sum(-1)
            dyx[si][:, hs] = (dyc[:, sl, hs].permute(0, 2, 1, 3)
                              * xs).sum((-1, -2))
        # 5. query side
        for tj in range(nqt):
            tl = slice(tj * TILE, (tj + 1) * TILE)
            yt = dyc[:, tl, hs].permute(0, 2, 1, 3)
            tmp = mm(yt, hin_nd[:, hs].transpose(-1, -2), False, True) \
                * torch.exp(a_h[:, :, tl])[..., None] * real[tl, None]
            yo[:, hs, tl] = (tmp * Cc[:, None, tl, g]).sum(-1)
            dC_t = tmp.sum(1)
            for si in range(tj + 1):
                sl = slice(si * TILE, (si + 1) * TILE)
                dC_t = dC_t + mm(dsum[si, tj].transpose(-1, -2),
                                 Bc[:, sl, g], True, False)
            dCp[:, tl, j] = dC_t

    # 6. scan: d a_cum, da, ddt and the chunk parts of dA, dD
    dac = (rowv.sum(0) - col + yo - qv) * real
    dac[:, :, Q - 1] += qv.sum(-1) + decay.reshape(BC, nh)
    da = torch.flip(torch.cumsum(torch.flip(dac, [2]), 2), [2]) * real
    ddt = (da * A[:, None] + xg)[:, :, :Q]                 # (BC, nh, Q)
    pA = (da * dth).sum(-1)
    pD = dyx.sum(0)

    # 7. fixed-order sums
    def group_sum(p):
        p = p[:, :Q].reshape(b, S, G, nhb // G, N)
        return p.sum(3)
    dx = gxs[:, :Q] * dtc[:, :Q, :, None] + D[:, None] * dyc[:, :Q]
    return (dx.reshape(b, S, nh, hd).to(x.dtype),
            ddt.permute(0, 2, 1).reshape(b, S, nh),
            pA.sum(0), group_sum(dBp).to(B.dtype), group_sum(dCp).to(C.dtype),
            pD.sum(0), dh0 if h0 is not None else None)
