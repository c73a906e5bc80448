"""Mamba2 / SSD (state-space duality) blocks (port of `repro/models/ssd.py`)
[arXiv:2405.21060].

`ssd_chunked` is the block decomposition (a masked within-chunk term plus
a low-rank recurrence across chunks), written out in einsums: it is the
plain version of the `ssd_scan` kernel. `mamba_apply` runs the prefill's
scan through `ssd_scan_op` (by way of `sharded.ssd_scan`, which splits a
DTensor scan into its shards), i.e. the hand-written kernel on a CUDA tensor
(and, where autograd needs the gradient, its backward kernel), where the
JAX model runs the jnp `ssd_chunked`. `ssd_step` is the O(1)
decode recurrence, plain PyTorch as in JAX: the "KV cache" of an SSM is
the constant-size state.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import sharded
from .common import Box, TensorSpec, param, rmsnorm


def _segsum(a):
    """Lower-triangular pairwise cumulative sums.

    a: (..., Q) -> (..., Q, Q) where out[..., t, s] = sum_{s < r <= t} a[r]
    (0 on the diagonal, -inf above)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, B, C, D, chunk: int,
                h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.

    x: (b, S, nh, hd); dt: (b, S, nh); A: (nh,) negative; B, C: (b, S, G,
    N); D: (nh,). Returns (y (b, S, nh, hd), h_final (b, nh, hd, N) f32)."""
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = nh // G
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk

    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, nh, hd).to(f32)
    dtc = dt.reshape(b, nc, chunk, nh).to(f32)
    Bc = B.reshape(b, nc, chunk, G, N).to(f32)
    Cc = C.reshape(b, nc, chunk, G, N).to(f32)

    a = dtc * A.to(f32)                                         # (b,nc,Q,nh)
    a_cum = torch.cumsum(a, dim=2)                              # within-chunk
    xdt = xc * dtc[..., None]                                   # x * dt

    # --- 1. diagonal (within-chunk) term -------------------------------
    L = torch.exp(_segsum(torch.movedim(a, -1, 2)))             # (b,nc,nh,Q,Q)
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)             # (b,nc,G,Q,Q)
    CB = torch.repeat_interleave(CB, rep, dim=2)                # (b,nc,nh,Q,Q)
    M = CB * L
    y_diag = torch.einsum("bchqs,bcshd->bcqhd", M, xdt)

    # --- 2. per-chunk end states ---------------------------------------
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)       # (b,nc,Q,nh)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)                # (b,nc,Q,nh,N)
    S_c = torch.einsum("bcqhn,bcqh,bcqhd->bchdn",
                       Bh, decay_to_end, xdt)                   # (b,nc,nh,hd,N)

    # --- 3. inter-chunk recurrence (loop over chunks) -------------------
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                 # (b,nc,nh)
    h = (torch.zeros(b, nh, hd, N, dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                       # (b,nc,nh,hd,N)

    # --- 4. off-diagonal contribution from carried-in state -------------
    state_decay = torch.exp(a_cum)                              # (b,nc,Q,nh)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)                # (b,nc,Q,nh,N)
    y_off = torch.einsum("bcqhn,bcqh,bchdn->bcqhd",
                         Ch, state_decay, h_prevs)

    y = (y_diag + y_off).reshape(b, S, nh, hd)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), h


def ssd_step(h, x_t, dt_t, A, B_t, C_t, D):
    """Single decode step. h: (b, nh, hd, N) f32; x_t: (b, nh, hd); dt_t:
    (b, nh); B_t, C_t: (b, G, N). Returns (h', y (b, nh, hd))."""
    b, nh, hd = x_t.shape
    G = B_t.shape[1]
    rep = nh // G
    f32 = torch.float32
    dec = torch.exp(dt_t.to(f32) * A.to(f32))                   # (b,nh)
    Bh = torch.repeat_interleave(B_t.to(f32), rep, dim=1)       # (b,nh,N)
    Ch = torch.repeat_interleave(C_t.to(f32), rep, dim=1)
    xdt = x_t.to(f32) * dt_t.to(f32)[..., None]                 # (b,nh,hd)
    h = h * dec[..., None, None] + xdt[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhdn,bhn->bhd", h, Ch) \
        + x_t.to(f32) * D.to(f32)[None, :, None]
    return h, y.to(x_t.dtype)


def ssd_reference(x, dt, A, B, C, D, h0=None):
    """Naive sequential recurrence oracle (tests only)."""
    b, S, nh, hd = x.shape
    h = torch.zeros(b, nh, hd, B.shape[-1], dtype=torch.float32,
                    device=x.device) if h0 is None else h0
    ys = []
    for t in range(S):
        h, y = ssd_step(h, x[:, t], dt[:, t], A, B[:, t], C[:, t], D)
        ys.append(y)
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Full Mamba2 block (in_proj -> causal conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def mamba_params(gen, cfg, *, device, stack: int = 0) -> Dict:
    """Random f32 params at the JAX init scales; `A_log` is deterministic
    and `dt_bias` is the inverse softplus of a log-uniform draw in
    [0.001, 0.1], as in JAX."""
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    nh = d_in // s.head_dim
    gn = s.ngroups * s.state_dim
    lead = (stack,) if stack else ()
    h_axes = (("layers",) if stack else ()) + ("heads",)
    if torch.device(device).type == "meta":
        dt_init = torch.empty(lead + (nh,), device=device)
        a_log = torch.empty(lead + (nh,), device=device)
    else:
        u = torch.rand(lead + (nh,), generator=gen, device=device,
                       dtype=torch.float32)
        dt_init = torch.log(torch.expm1(torch.exp(
            u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))))
        a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                       device=device) % 15 + 1.0)
        a_log = a_log.expand(lead + (nh,)).clone()
    cw = 1.0 / s.conv_width ** 0.5
    kw = dict(device=device, stack=stack)
    return {
        "wz": param(gen, (d, d_in), ("embed", "ssm_inner"), **kw),
        "wx": param(gen, (d, d_in), ("embed", "ssm_inner"), **kw),
        "wB": param(gen, (d, gn), ("embed", "state"), **kw),
        "wC": param(gen, (d, gn), ("embed", "state"), **kw),
        "wdt": param(gen, (d, nh), ("embed", "heads"), **kw),
        "conv_x": param(gen, (s.conv_width, d_in), (None, "ssm_inner"),
                        scale=cw, **kw),
        "conv_xb": param(gen, (d_in,), ("ssm_inner",), init="zeros", **kw),
        "conv_B": param(gen, (s.conv_width, gn), (None, "state"), scale=cw,
                        **kw),
        "conv_Bb": param(gen, (gn,), ("state",), init="zeros", **kw),
        "conv_C": param(gen, (s.conv_width, gn), (None, "state"), scale=cw,
                        **kw),
        "conv_Cb": param(gen, (gn,), ("state",), init="zeros", **kw),
        "A_log": Box(a_log, h_axes),
        "D": param(gen, (nh,), ("heads",), init="ones", **kw),
        "dt_bias": Box(dt_init, h_axes),
        "norm_w": param(gen, (d_in,), ("ssm_inner",), init="zeros", **kw),
        "out_proj": param(gen, (d_in, d), ("ssm_inner", "embed"), **kw),
    }


def _causal_conv(x, w, b, state0, S):
    """Depthwise causal conv in the JAX shifted-sum form (no cuDNN, so no
    TF32). x: (B, S, C); w: (W, C); state0: (B, W-1, C)."""
    xp = torch.cat([state0, x], dim=1)
    W = w.shape[0]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return F.silu(y + b), xp[:, S:]


def mamba_apply(p, x, cfg, h0=None, conv0=None, *, plain: bool = False):
    """Full-sequence (prefill). x: (B, S, d).

    Returns (y (B, S, d), (ssm_state, conv_state_dict)). The scan runs
    through `ssd_scan_op`: the kernel for a CUDA tensor unless `plain`."""
    Bsz, S, d = x.shape
    s = cfg.ssm
    d_in = s.expand * d
    nh = d_in // s.head_dim
    gn = s.ngroups * s.state_dim
    z = x @ p["wz"]
    xs = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = x @ p["wdt"]
    if conv0 is None:
        def zz(c):
            return torch.zeros(Bsz, s.conv_width - 1, c, dtype=x.dtype,
                               device=x.device)
        conv0 = {"x": zz(d_in), "B": zz(gn), "C": zz(gn)}
    xs, st_x = _causal_conv(xs, p["conv_x"], p["conv_xb"], conv0["x"], S)
    Bm, st_B = _causal_conv(Bm, p["conv_B"], p["conv_Bb"], conv0["B"], S)
    Cm, st_C = _causal_conv(Cm, p["conv_C"], p["conv_Cb"], conv0["C"], S)
    conv_state = {"x": st_x, "B": st_B, "C": st_C}

    xh = xs.reshape(Bsz, S, nh, s.head_dim)
    Bh = Bm.reshape(Bsz, S, s.ngroups, s.state_dim)
    Ch = Cm.reshape(Bsz, S, s.ngroups, s.state_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    chunk = min(s.chunk_size, S)
    pad = (-S) % chunk
    if pad:
        # padded steps are identities: dt=0 -> no decay, no input
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, h = sharded.ssd_scan(xh, dt, A, Bh, Ch, p["D"], chunk=chunk, h0=h0,
                            plain=plain)
    y = y[:, :S].reshape(Bsz, S, d_in)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps) * F.silu(z)
    return y @ p["out_proj"], (h, conv_state)


def mamba_step(p, x_t, cfg, state):
    """Decode step. x_t: (B, d); state = (ssm_state, conv_state_dict)."""
    h, conv_state = state
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim

    def conv1(v, w, b, st):
        win = torch.cat([st, v[:, None]], dim=1)
        y = torch.einsum("bwc,wc->bc", win, w)
        return F.silu(y + b), win[:, 1:]

    z = x_t @ p["wz"]
    xs, st_x = conv1(x_t @ p["wx"], p["conv_x"], p["conv_xb"],
                     conv_state["x"])
    Bm, st_B = conv1(x_t @ p["wB"], p["conv_B"], p["conv_Bb"],
                     conv_state["B"])
    Cm, st_C = conv1(x_t @ p["wC"], p["conv_C"], p["conv_Cb"],
                     conv_state["C"])
    dt = F.softplus((x_t @ p["wdt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(-1, nh, s.head_dim)
    Bh = Bm.reshape(-1, s.ngroups, s.state_dim)
    Ch = Cm.reshape(-1, s.ngroups, s.state_dim)
    h, y = ssd_step(h, xh, dt, A, Bh, Ch, p["D"])
    y = y.reshape(-1, d_in)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps) * F.silu(z)
    return y @ p["out_proj"], (h, {"x": st_x, "B": st_B, "C": st_C})


def mamba_state_specs(cfg, batch: int, dtype=torch.bfloat16):
    """(ssm (batch, nh, hd, N) f32, conv {"x","B","C": (batch, W-1, c)})
    as `TensorSpec`s."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    gn = s.ngroups * s.state_dim
    W = s.conv_width - 1
    conv = {"x": TensorSpec((batch, W, d_in), dtype),
            "B": TensorSpec((batch, W, gn), dtype),
            "C": TensorSpec((batch, W, gn), dtype)}
    return (TensorSpec((batch, nh, s.head_dim, s.state_dim), torch.float32),
            conv)
