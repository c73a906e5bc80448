"""The bf16 arithmetic of the port's `ssd_scan_bwd` kernel, emulated on the
CPU and held against JAX.

On the card the bf16 kernel runs every product on the tensor cores: dy, x,
B and C are bf16 and enter exactly; an f32 operand on the contracted index
(dS, h_in, M^T, the head block's summed dCB, exp(a_cum) dy) enters as the
bf16 pair hi + lo in two products; every product accumulates in f32; dx,
dB and dC are rounded to bf16 once. `ssd_scan_bwd_split_ref` with
`mm=mm_bf16_split` forms each product that way, so this test shows on the
CPU that the precision rule meets the bound the card is held to
(`SSD_BWD_BOUNDS["bfloat16"]` of `chip_smoke.py`: 2e-2 of each gradient's
largest |value|), against jax.vjp of `ssd_chunked` in f32 on the same
bf16-rounded inputs. A single bf16 rounding of the f32 operands instead of
the pair is shown to lose more than the pair does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssd import ssd_chunked as jx_ssd_chunked
from repro_torch.kernels.ssd_scan.ref import (mm_bf16_split, mm_f32,
                                              ssd_scan_bwd_split_ref)

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
BF16_BOUND = 2e-2          # chip_smoke.py SSD_BWD_BOUNDS["bfloat16"]
b_, nh_, hd_, N_, G_ = 2, 8, 32, 32, 2


def _inputs(seed, S):
    """x, dt, A, B, C, D, h0, dy, dh_final (f32 numpy), with x, B, C and dy
    rounded to bf16."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    x, B, C = bf(n(b_, S, nh_, hd_)), bf(n(b_, S, G_, N_)), \
        bf(n(b_, S, G_, N_))
    dt = (np.log1p(np.exp(n(b_, S, nh_))) * 0.1).astype(np.float32)
    A, D = -np.exp(n(nh_)), n(nh_)
    return x, dt, A, B, C, D, n(b_, nh_, hd_, N_), bf(n(b_, S, nh_, hd_)), \
        n(b_, nh_, hd_, N_)


def _jax_f32(arrs, chunk):
    x, dt, A, B, C, D, h0, dy, dh = [jnp.asarray(a) for a in arrs]

    def fwd(x, dt, A, B, C, D, h0):
        return jx_ssd_chunked(x, dt, A, B, C, D, chunk, h0=h0)
    _, vjp = jax.vjp(fwd, x, dt, A, B, C, D, h0)
    return [np.asarray(g, np.float32) for g in vjp((dy, dh))]


def _emulated(arrs, chunk, mm):
    """The kernel's decomposition with the products of `mm`; dx, dB and dC
    rounded to bf16 as the kernel stores them."""
    t = [torch.from_numpy(a) for a in arrs]
    x, dt, A, B, C, D, h0, dy, dh = t
    g = list(ssd_scan_bwd_split_ref(x, dt, A, B, C, D, dy, dh, chunk=chunk,
                                    h0=h0, mm=mm))
    for i in (0, 3, 4):
        g[i] = g[i].to(torch.bfloat16).float()
    return [a.numpy() for a in g]


def _errors(got, want):
    return {n: float(np.abs(g - w).max()) / float(np.abs(w).max())
            for n, g, w in zip(GRADS, got, want)}


@pytest.mark.parametrize("chunk", [64, 100])
def test_bf16_split_products_meet_the_card_bound(chunk):
    """nh 8, hd 32, N 32, G 2, 3 chunks (of one 64-row tile, and of a 64-
    and a ragged 36-row tile), h0 and dh_final given: every gradient
    within 2e-2 of scale; ddt, dA, dD and dh0, which no bf16 store rounds,
    within 1e-4."""
    arrs = _inputs(chunk, 3 * chunk)
    err = _errors(_emulated(arrs, chunk, mm_bf16_split),
                  _jax_f32(arrs, chunk))
    assert all(e <= BF16_BOUND for e in err.values()), err
    assert all(err[n] <= 1e-4 for n in ("ddt", "dA", "dD", "dh0")), err


def test_the_lo_part_is_what_keeps_the_f32_operands():
    """Without the lo products (each f32 operand rounded to bf16 once) the
    unrounded gradients lose about a thousand times more than with them:
    the split is what keeps ddt, dA and dh0 at f32's tolerance."""
    chunk = 64
    arrs = _inputs(7, 3 * chunk)
    want = _jax_f32(arrs, chunk)

    def mm_hi_only(a, b, split_a=False, split_b=False):
        return mm_bf16_split(a, b)
    split = _errors(_emulated(arrs, chunk, mm_bf16_split), want)
    hi = _errors(_emulated(arrs, chunk, mm_hi_only), want)
    f32 = _errors(_emulated(arrs, chunk, mm_f32), want)
    for n in ("ddt", "dA", "dh0"):
        assert split[n] < 1e-4 < hi[n], (n, split[n], hi[n])
        assert f32[n] <= split[n] * 1.01 + 1e-6, (n, f32[n], split[n])
