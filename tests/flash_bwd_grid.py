"""The grid of the flash prefill gradient's CPU tests, shared by
`tests/test_torch_flash_bwd.py` (causal masks) and
`tests/test_torch_flash_bwd_noncausal.py` (non-causal masks); the two
halves run in two test processes.

`flash_prefill_bwd_ref` is the plain version of the backward kernel
(`csrc/flash_prefill_bwd.cu`, which runs only on the card and is held to
this formula by `tests/test_torch_cuda.py` and `chip_smoke.py`). The JAX
package has no backward kernel: its train step differentiates
`flash_reference`. So the formula is held here against `jax.vjp` of the
JAX `flash_reference` on the same numpy inputs, over the grid of masks
(causal or not, window 0 or 8, soft cap 0 or 30, Sq = Skv or Sq < Skv),
query-head groups (1, 2, 4) and head dims (16, 64, 112), and against
autograd of the port's own `dense_attention` on the same grid.

Tolerance (f32): `tests/test_kernels.py:16-17`'s atol = rtol = 5e-5.
The two frameworks run the same f32 formula in other summation orders;
on this grid they differ by at most ~1e-6 of a gradient's largest
|value|.

Cost: XLA compiles a vjp per grid point (~0.5 s each), so the JAX side
of one mask's nine (group, head dim) points is lowered and compiled
once, at XLA's lowest optimisation level (cached per test process).
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.attention import flash_reference
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_bwd_ref,
                                                   flash_prefill_ref)
from repro_torch.models.attention import dense_attention

TOL = dict(atol=5e-5, rtol=5e-5)            # tests/test_kernels.py:16
MASKS = list(itertools.product([True, False], [0, 8], [0.0, 30.0],
                               [False, True]))    # causal, window, cap, Sq<Skv
SUBS = list(itertools.product([1, 2, 4], [16, 64, 112]))   # group, hd
B, HKV, SQ, SKV_CROSS = 1, 2, 20, 28


def mask_id(m):
    causal, window, cap, cross = m
    return (f"{'causal' if causal else 'full'}-w{window}-cap{int(cap)}-"
            f"{'cross' if cross else 'self'}")


def grid_inputs(mask, group, hd):
    """q, k, v, do (model layout, f32 numpy) of one grid point."""
    cross = mask[3]
    skv = SKV_CROSS if cross else SQ
    rng = np.random.default_rng(1000 * group + hd + 7 * MASKS.index(mask))
    shapes = ((B, SQ, HKV * group, hd), (B, skv, HKV, hd),
              (B, skv, HKV, hd), (B, SQ, HKV * group, hd))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@functools.lru_cache(maxsize=None)
def jax_grads(mask):
    """jax.vjp of flash_reference at every (group, hd) of one mask, in one
    compiled program: {(group, hd): (dq, dk, dv)} as numpy."""
    causal, window, cap, _ = mask
    args = [grid_inputs(mask, g, hd) for g, hd in SUBS]

    def grads(args):
        out = []
        for q, k, v, do in args:
            def f(q, k, v):
                return flash_reference(q, k, v, causal=causal, window=window,
                                       logit_softcap=cap,
                                       block_q=q.shape[1],
                                       block_kv=k.shape[1])
            out.append(jax.vjp(f, q, k, v)[1](do))
        return out

    jargs = jax.tree.map(jnp.asarray, args)
    compiled = jax.jit(grads).lower(jargs).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    res = jax.device_get(compiled(jargs))
    return {sub: tuple(np.asarray(g) for g in r)
            for sub, r in zip(SUBS, res)}


def kernel_layout(a):
    return torch.from_numpy(a).transpose(1, 2)


def ref_grads(mask, q, k, v, do):
    """flash_prefill_bwd_ref's (dq, dk, dv), model layout, from the plain
    forward's o and lse."""
    causal, window, cap, _ = mask
    kw = dict(causal=causal, window=window, softcap=cap)
    qt, kt, vt, dot = map(kernel_layout, (q, k, v, do))
    o, lse = flash_prefill_ref(qt, kt, vt, return_lse=True, **kw)
    grads = flash_prefill_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    return [g.transpose(1, 2).numpy() for g in grads]


def check_against_jax(mask, group, hd):
    q, k, v, do = grid_inputs(mask, group, hd)
    want = jax_grads(mask)[(group, hd)]
    for name, got, w in zip(("dq", "dk", "dv"),
                            ref_grads(mask, q, k, v, do), want):
        np.testing.assert_allclose(got, w, err_msg=name, **TOL)


def check_against_dense_autograd(mask, group, hd):
    causal, window, cap, _ = mask
    q, k, v, do = grid_inputs(mask, group, hd)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = dense_attention(*leaves, causal=causal, window=window,
                        logit_softcap=cap)
    want = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for name, got, w in zip(("dq", "dk", "dv"),
                            ref_grads(mask, q, k, v, do), want):
        np.testing.assert_allclose(got, w.numpy(), err_msg=name, **TOL)
