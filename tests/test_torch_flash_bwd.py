"""The gradient of the port's flash prefill on the CPU: the causal half
of the grid (`tests/flash_bwd_grid.py`, which states the tolerance), and
`torch.autograd.gradcheck` of the CPU `autograd.Function` of
`flash_prefill_op` in f64."""
import numpy as np
import pytest
import torch

from flash_bwd_grid import (MASKS, SUBS, check_against_dense_autograd,
                            check_against_jax, mask_id)
from repro_torch.kernels.flash_prefill.ops import flash_prefill_op

CAUSAL = [m for m in MASKS if m[0]]


@pytest.mark.parametrize("group,hd", SUBS)
@pytest.mark.parametrize("mask", CAUSAL, ids=mask_id)
def test_bwd_ref_matches_jax_vjp_of_flash_reference(mask, group, hd):
    check_against_jax(mask, group, hd)


@pytest.mark.parametrize("group,hd", SUBS)
@pytest.mark.parametrize("mask", CAUSAL, ids=mask_id)
def test_bwd_ref_matches_autograd_of_dense_attention(mask, group, hd):
    check_against_dense_autograd(mask, group, hd)


@pytest.mark.parametrize("mask", [(True, 0, 0.0, False),
                                  (True, 3, 0.0, True),
                                  (False, 0, 5.0, True),
                                  (False, 2, 5.0, False)], ids=mask_id)
def test_flash_prefill_function_gradcheck_f64(mask):
    """The CPU autograd.Function (plain forward, `flash_prefill_bwd_ref`
    backward) against finite differences, in f64 at tiny shapes."""
    causal, window, cap, cross = mask
    rng = np.random.default_rng(3)
    sq, skv, hd = 5, 7 if cross else 5, 4

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)) \
            .requires_grad_(True)
    q, k, v = leaf(1, sq, 4, hd), leaf(1, skv, 2, hd), leaf(1, skv, 2, hd)

    def f(q, k, v):
        out = flash_prefill_op(q, k, v, causal=causal, window=window,
                               softcap=cap)
        assert out.grad_fn is not None
        return out
    assert torch.autograd.gradcheck(f, (q, k, v))


def test_flash_prefill_op_off_the_grad_path_is_unchanged():
    """Without grad the op takes the serving path (no Function): the same
    values as the Function's forward, and no grad_fn."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    plain = flash_prefill_op(q, k, v, window=4)
    assert plain.grad_fn is None
    tracked = flash_prefill_op(q.requires_grad_(True), k, v, window=4)
    assert tracked.grad_fn is not None
    assert torch.equal(plain, tracked.detach())
