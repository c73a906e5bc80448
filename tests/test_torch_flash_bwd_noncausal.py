"""The gradient of the port's flash prefill on the CPU: the non-causal
half of the grid (`tests/flash_bwd_grid.py`, which states the
tolerance), the encoder's self-attention and the decoder's
cross-attention."""
import pytest

from flash_bwd_grid import (MASKS, SUBS, check_against_dense_autograd,
                            check_against_jax, mask_id)

NON_CAUSAL = [m for m in MASKS if not m[0]]


@pytest.mark.parametrize("group,hd", SUBS)
@pytest.mark.parametrize("mask", NON_CAUSAL, ids=mask_id)
def test_bwd_ref_matches_jax_vjp_of_flash_reference(mask, group, hd):
    check_against_jax(mask, group, hd)


@pytest.mark.parametrize("group,hd", SUBS)
@pytest.mark.parametrize("mask", NON_CAUSAL, ids=mask_id)
def test_bwd_ref_matches_autograd_of_dense_attention(mask, group, hd):
    check_against_dense_autograd(mask, group, hd)
