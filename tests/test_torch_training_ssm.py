"""Training of the SSM families on the CPU against the JAX package:
mamba2-2.7b-smoke and zamba2-7b-smoke (the hybrid), whose every mamba
layer differentiates `ssd_scan_op` (`SsdScan`; on the CPU its backward is
`ssd_scan_bwd_ref`). The checks and their tolerances are in
`tests/train_parity.py`."""
import pytest

from train_parity import check_loss_and_grads, check_three_adamw_steps

ARCHS = ["mamba2-2.7b-smoke", "zamba2-7b-smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_params_after_three_adamw_steps_match_jax(arch):
    check_three_adamw_steps(arch)
