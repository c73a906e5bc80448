"""Training of the encoder-decoder and the VLM on the CPU against the JAX
package: seamless-m4t-large-v2-smoke with `src_embeds` and
internvl2-76b-smoke with `frontend_embeds`, each batch built in numpy.
The checks and their tolerances are in `tests/train_parity.py`."""
import pytest

from train_parity import check_loss_and_grads, check_three_adamw_steps

ARCHS = ["seamless-m4t-large-v2-smoke", "internvl2-76b-smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_after_three_adamw_steps_match_jax(arch):
    check_three_adamw_steps(arch)
