"""The port's remat structure against JAX's, seen in the dry-run's dot
flops: `cost_corrected.dot_flops` of the hybrid (zamba2-7b) and
encoder-decoder (seamless-m4t-large-v2) smoke cells against JAX's
`jaxpr_costs`, integer for integer.

A train step's products count every recomputation. JAX's hybrid forward
checkpoints each group (its mamba blocks, each under its own checkpoint,
then the shared block) and leaves the tail unrematted; its encoder-decoder
forward takes `remat` and ignores it. zamba2 runs at 5 smoke layers: the
smoke config's 4 form two groups of 2 and no tail, and the tail is half
of what a wrong structure would show.
"""
from __future__ import annotations

import pytest

from repro.configs import get_config as jx_get_config
from repro.configs.archs import smoke as jx_smoke
from repro.configs.base import ShapeConfig as JxShape
from repro_torch.configs import get_config
from repro_torch.configs.archs import smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from test_torch_dryrun import BLOCKS, jax_cell_costs

# (arch, smoke layers): the hybrid with a tail after its two groups
REMAT_ARCHS = [("zamba2-7b", 5), ("seamless-m4t-large-v2", 2)]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,layers", REMAT_ARCHS)
def test_dot_flops_equal_jaxpr_costs(arch, layers, kind):
    """The step's dot flops on the fake 16 x 16 mesh equal JAX's global
    count, and so do the argument bytes, 32 x 64 tokens, 16-row attention
    tiles (train: every recomputation of the remat structure)."""
    jcfg = jx_smoke(jx_get_config(arch)).replace(num_layers=layers)
    tcfg = smoke(get_config(arch)).replace(num_layers=layers)
    jc = jax_cell_costs(jcfg, JxShape("x", 64, 32, kind), BLOCKS)
    rec = dryrun.lower_cell(arch, "x", multi_pod=False, attn_blocks=BLOCKS,
                            cfg=tcfg, shape=ShapeConfig("x", 64, 32, kind))
    assert rec["status"] == "ok"
    assert rec["cost_corrected"]["dot_flops"] == int(jc["flops"])
    assert rec["cost_corrected"]["arg_bytes"] == jc["arg_bytes"]
