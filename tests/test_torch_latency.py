"""The port's copies of `core/hw.py` and `core/latency_model.py`: the
copied `derive_slos` (`core/workload.py`), which imports
`.latency_model`, runs and gives the JAX package's SLOs field by field."""
import dataclasses

import pytest

from repro.configs import get_config as jx_get_config
from repro.core import workload as jx_workload
from repro.core.latency_model import LatencyModel as JLatencyModel
from repro_torch.configs import get_config
from repro_torch.core import workload as tx_workload
from repro_torch.core.latency_model import LatencyModel


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-1b", "mamba2-2.7b"])
@pytest.mark.parametrize("spec", ["sharegpt", "humaneval", "longbench"])
def test_derive_slos_matches_jax(spec, arch):
    got = tx_workload.derive_slos(tx_workload.WORKLOADS[spec],
                                  LatencyModel(get_config(arch)))
    want = jx_workload.derive_slos(jx_workload.WORKLOADS[spec],
                                   JLatencyModel(jx_get_config(arch)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.slo_ttft > 0 and got.slo_tpot > 0
