"""The launcher's placement searches on the H100 `Chip` against the JAX
package's: Alg. 2 (low node-affinity) and Alg. 1 (high node-affinity) at
one node of two cards give the same plan (`summary()` apart from the
search's own seconds). Kept apart from `tests/test_torch_plan.py`: each
search runs for seconds in each package."""
import dataclasses

import pytest

from repro.configs import get_config as jx_get_config
from repro.core import hw as jhw
from repro.core.latency_model import LatencyModel as JLM
from repro.core.placement import algo1_high_affinity as jx_algo1
from repro.core.placement import algo2_low_affinity as jx_algo2
from repro.core.workload import WORKLOADS as JWORKLOADS
from repro.core.workload import derive_slos as jx_derive_slos
from repro_torch.configs import get_config
from repro_torch.core.h100 import H100
from repro_torch.launch.serve import plan

JH100 = jhw.Chip(**dataclasses.asdict(H100))


@pytest.mark.parametrize("algo", ["low", "high"])
def test_search_matches_jax(algo):
    kw = dict(rate=8.0, n_node=1, m_per_node=2, n_requests=200)
    lm, spec, got = plan(get_config("yi-6b"), "sharegpt", algo=algo,
                         chip=H100, **kw)
    jlm = JLM(jx_get_config("yi-6b"), JH100)
    jspec = jx_derive_slos(JWORKLOADS["sharegpt"], jlm)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    search = jx_algo2 if algo == "low" else jx_algo1
    want = search(jlm, jspec, chip=JH100, **kw)
    drop = lambda p: {k: v for k, v in p.summary().items()  # noqa: E731
                      if k != "search_s"}
    assert drop(got) == drop(want)
    assert got.n_prefill >= 1 and got.n_decode >= 1
    assert lm.chip is H100
