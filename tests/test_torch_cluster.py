"""The port's live disaggregated runtime on the CPU: the five behaviours of
`tests/test_disagg_e2e.py`, token equality with the JAX `DisaggCluster` on
the same trace, and disaggregated == colocated inside the port."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jx_get_config
from repro.core.workload import Request as JRequest
from repro.models.api import build_model as jx_build
from repro.serving.cluster import DisaggCluster as JDisagg
from repro_torch.configs import get_config
from repro_torch.core.workload import Request
from repro_torch.serving.cluster import ColocatedCluster, DisaggCluster
from repro_torch.weights import from_jax

CFG = get_config("yi-6b-smoke")
JCFG = jx_get_config("yi-6b-smoke")


@pytest.fixture(scope="module")
def jparams():
    return jx_build(JCFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return from_jax(jax.tree.map(np.asarray, jparams))


def _reqs(n=6, cls=Request):
    return [cls(i, i * 0.01, 10 + (i % 4) * 3, 5) for i in range(n)]


def _disagg(params, **kw):
    base = dict(n_prefill=1, n_decode=1, max_batch=4, max_len=64,
                lm_tokens=48, device="cpu")
    base.update(kw)
    return DisaggCluster(CFG, params, **base)


def test_disagg_serves_all(params):
    dc = _disagg(params, n_prefill=2)
    res = dc.run(_reqs())
    assert len(res) == 6
    for r in res.values():
        assert r.ttft > 0 and r.finish > 0
        assert len(r.tokens) >= 10 + 5  # prompt + generated


def test_disagg_tokens_match_colocated(params):
    """KV migration must be exact: greedy decode agrees bit for bit with
    a colocated engine that never migrates."""
    r1 = _disagg(params).run(_reqs())
    cc = ColocatedCluster(CFG, params, n_engines=1, max_batch=4, max_len=64,
                          device="cpu")
    r2 = cc.run(_reqs())
    for rid in r1:
        assert r1[rid].tokens == r2[rid].tokens, rid


def test_decode_failover_recovers_all(params):
    dc = _disagg(params, n_decode=2)
    res = dc.run(_reqs(8), fail_decode_at=(0.05, 1))
    assert len(res) == 8
    assert all(r.finish >= 0 for r in res.values())


def test_transfer_manager_accounting(params):
    dc = _disagg(params)
    dc.run(_reqs(4))
    assert dc.tx.total_bytes > 0
    assert len(dc.tx.times) == 4  # one pull per request reaching decode
    assert not dc.tx.parked  # nothing left behind


def test_slot_reuse_beyond_capacity(params):
    """More concurrent requests than decode slots: pull-based admission
    queues and still finishes everything."""
    dc = _disagg(params, max_batch=2)
    res = dc.run(_reqs(7))
    assert len(res) == 7
    assert all(r.finish >= 0 for r in res.values())


def _shared_prefix_trace(cls):
    """Six requests, four sharing a 24-token head (a page-and-a-half at
    page 16), prompts of 18..41 tokens."""
    rng = np.random.default_rng(5)
    head = rng.integers(1, CFG.vocab_size, 24).tolist()
    out = []
    for i, n in enumerate([17, 9, 30, 5, 18, 26]):
        body = rng.integers(1, CFG.vocab_size, n).tolist()
        toks = head + body if i % 3 else body
        out.append(cls(i, 0.1 * i, len(toks), 4 + i % 3,
                       tokens=tuple(toks)))
    return out


@pytest.mark.parametrize("mode", ["plain", "prefix_chunked"])
def test_tokens_match_jax_disagg_cluster(params, jparams, mode):
    """Same trace, same weights: the port's DisaggCluster and the JAX
    DisaggCluster give the same greedy tokens. `prefix_chunked` adds the
    prefix cache and 16-token chunked prefill (every chunk after the
    first, and every prefix hit, runs prefix_prefill)."""
    kw = dict(n_prefill=1, n_decode=1, max_batch=4, max_len=96,
              lm_tokens=48)
    if mode == "prefix_chunked":
        kw.update(prefix_cache=True, chunk_tokens=16)
    dc = DisaggCluster(CFG, params, device="cpu", **kw)
    got = dc.run(_shared_prefix_trace(Request))
    want = JDisagg(JCFG, jparams, **kw).run(_shared_prefix_trace(JRequest))
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    # which request hits the prefix cache depends on measured step times
    # (the schedule); every chunk after a prompt's first one attends over
    # pool pages whatever the schedule
    if mode == "prefix_chunked":
        assert dc.prefill[0].fused_dispatches > 0
