"""The port's SSM family on the CPU (mamba2-2.7b-smoke), against the JAX
package with the JAX params carried over through
`repro_torch.weights.from_jax`: the model's logits and cache, the slab
`Engine`'s greedy tokens, and the disaggregated cluster's tokens and
migrated bytes; plus disaggregated == colocated inside the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.core.workload import Request as JRequest
from repro.models import mamba_lm as jx_lm
from repro.models.api import build_model as jx_build
from repro.serving import engine as jx_engine
from repro.serving.cluster import DisaggCluster as JDisagg
from repro_torch.configs import get_config
from repro_torch.core.workload import Request
from repro_torch.models import mamba_lm as tx_lm
from repro_torch.models.api import build_model
from repro_torch.serving import engine as tx_engine
from repro_torch.serving.cluster import ColocatedCluster, DisaggCluster
from repro_torch.weights import from_jax

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
CFG = get_config("mamba2-2.7b-smoke")
JCFG = jx_get_config("mamba2-2.7b-smoke")


@pytest.fixture(scope="module")
def params():
    jp = jx_build(JCFG).init(jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_init_matches_jax_layout(params):
    """Same tree, shapes and dtype as the JAX init; the random leaves at
    the same spread (a different generator), the deterministic ones
    equal."""
    jp, _ = params
    tp = build_model(CFG).init(torch.Generator().manual_seed(0), "cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name, j in jl.items():
        t = tl[name]
        assert tuple(t.shape) == tuple(j.shape), name
        assert t.dtype == torch.float32
        if name.endswith(("A_log", "dt_bias")):
            continue
        js, ts = float(np.std(np.asarray(j))), float(t.std())
        if js == 0:
            assert ts == 0, name                  # zero/one-init leaves
        else:
            assert abs(ts / js - 1) < 0.2, (name, js, ts)
    np.testing.assert_allclose(tl["layers.m.A_log"].numpy(),
                               np.asarray(jl["layers.m.A_log"]), rtol=1e-6)


def test_forward_logits_and_cache_match_jax(params):
    """Every position's logits; then the prefill path (last-position
    logits and the SSM/conv state cache). S = 21 is not a chunk
    multiple."""
    jp, tp = params
    toks = np.random.default_rng(0).integers(1, CFG.vocab_size, (2, 21))
    jl, _, _ = jx_lm.forward(jp, jnp.asarray(toks), JCFG)
    tl, _, _ = tx_lm.forward(tp, torch.from_numpy(toks), CFG)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    jl, jc, _ = jx_lm.forward(jp, jnp.asarray(toks), JCFG,
                              return_cache=True)
    tl, tc, _ = tx_lm.forward(tp, torch.from_numpy(toks), CFG,
                              return_cache=True)
    assert tuple(tl.shape) == (2, 1, CFG.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    np.testing.assert_allclose(_np(tc["ssm"]), _np(jc["ssm"]), **F32)
    for k in ("x", "B", "C"):
        np.testing.assert_allclose(_np(tc["conv"][k]), _np(jc["conv"][k]),
                                   **F32)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [21, 21]


def test_prefill_then_decode_logits_match_jax(params):
    """prefill -> four decode steps, state carried in the cache."""
    jp, tp = params
    rng = np.random.default_rng(1)
    toks = rng.integers(1, CFG.vocab_size, (3, 9))
    jl, jc = jx_lm.prefill(jp, jnp.asarray(toks), JCFG)
    tl, tc = tx_lm.prefill(tp, torch.from_numpy(toks), CFG)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    for _ in range(4):
        nxt = rng.integers(1, CFG.vocab_size, 3).astype(np.int32)
        jl, jc = jx_lm.decode_step(jp, jc, jnp.asarray(nxt), JCFG)
        tl, tc = tx_lm.decode_step(tp, tc, torch.from_numpy(nxt), CFG)
        np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    np.testing.assert_allclose(_np(tc["ssm"]), _np(jc["ssm"]), **F32)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [13] * 3


def test_cache_specs_match_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        t = build_model(CFG).cache_specs(3, 64, dtype)
        j = jx_build(JCFG).cache_specs(3, 64, jdtype)
        pairs = [(t["ssm"], j["ssm"]), (t["pos"], j["pos"])] + \
            [(t["conv"][k], j["conv"][k]) for k in ("x", "B", "C")]
        for ts, js in pairs:
            assert tuple(ts.shape) == js.shape
            assert str(ts.dtype).split(".")[-1] == js.dtype.name
    assert build_model(CFG).cache_specs(3, 64)["ssm"].dtype == torch.float32


def _serve(mod, eng, prompts, out_len=5):
    """Prefill each prompt, insert its blob into a slot, decode all to
    completion, releasing finished slots (so later ones reuse them)."""
    seqs, nbytes = [], []
    for i, p in enumerate(prompts):
        s = mod.Sequence(i, list(p), out_len + i % 3)
        first, blob, _ = eng.prefill_request(s)
        nbytes.append(eng.kv_blob_bytes(blob))
        s.tokens.append(first)
        s.produced += 1
        eng.insert_kv(s, eng.materialize_wire(blob))
        seqs.append(s)
        if i == 1:          # a decode step between admissions
            eng.decode_step([q for q in seqs if not q.done])
    while any(not s.done for s in seqs):
        eng.decode_step([s for s in seqs if not s.done])
        for s in seqs:
            if s.done and s.slot >= 0:
                eng.release(s)
    return [s.tokens for s in seqs], nbytes


def test_slab_engine_tokens_match_jax(params):
    """Exact-length prefill (prompts of 1..33 tokens; 21 and 33 are not
    chunk multiples), slot writes, decode over a ragged batch."""
    jp, tp = params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist()
               for n in (21, 1, 33, 16)]
    kw = dict(max_batch=4, max_len=64)
    jeng = jx_engine.Engine(JCFG, jp, **kw)
    teng = tx_engine.Engine(CFG, tp, device="cpu", **kw)
    assert not teng.paged and teng.exact_len
    want = _serve(jx_engine, jeng, prompts)
    got = _serve(tx_engine, teng, prompts)
    assert got == want
    ts, js = teng.stats(), jeng.stats()
    ts.pop("clock_s"), js.pop("clock_s")          # measured, not counted
    assert ts == js
    assert teng.free_pages == teng.free_slots == 4


def _reqs(cls, n=6):
    return [cls(i, i * 0.01, 10 + (i % 4) * 7, 6) for i in range(n)]


def test_disagg_cluster_tokens_and_bytes_match_jax(params):
    """The 6-request trace: the same greedy tokens as the JAX cluster, and
    the same migrated bytes, 6 x 32,768 B of SSM state (4 layers x 8 heads
    x 16 x 16 f32), whatever the prompt length."""
    jp, tp = params
    kw = dict(n_prefill=1, n_decode=1, max_batch=4, max_len=64)
    dc = DisaggCluster(CFG, tp, device="cpu", **kw)
    got = dc.run(_reqs(Request))
    jdc = JDisagg(JCFG, jp, **kw)
    want = jdc.run(_reqs(JRequest))
    assert sorted(got) == sorted(want) == list(range(6))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    assert dc.tx.total_bytes == jdc.tx.total_bytes == 6 * 32768


def test_disagg_tokens_match_colocated(params):
    """Migrating the state is exact: the same tokens as a colocated engine
    that never migrates."""
    _, tp = params
    r1 = DisaggCluster(CFG, tp, n_prefill=1, n_decode=1, max_batch=4,
                       max_len=64, device="cpu").run(_reqs(Request))
    r2 = ColocatedCluster(CFG, tp, n_engines=1, max_batch=4, max_len=64,
                          device="cpu").run(_reqs(Request))
    for rid in r1:
        assert r1[rid].tokens == r2[rid].tokens, rid
