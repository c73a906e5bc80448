"""The port's Zamba2 hybrid (`models/hybrid.py`) on the CPU, against the
JAX package with the JAX params carried over (`repro_torch.weights.
from_jax`): forward logits, the prefill cache (SSM and conv state a
group and layer, the shared block's KV slab a group), prefill + decode
logits, `cache_specs`, the slab insert of a hybrid blob (whose batch axis
is 2), the slab engine's and the disaggregated cluster's greedy tokens
and migrated bytes. Arch: zamba2-7b-smoke (2 groups of 2 mamba blocks,
each followed by the shared attention block). Inputs from numpy seeds;
tolerance f32 5e-5 (`tests/test_kernels.py:16`) relative to the tensor's
largest |value|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.core.workload import Request as JRequest
from repro.models import hybrid as jx_hybrid
from repro.models.api import build_model as jx_build
from repro.serving import engine as jx_engine
from repro.serving.cluster import DisaggCluster as JDisagg
from repro_torch.configs import get_config
from repro_torch.core.kv_transfer import kv_bytes
from repro_torch.core.workload import Request
from repro_torch.models import hybrid as tx_hybrid
from repro_torch.models.api import build_model, supports_slab
from repro_torch.serving import engine as tx_engine
from repro_torch.serving.cluster import DisaggCluster
from repro_torch.weights import from_jax

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
NAME = "zamba2-7b-smoke"
CFG, JCFG = get_config(NAME), jx_get_config(NAME)


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


def _close_trees(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        want_k = _np(w[k])
        s = max(float(np.abs(want_k).max()), 1.0)
        np.testing.assert_allclose(_np(g[k]) / s, want_k / s, err_msg=k,
                                   **F32)


def _toks(B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int32)


def test_init_layout_matches_jax(params):
    jp, _ = params
    tp = build_model(CFG).init(torch.Generator().manual_seed(0), "cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k


@pytest.mark.parametrize("S", [7, 16, 21])
def test_forward_logits_and_prefill_cache_match_jax(params, S):
    """Full logits; then the prefill cache at max_len 32 (S of 7 and 21
    pad the scan's last chunk of 16)."""
    jp, tp = params
    toks = _toks(2, S)
    jl, _, _ = jx_hybrid.forward(jp, jnp.asarray(toks), JCFG,
                                 attn_blocks=(8, 8))
    tl, _, _ = tx_hybrid.forward(tp, torch.from_numpy(toks), CFG,
                                 attn_blocks=(8, 8))
    _close_trees({"l": tl}, {"l": jl})
    jl, jc, _ = jx_hybrid.forward(jp, jnp.asarray(toks), JCFG,
                                  attn_blocks=(8, 8), return_cache=True,
                                  max_len=32)
    tl, tc, _ = tx_hybrid.forward(tp, torch.from_numpy(toks), CFG,
                                  attn_blocks=(8, 8), return_cache=True,
                                  max_len=32)
    _close_trees({"l": tl}, {"l": jl})
    _close_trees(tc, jc)


def test_prefill_decode_logits_match_jax(params):
    """Prefill 18 tokens, then 3 decode steps over the slab: each step's
    logits and the final cache against JAX's."""
    jp, tp = params
    S, extra = 18, 3
    toks = _toks(2, S + extra, seed=4)
    jm, tm = jx_build(JCFG), build_model(CFG)
    jlg, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                         max_len=S + 8, attn_blocks=(8, 8))
    tlg, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                         max_len=S + 8, attn_blocks=(8, 8))
    _close_trees({"l": tlg}, {"l": jlg})
    for j in range(extra):
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, S + j]))
        tlg, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, S + j]))
        _close_trees({"l": tlg}, {"l": jlg})
    _close_trees(tc, jc)


@pytest.mark.parametrize("name", [NAME, "zamba2-7b"])
def test_cache_specs_match_jax(name):
    t = build_model(get_config(name)).cache_specs(3, 40, torch.float32)
    j = jx_build(jx_get_config(name)).cache_specs(3, 40, jnp.float32)
    tl, jl = dict(_leaves(t)), dict(_leaves(j))
    assert tl.keys() == jl.keys()
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
    assert supports_slab(get_config(name))


def test_slab_insert_finds_the_hybrid_batch_axis(params):
    """A zamba2-7b-smoke prefill blob holds its state as (G, E, 1, ...)
    and its KV as (G, 1, T, ...): the slot write goes to axis 2 of the
    state and axis 1 of the KV, as the JAX `merge` puts it. With
    max_batch 3 (not E = 2), every other slot stays as it was."""
    _, tp = params
    eng = tx_engine.Engine(CFG, tp, device="cpu", max_batch=3, max_len=32)
    assert not eng.paged and eng.exact_len
    for leaf in (eng._cache["ssm"], eng._cache["k"],
                 *eng._cache["conv"].values()):
        leaf.fill_(7.0)
    seq = tx_engine.Sequence(0, _toks(1, 11)[0].tolist(), 3)
    _, (blob, n), _ = eng.prefill_request(seq)
    slot = eng.insert_kv(seq, (blob, n))
    c = eng._cache
    assert torch.equal(c["ssm"][:, :, slot], blob["ssm"][:, :, 0])
    for k in ("x", "B", "C"):
        assert torch.equal(c["conv"][k][:, :, slot],
                           blob["conv"][k][:, :, 0])
    assert torch.equal(c["k"][:, slot], blob["k"][:, 0])
    assert torch.equal(c["v"][:, slot], blob["v"][:, 0])
    others = [s for s in range(3) if s != slot]
    assert bool((c["ssm"][:, :, others] == 7.0).all())
    assert bool((c["k"][:, others] == 7.0).all())
    assert int(c["pos"][slot]) == n


def _serve(mod, eng, prompts, out_len=5):
    """Prefill each prompt, insert its blob into a slot, decode all to
    completion, releasing finished slots."""
    seqs = []
    for i, p in enumerate(prompts):
        s = mod.Sequence(i, list(p), out_len + i % 3)
        first, blob, _ = eng.prefill_request(s)
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
    return [s.tokens for s in seqs]


def test_slab_engine_tokens_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist()
               for n in (21, 1, 33, 5)]
    kw = dict(max_batch=4, max_len=64)
    jeng = jx_engine.Engine(JCFG, jp, **kw)
    teng = tx_engine.Engine(CFG, tp, device="cpu", **kw)
    assert _serve(tx_engine, teng, prompts) == _serve(jx_engine, jeng,
                                                      prompts)


def _reqs(cls, n=6):
    return [cls(i, i * 0.01, 10 + (i % 4) * 7, 6) for i in range(n)]


def test_disagg_cluster_tokens_and_bytes_match_jax(params):
    """The 6-request trace: the same greedy tokens as the JAX cluster, and
    the same migrated bytes, the sum of `kv_bytes` (the shared block's KV
    a group per token plus every mamba layer's f32 SSM state)."""
    jp, tp = params
    kw = dict(n_prefill=1, n_decode=1, max_batch=3, max_len=64)
    dc = DisaggCluster(CFG, tp, device="cpu", **kw)
    got = dc.run(_reqs(Request))
    jdc = JDisagg(JCFG, jp, **kw)
    want = jdc.run(_reqs(JRequest))
    assert sorted(got) == sorted(want) == list(range(6))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    expect = sum(kv_bytes(CFG, r.in_len) for r in _reqs(Request))
    assert dc.tx.total_bytes == jdc.tx.total_bytes == expect
