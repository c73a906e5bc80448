"""The serving engine's `fused_prefix=False` prefix path on the CPU (the
dense gather of the cached prefix pages, padded to the page bucket, and
the suffix prefill over it through `prefix_prefill` on its page view):
the same tokens as the fused path, and as the JAX engine's and cluster's
dense-gather fallback, with the JAX params carried over
(`repro_torch.weights.from_jax`). Trace: `tests/test_prefix_cache.py`'s
shared-prefix trace (a 16-token system prompt plus 5..10 user tokens),
on yi-6b-smoke and moonshot-v1-16b-a3b-smoke (MoE)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.core.workload import Request as JRequest
from repro.models import transformer as jx_tf
from repro.models.api import build_model as jx_build
from repro.serving import engine as jx_engine
from repro.serving.cluster import DisaggCluster as JDisagg
from repro_torch.configs import get_config
from repro_torch.core.workload import Request
from repro_torch.models import transformer as tx_tf
from repro_torch.serving import engine as tx_engine
from repro_torch.serving.cluster import DisaggCluster
from repro_torch.weights import from_jax

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        jp = jx_build(jx_get_config(name)).init(jax.random.PRNGKey(0))
        _PARAMS[name] = jp, from_jax(jax.tree.map(np.asarray, jp))
    return _PARAMS[name]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _shared_prefix_trace(cls, vocab, n=6, seed=1):
    """`tests/test_prefix_cache.py::_shared_prefix_trace`."""
    rr = np.random.default_rng(seed)
    sys_p = tuple(rr.integers(1, vocab, 16).tolist())
    out = []
    for i in range(n):
        u = tuple(rr.integers(1, vocab, 5 + i).tolist())
        out.append(cls(i, i * 0.5, 16 + len(u), 5, tokens=sys_p + u))
    return out


@pytest.mark.parametrize("name", ["yi-6b-smoke", "moonshot-v1-16b-a3b-smoke"])
def test_forward_over_a_dense_prefix_matches_jax(name):
    """A 13-token suffix over a 32-position gathered prefix of which 24
    are live (the page-bucket padding masked by prefix_len): the port's
    prefix_prefill over the gather's page view against JAX's
    flash_reference over the concatenation."""
    cfg, jcfg = get_config(name), jx_get_config(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (1, 13)).astype(np.int32)
    pkv = {}
    for i, seg in enumerate(tx_tf.layer_plan(cfg)):
        shp = (seg.n, 1, 32, cfg.num_kv_heads, cfg.head_dim)
        pkv[f"seg{i}"] = {p: rng.standard_normal(shp).astype(np.float32)
                          for p in ("k", "v")}
    kw = dict(return_cache=True, prefix_len=24, pos_offset=24, last_pos=12)
    jl, jc, jaux = jx_tf.forward(
        jp, jnp.asarray(toks), jcfg, attn_blocks=(8, 8),
        prefix_kv=jax.tree.map(jnp.asarray, pkv), **kw)
    tl, tc, taux = tx_tf.forward(
        tp, torch.from_numpy(toks), cfg, attn_blocks=(8, 8),
        prefix_kv=from_jax(pkv), **kw)
    s = float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(_np(tl) / s, _np(jl) / s, **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)
    for k in tc:
        if k.startswith("seg"):
            for p in ("k", "v"):
                w = _np(jc[k][p])
                s = float(np.abs(w).max())
                np.testing.assert_allclose(_np(tc[k][p]) / s, w / s, **F32)


def _engine_serve(mod, cfg, params, prompts, **kw):
    """Prefill each prompt in turn on one paged engine with the prefix
    cache (each later prompt hits the system prompt's page), insert its
    blob into the same engine, decode all to completion."""
    eng = mod.Engine(cfg, params, max_batch=6, max_len=64,
                     prefix_cache=True, **kw)
    seqs, hits = [], []
    for i, p in enumerate(prompts):
        s = mod.Sequence(i, list(p), 5)
        first, blob, _ = eng.prefill_request(s)
        hits.append(s.prefix_hit)
        s.tokens.append(first)
        s.produced += 1
        wire = eng.materialize_wire(blob) if isinstance(blob, mod.KVBlob) \
            else blob
        eng.insert_kv(s, wire)
        seqs.append(s)
    while any(not s.done for s in seqs):
        eng.decode_step([s for s in seqs if not s.done])
    return [s.tokens for s in seqs], hits, eng


@pytest.mark.parametrize("name", ["yi-6b-smoke", "moonshot-v1-16b-a3b-smoke"])
def test_engine_fallback_matches_fused_and_jax(name):
    """The same prompts through the port's fused path, its fallback and
    the JAX engine's fallback: identical tokens and prefix hits; the
    fallback's blob is the stitched prefix + suffix (a tuple, not a
    page-backed blob) and it never runs the fused dispatch."""
    cfg, jcfg = get_config(name), jx_get_config(name)
    jp, tp = _params(name)
    prompts = [r.tokens for r in _shared_prefix_trace(Request,
                                                      cfg.vocab_size)]
    fused, fh, feng = _engine_serve(tx_engine, cfg, tp, prompts,
                                    device="cpu")
    dense, dh, deng = _engine_serve(tx_engine, cfg, tp, prompts,
                                    device="cpu", fused_prefix=False)
    want, jh, _ = _engine_serve(jx_engine, jcfg, jp, prompts,
                                fused_prefix=False)
    assert fused == dense == want
    assert fh == dh == jh and sum(dh) > 0
    assert feng.fused_dispatches > 0 and deng.fused_dispatches == 0
    assert feng.fused_prefix and not deng.fused_prefix


@pytest.mark.parametrize("chunk_tokens", [None, 8])
def test_cluster_fallback_matches_fused_and_jax(chunk_tokens):
    """The shared-prefix trace through 2 + 2 engines: the port's fallback
    gives the fused path's tokens and the JAX fallback cluster's, with
    the same prefix hits as the fused path; with 8-token chunks every
    chunk after a prompt's first attends over a gather of its pages."""
    cfg, jcfg = get_config("yi-6b-smoke"), jx_get_config("yi-6b-smoke")
    jp, tp = _params("yi-6b-smoke")
    kw = dict(n_prefill=2, n_decode=2, max_batch=4, max_len=64,
              lm_tokens=48, prefix_cache=True, chunk_tokens=chunk_tokens)
    fused = DisaggCluster(cfg, tp, device="cpu", **kw)
    dense = DisaggCluster(cfg, tp, device="cpu", fused_prefix=False, **kw)
    assert not any(e.fused_prefix for e in dense.prefill)
    r_f = fused.run(_shared_prefix_trace(Request, cfg.vocab_size))
    r_d = dense.run(_shared_prefix_trace(Request, cfg.vocab_size))
    r_j = JDisagg(jcfg, jp, fused_prefix=False, **kw).run(
        _shared_prefix_trace(JRequest, cfg.vocab_size))
    assert sorted(r_f) == sorted(r_d) == sorted(r_j)
    for rid in r_f:
        assert r_f[rid].tokens == r_d[rid].tokens == r_j[rid].tokens, rid
    assert sum(r.prefix_hit for r in r_d.values()) > 0
    assert sum(e.fused_dispatches for e in dense.prefill) == 0
