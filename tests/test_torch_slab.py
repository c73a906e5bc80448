"""The transformer's dense-slab path on the CPU, against the JAX package
with the JAX params carried over through `repro_torch.weights.from_jax`:
`slab_attend` against `decode_attend`, the caches `forward` returns (ring
packing and padding), `cache_specs`, `decode_step` logits across the
window, the slab `Engine`'s greedy tokens and the disaggregated cluster's
tokens and migrated bytes. Archs: gemma3-1b-smoke (sliding-window ring
caches), a 6-layer cut of it (5 local : 1 global, so a global slab too)
and yi-6b-smoke with `paged=False` (bucketed prefill, `last_pos`).
Tolerance: f32 5e-5 (`tests/test_kernels.py:16`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.core.workload import Request as JRequest
from repro.models import attention as jx_attn
from repro.models import transformer as jx_tf
from repro.models.api import build_model as jx_build
from repro.serving import engine as jx_engine
from repro.serving.cluster import DisaggCluster as JDisagg
from repro_torch.configs import get_config
from repro_torch.core.kv_transfer import kv_bytes
from repro_torch.core.workload import Request
from repro_torch.models import attention as tx_attn
from repro_torch.models import transformer as tx_tf
from repro_torch.models.api import build_model, supports_slab
from repro_torch.serving import engine as tx_engine
from repro_torch.serving.cluster import ColocatedCluster, DisaggCluster
from repro_torch.weights import from_jax

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16


def _cfgs(name):
    """(port, JAX) configs: a smoke config, or `gemma3-6l`, gemma3-1b-smoke
    cut to 6 layers (layer 5 is global), `-cap` with a 20.0 soft cap."""
    base = name.replace("-cap", "")
    if base == "gemma3-6l":
        cut = dict(num_layers=6, name="gemma3-1b-smoke-6l")
        pair = (dataclasses.replace(get_config("gemma3-1b-smoke"), **cut),
                dataclasses.replace(jx_get_config("gemma3-1b-smoke"), **cut))
    else:
        pair = get_config(base), jx_get_config(base)
    if name.endswith("-cap"):
        pair = tuple(dataclasses.replace(c, attn_logit_softcap=20.0)
                     for c in pair)
    return pair


_PARAMS = {}


def _params(name):
    """JAX params of `name` from PRNGKey(0) and their port copy."""
    if name not in _PARAMS:
        cfg, jcfg = _cfgs(name)
        jp = jx_build(jcfg).init(jax.random.PRNGKey(0))
        _PARAMS[name] = jp, from_jax(jax.tree.map(np.asarray, jp))
    return _PARAMS[name]


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
    """Every leaf of a cache: shape, and values within 5e-5 of the leaf's
    largest |value|, as `tests/test_torch_model.py::_close_scaled` holds
    KV entries (at the JAX init scale they reach ~30); `pos` exactly."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        want_k = _np(w[k])
        s = max(float(np.abs(want_k).max()), 1.0)
        np.testing.assert_allclose(_np(g[k]) / s, want_k / s, err_msg=k,
                                   **F32)
    assert _np(got["pos"]).tolist() == _np(want["pos"]).tolist()


# ---------------------------------------------------------------------------
# slab_attend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("when", ["before", "past"])
@pytest.mark.parametrize("cache", ["full", "ring"])
def test_slab_attend_matches_decode_attend(cache, when, G, softcap):
    """One token per sequence over a slab: a full cache of 24 slots (a
    page view of 8-row pages) or an 8-slot ring, with `pos` before and
    past the cache length (a ring past its window holds the last 8 tokens
    in rotation), query-head groups 1, 2 and 4, soft cap off and on."""
    rng = np.random.default_rng(G + (7 if cache == "ring" else 0))
    B, Hkv, hd = 3, 2, 16
    smax = 24 if cache == "full" else 8
    pos = np.array([0, 5, 7] if when == "before" else [8, 23, 40], np.int32)
    q = rng.standard_normal((B, Hkv * G, hd)).astype(np.float32)
    kc = rng.standard_normal((B, smax, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, smax, Hkv, hd)).astype(np.float32)
    kv_len = np.minimum(pos + 1, smax)
    want = jx_attn.decode_attend(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_len),
        logit_softcap=softcap,
        ring_pos=jnp.asarray(pos) if cache == "ring" else None)
    got = tx_attn.slab_attend(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(kv_len),
                              logit_softcap=softcap)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("smax,page", [(2048, 32), (512, 32), (24, 8),
                                       (12, 4), (7, 1)])
def test_slab_pages_view_the_slab_without_a_copy(smax, page):
    """The page view shares the slab's memory (a write through it lands in
    the slab) and the identity table addresses slot s of sequence b at
    page b * smax / page + s // page, row s % page."""
    B, Hkv, hd = 3, 1, 16
    kc = torch.zeros(B, smax, Hkv, hd)
    kp, vp, table = tx_attn.slab_pages(kc, kc.clone())
    assert kp.shape == (B * smax // page, page, Hkv, hd)
    assert kp.data_ptr() == kc.data_ptr()
    assert table.dtype == torch.int32 and table.shape == (B, smax // page)
    assert table is tx_attn.slab_pages(kc, kc)[2]        # cached
    b, s = B - 1, smax - 1
    kp[table[b, s // page], s % page] = 1.0
    assert float(kc[b, s].sum()) == hd and float(kc.sum()) == hd


# ---------------------------------------------------------------------------
# forward caches, cache_specs, decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [5, 8, 13])
@pytest.mark.parametrize("name", ["gemma3-1b-smoke", "gemma3-6l",
                                  "yi-6b-smoke"])
def test_forward_slab_caches_match_jax(name, S):
    """`forward(return_cache=True, max_len=32)`: the last position's
    logits and every segment's cache, below, at and above gemma3's 8-token
    window (ring-packed above it, zero-padded below), global and dense
    segments padded to 32, and `pos`."""
    cfg, jcfg = _cfgs(name)
    jp, tp = _params(name)
    toks = np.random.default_rng(S).integers(1, cfg.vocab_size, (2, S))
    jl, jc, _ = jx_tf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                              return_cache=True, max_len=32)
    tl, tc, _ = tx_tf.forward(tp, torch.from_numpy(toks), cfg,
                              return_cache=True, max_len=32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
    _close_trees(tc, jc)


def test_forward_last_pos_picks_the_real_row():
    """Right-padded prompts (the slab engine's buckets): `last_pos` picks
    the last real position's logits, as in JAX."""
    cfg, jcfg = _cfgs("yi-6b-smoke")
    jp, tp = _params("yi-6b-smoke")
    toks = np.zeros((1, 16), np.int64)
    toks[0, :11] = np.random.default_rng(3).integers(1, cfg.vocab_size, 11)
    jl, jc, _ = jx_tf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                              return_cache=True, max_len=32, last_pos=10)
    tl, tc, _ = tx_tf.forward(tp, torch.from_numpy(toks), cfg,
                              return_cache=True, max_len=32, last_pos=10)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
    _close_trees(tc, jc)


@pytest.mark.parametrize("max_len", [6, 64])
@pytest.mark.parametrize("name", ["gemma3-1b-smoke", "gemma3-6l",
                                  "yi-6b-smoke"])
def test_cache_specs_match_jax(name, max_len):
    """Shapes and dtypes of every leaf; windowed segments take min(window,
    max_len) slots."""
    cfg, jcfg = _cfgs(name)
    got = build_model(cfg).cache_specs(3, max_len, torch.bfloat16)
    want = jx_build(jcfg).cache_specs(3, max_len, jnp.bfloat16)
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    dtypes = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.int32): torch.int32}
    for k in w:
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert g[k].dtype == dtypes[jnp.dtype(w[k].dtype)], k


@pytest.mark.parametrize("name", ["gemma3-1b-smoke", "gemma3-6l",
                                  "gemma3-6l-cap", "yi-6b-smoke"])
def test_decode_step_logits_match_jax_across_the_window(name):
    """A 5-token prefill into a 16-slot slab, then 12 decode steps (pos
    5..16): gemma3's 8-slot rings fill at pos 8 and wrap after it, and a
    full slab fills at 16 and keeps writing its last slot. Logits each
    step and the final caches within 5e-5."""
    cfg, jcfg = _cfgs(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (2, 5))
    steps = rng.integers(1, cfg.vocab_size, (12, 2))
    _, jc, _ = jx_tf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             return_cache=True, max_len=16)
    _, tc, _ = tx_tf.forward(tp, torch.from_numpy(toks), cfg,
                             return_cache=True, max_len=16)
    model = build_model(cfg)
    for t in steps:
        jl, jc = jx_tf.decode_step(jp, jc, jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = model.decode_step(tp, tc, torch.from_numpy(t))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
    _close_trees(tc, jc)
    assert int(tc["pos"][0]) == 17


# ---------------------------------------------------------------------------
# Engine(paged=False) and the disaggregated cluster
# ---------------------------------------------------------------------------

def _serve(mod, eng, prompts, out_len=5):
    """Prefill each prompt, insert its blob into a slot, decode all to
    completion, releasing finished slots (so later ones reuse them)."""
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


@pytest.mark.parametrize("name", ["gemma3-1b-smoke", "gemma3-6l",
                                  "yi-6b-smoke"])
def test_slab_engine_tokens_match_jax(name):
    """Prompts of 1..33 tokens (below and above gemma3's window; yi-6b's
    bucketed to 16/32/64 with `last_pos`), slot writes, decode over a
    ragged batch that crosses the window."""
    cfg, jcfg = _cfgs(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (21, 1, 33, 5)]
    kw = dict(max_batch=4, max_len=64, paged=False)
    jeng = jx_engine.Engine(jcfg, jp, **kw)
    teng = tx_engine.Engine(cfg, tp, device="cpu", **kw)
    assert not teng.paged and teng.exact_len == jeng.exact_len
    assert supports_slab(cfg)
    assert _serve(tx_engine, teng, prompts) == _serve(jx_engine, jeng,
                                                      prompts)
    ts, js = teng.stats(), jeng.stats()
    ts.pop("clock_s"), js.pop("clock_s")          # measured, not counted
    assert ts == js


def test_slab_insert_writes_a_shorter_cache_into_leading_slots():
    """A blob whose sequence axis is shorter than the slab (as the JAX
    `merge` allows) fills the slot's leading positions and leaves the
    rest of the slot as it was."""
    cfg, _ = _cfgs("yi-6b-smoke")
    _, tp = _params("yi-6b-smoke")
    eng = tx_engine.Engine(cfg, tp, device="cpu", max_batch=2, max_len=32,
                           paged=False)
    seq = tx_engine.Sequence(0, [3, 4, 5], 2)
    _, (cache, n), _ = eng.prefill_request(seq)
    short = {k: ({p: v[p][:, :, :n] for p in ("k", "v")}
                 if k.startswith("seg") else v) for k, v in cache.items()}
    eng._cache["seg0"]["k"].fill_(7.0)
    slot = eng.insert_kv(seq, (short, n))
    k = eng._cache["seg0"]["k"]
    assert torch.equal(k[:, slot, :n], cache["seg0"]["k"][:, 0, :n])
    assert bool((k[:, slot, n:] == 7.0).all())
    assert bool((k[:, 1 - slot] == 7.0).all())
    assert int(eng._cache["pos"][slot]) == n


def _reqs(cls, n=6):
    return [cls(i, i * 0.01, 10 + (i % 4) * 7, 6) for i in range(n)]


@pytest.mark.parametrize("name", ["gemma3-1b-smoke", "yi-6b-smoke"])
def test_disagg_cluster_tokens_and_bytes_match_jax(name):
    """The 6-request trace (prompts of 10..31 tokens): the same greedy
    tokens as the JAX cluster on the slab, and the same migrated bytes,
    the sum of `kv_bytes(cfg, prompt_len)` (gemma3's capped at its
    window)."""
    cfg, jcfg = _cfgs(name)
    jp, tp = _params(name)
    kw = dict(n_prefill=1, n_decode=1, max_batch=4, max_len=64, paged=False)
    dc = DisaggCluster(cfg, tp, device="cpu", **kw)
    got = dc.run(_reqs(Request))
    jdc = JDisagg(jcfg, jp, **kw)
    want = jdc.run(_reqs(JRequest))
    assert sorted(got) == sorted(want) == list(range(6))
    assert not dc.decode[0].paged
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    expect = sum(kv_bytes(cfg, r.in_len) for r in _reqs(Request))
    assert dc.tx.total_bytes == jdc.tx.total_bytes == expect


def test_disagg_slab_tokens_match_colocated():
    """Migrating ring-packed slab caches is exact: gemma3-1b-smoke gives
    the same tokens disaggregated as on one colocated engine."""
    cfg, _ = _cfgs("gemma3-1b-smoke")
    _, tp = _params("gemma3-1b-smoke")
    r1 = DisaggCluster(cfg, tp, n_prefill=1, n_decode=1, max_batch=4,
                       max_len=64, device="cpu").run(_reqs(Request))
    r2 = ColocatedCluster(cfg, tp, n_engines=1, max_batch=4, max_len=64,
                          device="cpu").run(_reqs(Request))
    for rid in r1:
        assert r1[rid].tokens == r2[rid].tokens, rid
