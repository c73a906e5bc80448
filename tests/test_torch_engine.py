"""The port's paged `Engine` against the JAX `Engine` on yi-6b-smoke:
greedy f32 tokens must agree token for token (one-shot prefill + decode, a
fused prefix hit, chunked prefill at two chunk sizes), with the JAX params
carried over. Plus the port's device rule and the dense-gather
`fused_prefix=False` fallback."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models.api import build_model as jx_build
from repro.serving import engine as jx_engine
from repro_torch.configs import get_config
from repro_torch.serving import engine as tx_engine
from repro_torch.weights import from_jax

CFG = get_config("yi-6b-smoke")
JCFG = jx_get_config("yi-6b-smoke")


@pytest.fixture(scope="module")
def params():
    jp = jx_build(JCFG).init(jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def _engine(mod, params, **kw):
    jp, tp = params
    if mod is jx_engine:
        return mod.Engine(JCFG, jp, **kw)
    return mod.Engine(CFG, tp, device="cpu", **kw)


def _admit(mod, eng, seq, blob):
    wire = eng.materialize_wire(blob) if isinstance(blob, mod.KVBlob) \
        else blob
    eng.insert_kv(seq, wire)


def _decode_all(eng, seqs):
    while any(not s.done for s in seqs):
        eng.decode_step([s for s in seqs if not s.done])
        for s in seqs:
            if s.done and s.slot >= 0:
                eng.release(s)


def _serve(mod, params, prompts, out_len=5, **kw):
    """Prefill each prompt in turn, hand its blob to the same engine's
    decode slots, then decode all to completion."""
    eng = _engine(mod, params, **kw)
    seqs = []
    for i, p in enumerate(prompts):
        s = mod.Sequence(i, list(p), out_len)
        first, blob, _ = eng.prefill_request(s)
        s.tokens.append(first)
        s.produced += 1
        _admit(mod, eng, s, blob)
        seqs.append(s)
    _decode_all(eng, seqs)
    return [s.tokens for s in seqs], eng


def _prompts(seed, lens, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, CFG.vocab_size, shared).tolist()
    return [head + rng.integers(1, CFG.vocab_size, n).tolist() for n in lens]


def test_oneshot_prefill_and_decode_tokens_match_jax(params):
    prompts = _prompts(0, [21, 9, 30])
    kw = dict(max_batch=4, max_len=64, page_size=16)
    want, jeng = _serve(jx_engine, params, prompts, **kw)
    got, teng = _serve(tx_engine, params, prompts, **kw)
    assert got == want
    ts, js = teng.stats(), jeng.stats()
    ts.pop("clock_s"), js.pop("clock_s")          # measured, not counted
    assert ts == js


def test_fused_prefix_hit_tokens_match_jax(params):
    """The second and third prompts share a 2-page head with the first:
    their prefill attends over the cached pages through prefix_prefill."""
    prompts = _prompts(1, [7, 12, 3], shared=32)
    kw = dict(max_batch=4, max_len=96, page_size=16, prefix_cache=True)
    want, jeng = _serve(jx_engine, params, prompts, **kw)
    got, teng = _serve(tx_engine, params, prompts, **kw)
    assert got == want
    assert teng.fused_dispatches == jeng.fused_dispatches >= 2
    assert teng.prefix_hit_tokens == jeng.prefix_hit_tokens == 64


@pytest.mark.parametrize("chunk", [8, 6])
def test_prefill_chunk_tokens_match_jax(params, chunk):
    """Chunked prefill over pool pages (page 8; chunk 6 does not divide
    it and is rounded to whole pages except for the tail)."""
    prompts = _prompts(2, [29, 13])
    kw = dict(max_batch=2, max_len=64, page_size=8)
    out = {}
    for mod in (jx_engine, tx_engine):
        eng = _engine(mod, params, **kw)
        seqs, sizes = [], []
        for i, p in enumerate(prompts):
            s = mod.Sequence(i, list(p), 5)
            done = False
            while not done:
                done, first, blob, _dt, c = eng.prefill_chunk(s, chunk)
                sizes.append(c)
            s.tokens.append(first)
            s.produced += 1
            _admit(mod, eng, s, blob)
            seqs.append(s)
        _decode_all(eng, seqs)
        out[mod] = ([s.tokens for s in seqs], sizes, eng.chunk_dispatches)
    assert out[tx_engine] == out[jx_engine]


def test_blob_shapes_and_bytes_match_jax(params):
    """Same length buckets, so the migration blob has the JAX shape."""
    prompt = _prompts(3, [19])[0]
    blobs = {}
    for mod in (jx_engine, tx_engine):
        eng = _engine(mod, params, max_batch=2, max_len=64)
        s = mod.Sequence(0, list(prompt), 3)
        _first, blob, _ = eng.prefill_request(s)
        blobs[mod] = (tuple(blob[0]["seg0"]["k"].shape),
                      eng.kv_blob_bytes(blob))
    assert blobs[tx_engine] == blobs[jx_engine]


def test_engines_share_params_without_copy(params):
    _, tp = params
    a = tx_engine.Engine(CFG, tp, device="cpu", max_batch=1, max_len=32)
    b = tx_engine.Engine(CFG, tp, device="cpu", max_batch=1, max_len=32)
    w = tp["seg0"]["ffn"]["wi"]
    assert a.params["seg0"]["ffn"]["wi"].data_ptr() == w.data_ptr()
    assert b.params["seg0"]["ffn"]["wi"].data_ptr() == w.data_ptr()


def test_default_device_is_the_card():
    """Without `device=` an entry point runs on CUDA; with no CUDA device
    it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert tx_engine.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tx_engine.Engine(CFG, max_batch=1, max_len=32)
    from repro_torch.serving.cluster import DisaggCluster
    with pytest.raises(RuntimeError, match="CUDA"):
        DisaggCluster(CFG, None, max_batch=1, max_len=32)


def test_unported_engine_paths_raise_naming_the_roadmap(params):
    """The `fused_prefix=False` path, once refused (ROADMAP A8), runs: the
    prompts of `test_fused_prefix_hit_tokens_match_jax` give the fused
    path's tokens and prefix hits, and the JAX fallback's stats, with no
    fused dispatch."""
    prompts = _prompts(1, [7, 12, 3], shared=32)
    kw = dict(max_batch=4, max_len=96, page_size=16, prefix_cache=True)
    fused, feng = _serve(tx_engine, params, prompts, **kw)
    kw["fused_prefix"] = False
    got, teng = _serve(tx_engine, params, prompts, **kw)
    want, jeng = _serve(jx_engine, params, prompts, **kw)
    assert not teng.fused_prefix and got == fused == want
    assert teng.prefix_hit_tokens == feng.prefix_hit_tokens == 64
    ts, js = teng.stats(), jeng.stats()
    ts.pop("clock_s"), js.pop("clock_s")          # measured, not counted
    assert ts == js and ts["fused_dispatches"] == 0
