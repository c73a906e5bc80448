"""The port's encoder-decoder (`models/encdec.py`, the seamless-m4t
backbone) on the CPU, against the JAX package with the JAX params carried
over (`repro_torch.weights.from_jax`): the encoder's output (non-causal
attention over the frames), the decoder's logits (its cross-attention
with S_tgt != T_src), the prefill cache (self KV padded to max_len, cross
KV at T_src), decode steps and `cache_specs(src_len=)`. Arch:
seamless-m4t-large-v2-smoke (2 + 2 layers, layernorm). Inputs from numpy
seeds; tolerance f32 5e-5 (`tests/test_kernels.py:16`) relative to the
tensor's largest |value|.

Each stage is held from the same input as JAX's: the decoder from JAX's
encoder output, a decode step from JAX's cache. At the JAX init scales
this model's logits move by up to ~5e-4 with the f32 summation order of
its attention: the JAX package's own two oracles, `flash_reference` and
`dense_attention`, give logits that far apart on these inputs, and such
differences compound from one stage to the next."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import encdec as jx_encdec
from repro.models.api import build_model as jx_build
from repro_torch.configs import get_config
from repro_torch.models import encdec as tx_encdec
from repro_torch.models.api import build_model, supports_slab
from repro_torch.weights import from_jax

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
NAME = "seamless-m4t-large-v2-smoke"
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


def _batch(B, S, T, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, CFG.vocab_size, (B, S)).astype(
                np.int32),
            "src_embeds": (0.3 * rng.standard_normal(
                (B, T, CFG.d_model))).astype(np.float32)}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_init_layout_matches_jax(params):
    jp, _ = params
    tp = build_model(CFG).init(torch.Generator().manual_seed(0), "cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
    assert not supports_slab(CFG)


@pytest.mark.parametrize("S,T", [(9, 12), (20, 5), (16, 16)])
def test_encoder_and_forward_logits_match_jax(params, S, T):
    """Encoder output over T frames; from JAX's encoder output, the
    decoder's logits for S target tokens (cross-attention with queries
    fewer, more, and as many as keys). The facade's batch-dict forward
    returns the whole chain's (logits, aux) in JAX's shapes."""
    jp, tp = params
    b = _batch(2, S, T)
    je = jx_encdec.encode(jp, jnp.asarray(b["src_embeds"]), JCFG,
                          attn_blocks=(8, 8))
    te = tx_encdec.encode(tp, torch.from_numpy(b["src_embeds"]), CFG,
                          attn_blocks=(8, 8))
    _close_trees({"e": te}, {"e": je})
    enc = np.array(je)
    jl, _ = jx_encdec._decoder_forward(jp, jnp.asarray(b["tokens"]),
                                       jnp.asarray(enc), JCFG, (8, 8))
    tl, _ = tx_encdec._decoder_forward(tp, torch.from_numpy(b["tokens"]),
                                       torch.from_numpy(enc), CFG, (8, 8))
    _close_trees({"l": tl}, {"l": jl})
    jf, _ = jx_build(JCFG).forward(jp, _jax(b), attn_blocks=(8, 8))
    tf, taux = build_model(CFG).forward(tp, _torch(b), attn_blocks=(8, 8))
    assert taux == 0.0 and tuple(tf.shape) == jf.shape == (2, S,
                                                           CFG.vocab_size)
    assert np.isfinite(_np(tf)).all()


def test_prefill_cache_and_decode_logits_match_jax(params):
    """Prefill 14 target tokens over 12 frames (self KV padded to 24):
    the cache of the whole prefill, and the decoder's logits and cache
    from JAX's encoder output; then 3 decode steps attending over the
    fixed cross KV, each step from JAX's cache of the step before."""
    jp, tp = params
    S, extra, T = 14, 3, 12
    b = _batch(2, S + extra, T, seed=3)
    pre = dict(b, tokens=b["tokens"][:, :S])
    jm, tm = jx_build(JCFG), build_model(CFG)
    jlg, jc = jm.prefill(jp, _jax(pre), max_len=24, attn_blocks=(8, 8))
    tlg, tc = tm.prefill(tp, _torch(pre), max_len=24, attn_blocks=(8, 8))
    assert tuple(tlg.shape) == jlg.shape
    _close_trees(tc, jc)
    enc = jx_encdec.encode(jp, jnp.asarray(b["src_embeds"]), JCFG, (8, 8))
    jl, jdc = jx_encdec._decoder_forward(
        jp, jnp.asarray(pre["tokens"]), enc, JCFG, (8, 8),
        return_cache=True, max_len=24)
    tl, tdc = tx_encdec._decoder_forward(
        tp, torch.from_numpy(pre["tokens"]), torch.from_numpy(
            np.array(enc)), CFG, (8, 8), return_cache=True, max_len=24)
    _close_trees({"l": tl}, {"l": jl})
    _close_trees(tdc, jdc)
    for j in range(extra):
        tok = b["tokens"][:, S + j]
        tc = from_jax(jax.tree.map(np.asarray, jc))
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tlg, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_trees({"l": tlg}, {"l": jlg})
        _close_trees(tc, jc)


@pytest.mark.parametrize("src_len", [12, 4096])
def test_cache_specs_match_jax(src_len):
    t = build_model(CFG).cache_specs(3, 40, torch.float32, src_len=src_len)
    j = jx_build(JCFG).cache_specs(3, 40, jnp.float32, src_len=src_len)
    assert t.keys() == j.keys()
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
