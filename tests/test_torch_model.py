"""The port's model (yi-6b-smoke) against the JAX model in f32, with the
JAX params carried over through `repro_torch.weights.from_jax`; plus the
port's init layout and its import hygiene."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import transformer as jx_tf
from repro.models.api import build_model as jx_build
from repro_torch.configs import get_config
from repro_torch.models import transformer as tx_tf
from repro_torch.models.api import build_model, supports_paged
from repro_torch.weights import from_jax

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
CFG = get_config("yi-6b-smoke")
JCFG = jx_get_config("yi-6b-smoke")


@pytest.fixture(scope="module")
def params():
    jp = jx_build(JCFG).init(jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close_scaled(got, want):
    """f32 tolerance relative to the tensor's scale: KV entries at the JAX
    init scale reach ~30 (wk/wv are drawn with fan_in = kv heads)."""
    want = _np(want)
    s = float(np.abs(want).max())
    np.testing.assert_allclose(_np(got) / s, want / s, **F32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_init_matches_jax_layout_and_scales(params):
    """Same tree, shapes and dtype as the JAX init, drawn at the same
    scales (a different generator, so only the spread is compared)."""
    jp, _ = params
    tp = build_model(CFG).init(torch.Generator().manual_seed(0), "cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name, j in jl.items():
        t = tl[name]
        assert tuple(t.shape) == tuple(j.shape), name
        assert t.dtype == torch.float32
        js, ts = float(np.std(np.asarray(j))), float(t.std())
        if js == 0:
            assert ts == 0, name                  # zero-init norm weights
        else:
            assert abs(ts / js - 1) < 0.2, (name, js, ts)


def test_from_jax_keeps_layout_and_dtype(params):
    jp, tp = params
    for (name, j), (_, t) in zip(_leaves(jp), _leaves(tp)):
        assert tuple(t.shape) == tuple(j.shape), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    bf = from_jax({"w": np.asarray(jnp.ones((2, 3), jnp.bfloat16))})
    assert bf["w"].dtype == torch.bfloat16


def test_forward_logits_match_jax(params):
    """From-scratch forward: every position's logits, and the cache path
    (last_pos logits + KV)."""
    jp, tp = params
    toks = np.random.default_rng(0).integers(1, CFG.vocab_size, (2, 24))
    jl, _, _ = jx_tf.forward(jp, jnp.asarray(toks), JCFG)
    tl, _, _ = tx_tf.forward(tp, torch.from_numpy(toks), CFG)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    jl, jc, _ = jx_tf.forward(jp, jnp.asarray(toks), JCFG, return_cache=True,
                              last_pos=17)
    tl, tc, _ = tx_tf.forward(tp, torch.from_numpy(toks), CFG,
                              return_cache=True, last_pos=17)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    for part in ("k", "v"):
        _close_scaled(tc["seg0"][part], jc["seg0"][part])
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


def _pools(rng, n_pages, page):
    shp = (CFG.num_layers, n_pages, page, CFG.num_kv_heads, CFG.head_dim)
    return {p: rng.standard_normal(shp).astype(np.float32)
            for p in ("k", "v")}


def test_forward_over_prefix_pages_matches_jax(params):
    """Suffix prefill over pool pages with a trash-padded table (the fused
    prefix_prefill path)."""
    jp, tp = params
    rng = np.random.default_rng(1)
    page, plen = 8, 20
    pools = _pools(rng, 9, page)
    table = np.array([[3, 5, 6, 0]], np.int32)   # 3 live pages + trash
    toks = rng.integers(1, CFG.vocab_size, (1, 16))
    jl, jc, _ = jx_tf.forward(
        jp, jnp.asarray(toks), JCFG, return_cache=True,
        prefix_pages={"seg0": {p: jnp.asarray(a) for p, a in pools.items()}},
        prefix_table=jnp.asarray(table), prefix_len=plen, pos_offset=plen,
        last_pos=11)
    tl, tc, _ = tx_tf.forward(
        tp, torch.from_numpy(toks), CFG, return_cache=True,
        prefix_pages={"seg0": {p: torch.from_numpy(a)
                               for p, a in pools.items()}},
        prefix_table=torch.from_numpy(table), prefix_len=plen,
        pos_offset=plen, last_pos=11)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    _close_scaled(tc["seg0"]["k"], jc["seg0"]["k"])
    assert tc["pos"].tolist() == [plen + 16]


def test_decode_step_paged_three_steps_match_jax(params):
    """Three paged decode steps over a ragged batch with an idle slot
    (table row all trash, pos 0): logits and pools match JAX."""
    jp, tp = params
    rng = np.random.default_rng(2)
    page, pps = 8, 4
    pools = _pools(rng, 10, page)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([19, 8, 0], np.int32)
    jcache = {"seg0": {p: jnp.asarray(a) for p, a in pools.items()},
              "block_tables": jnp.asarray(table), "pos": jnp.asarray(pos)}
    tcache = {"seg0": {p: torch.from_numpy(a.copy())
                       for p, a in pools.items()},
              "block_tables": torch.from_numpy(table),
              "pos": torch.from_numpy(pos.copy())}
    for step in range(3):
        toks = rng.integers(1, CFG.vocab_size, 3).astype(np.int32)
        jl, jcache = jx_tf.decode_step_paged(jp, jcache, jnp.asarray(toks),
                                             JCFG)
        tl, tcache = tx_tf.decode_step_paged(tp, tcache,
                                             torch.from_numpy(toks), CFG)
        np.testing.assert_allclose(_np(tl[:2]), _np(jl[:2]), **F32)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for p in ("k", "v"):
        live = [1, 2, 3, 4, 5]         # trash page 0 holds racing idle rows
        _close_scaled(_np(tcache["seg0"][p])[:, live],
                      _np(jcache["seg0"][p])[:, live])


def test_paged_cache_specs_match_jax():
    t = tx_tf.paged_cache_specs(CFG, 3, 17, 8, torch.float32, max_len=40)
    j = jx_tf.paged_cache_specs(JCFG, 3, 17, 8, jnp.float32, max_len=40)
    assert tuple(t["seg0"]["k"].shape) == j["seg0"]["k"].shape
    assert tuple(t["block_tables"].shape) == j["block_tables"].shape
    assert t["block_tables"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["zamba2-7b-smoke",
                                  "seamless-m4t-large-v2-smoke",
                                  "moonshot-v1-16b-a3b-smoke",
                                  "internvl2-76b-smoke"])
def test_unported_families_raise_naming_the_roadmap(arch):
    """The four families the port once refused (hybrid, encdec, moe, vlm)
    build, and their forward on a batch dict equals JAX's: logits within
    5e-5 of their largest |value|. The encoder-decoder is held in its two
    stages (the decoder from JAX's encoder output): its whole chain moves
    with the f32 summation order of attention as much as JAX's own two
    attention oracles do (`tests/test_torch_encdec.py`)."""
    from repro.models import encdec as jx_encdec
    from repro_torch.models import encdec as tx_encdec
    cfg, jcfg = get_config(arch), jx_get_config(arch)
    jm, tm = jx_build(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)).astype(
        np.int32)}
    if cfg.frontend_tokens:
        b["frontend_embeds"] = (0.1 * rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        b["src_embeds"] = (0.3 * rng.standard_normal(
            (2, 10, cfg.d_model))).astype(np.float32)
        enc = jx_encdec.encode(jp, jnp.asarray(b["src_embeds"]), jcfg)
        _close_scaled(tx_encdec.encode(
            tp, torch.from_numpy(b["src_embeds"]), cfg), enc)
        jl, _ = jx_encdec._decoder_forward(jp, jnp.asarray(b["tokens"]),
                                           enc, jcfg, (8, 8))
        tl, _ = tx_encdec._decoder_forward(
            tp, torch.from_numpy(b["tokens"]),
            torch.from_numpy(np.array(enc)), cfg, (8, 8))
    else:
        jl, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in b.items()},
                           attn_blocks=(8, 8))
        tl, _ = tm.forward(tp, {k: torch.from_numpy(v)
                                for k, v in b.items()}, attn_blocks=(8, 8))
    assert tuple(tl.shape) == jl.shape
    _close_scaled(tl, jl)


def test_supports_paged_gating_matches_jax():
    from repro.models.api import supports_paged as jx_supports
    for name in ("yi-6b", "gemma3-1b", "mamba2-2.7b", "mixtral-8x22b",
                 "moonshot-v1-16b-a3b", "internvl2-76b"):
        assert supports_paged(get_config(name)) == \
            jx_supports(jx_get_config(name)), name


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, bad
