"""The port's MoE routed experts and VLM frontend on the CPU, against the
JAX package with the JAX params carried over (`repro_torch.weights.
from_jax`): `moe_apply` against JAX `_moe_apply_pjit` (outputs and the
load-balance aux, tokens dropped past an expert's capacity included); the
full forward, prefill and decode logits of moonshot-v1-16b-a3b-smoke
(paged), mixtral-8x22b-smoke (MoE with a sliding window, on the slab) and
internvl2-76b-smoke (with frontend embeddings); and the disaggregated
cluster's greedy tokens and migrated bytes against the JAX cluster's for
moonshot-smoke (paged, chunked and prefix-cached) and mixtral-smoke
(slab). Inputs from numpy seeds; tolerance f32 5e-5
(`tests/test_kernels.py:16`), relative to the tensor's largest |value|
where a whole model's logits are compared."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.core.workload import Request as JRequest
from repro.models import moe as jx_moe
from repro.models.api import build_model as jx_build
from repro.serving.cluster import DisaggCluster as JDisagg
from repro_torch.configs import get_config
from repro_torch.core.kv_transfer import kv_bytes
from repro_torch.core.workload import Request
from repro_torch.models import moe as tx_moe
from repro_torch.models.api import build_model, supports_paged
from repro_torch.serving.cluster import DisaggCluster
from repro_torch.weights import from_jax

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
ARCHS = ["moonshot-v1-16b-a3b-smoke", "mixtral-8x22b-smoke",
         "internvl2-76b-smoke"]
_PARAMS = {}


def _params(name):
    """JAX params of `name` from PRNGKey(0) and their port copy."""
    if name not in _PARAMS:
        jp = jx_build(jx_get_config(name)).init(jax.random.PRNGKey(0))
        _PARAMS[name] = jp, from_jax(jax.tree.map(np.asarray, jp))
    return _PARAMS[name]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close_scaled(got, want):
    want = _np(want)
    s = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(got) / s, want / s, **F32)


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend_tokens:
        b["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return b


def _to(batch, mod):
    conv = torch.from_numpy if mod == "torch" else jnp.asarray
    return {k: conv(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.0, 0.25])
@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b-smoke",
                                  "mixtral-8x22b-smoke"])
def test_moe_apply_matches_jax_pjit(name, cf):
    """Outputs and aux on 2 x 32 tokens. At cf 0.25 the capacity is 8
    slots an expert for 128 routed (token, choice) pairs over 4 experts,
    so tokens drop (counted here), in the order JAX drops them."""
    cfg, jcfg = get_config(name), jx_get_config(name)
    jp, tp = _params(name)
    seg = next(k for k in jp if k.startswith("seg") and "moe" in jp[k])
    jl = jax.tree.map(lambda a: a[0], jp[seg]["moe"])
    tl = {k: v[0] for k, v in tp[seg]["moe"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    want, jaux = jx_moe._moe_apply_pjit(jl, jnp.asarray(x), jcfg, cf)
    got, taux = tx_moe.moe_apply(tl, torch.from_numpy(x), cfg, cf)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)
    if cf:
        gates = torch.softmax(torch.from_numpy(x.reshape(64, -1))
                              @ tl["router"], -1)
        topi = torch.topk(gates, cfg.moe.num_experts_per_tok, -1).indices
        per_expert = torch.bincount(topi.reshape(-1),
                                    minlength=cfg.moe.num_experts)
        C = tx_moe.capacity(64, cfg, cf)
        assert C == 8 and int((per_expert - C).clamp(min=0).sum()) > 0


def test_moe_capacity_matches_the_jax_formula():
    cfg = get_config("moonshot-v1-16b-a3b")          # 64 experts, top 6
    assert tx_moe.capacity(8, cfg) == 8              # floor of 8 slots
    assert tx_moe.capacity(512, cfg) == 96           # ceil(512*6/64*2)
    assert tx_moe.capacity(512, cfg, 1.0) == 48


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_and_aux_match_jax(name):
    """The facade's batch-dict forward: (B, P + S, V) logits and aux."""
    cfg, jcfg = get_config(name), jx_get_config(name)
    jp, tp = _params(name)
    b = _batch(cfg, 2, 20)
    jl, jaux = jx_build(jcfg).forward(jp, _to(b, "jax"), attn_blocks=(8, 8))
    tl, taux = build_model(cfg).forward(tp, _to(b, "torch"),
                                        attn_blocks=(8, 8))
    assert tuple(tl.shape) == jl.shape
    _close_scaled(tl, jl)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_logits_match_jax(name):
    """`tests/test_models_smoke.py::test_smoke_prefill_decode_parity` on
    both packages: prefill 18 tokens (after the frontend embeddings), then
    2 decode steps, on the slab; each step's logits against JAX's."""
    cfg, jcfg = get_config(name), jx_get_config(name)
    jp, tp = _params(name)
    S, extra = 18, 2
    b = _batch(cfg, 2, S + extra)
    pre = dict(b, tokens=b["tokens"][:, :S])
    jm, tm = jx_build(jcfg), build_model(cfg)
    jlg, jc = jm.prefill(jp, _to(pre, "jax"), max_len=S + 8,
                         attn_blocks=(8, 8))
    tlg, tc = tm.prefill(tp, _to(pre, "torch"), max_len=S + 8,
                         attn_blocks=(8, 8))
    _close_scaled(tlg, jlg)
    for j in range(extra):
        tok = b["tokens"][:, S + j]
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tlg, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_scaled(tlg, jlg)


def test_supports_paged_for_the_moe_and_vlm_families():
    assert supports_paged(get_config("moonshot-v1-16b-a3b-smoke"))
    assert supports_paged(get_config("internvl2-76b-smoke"))
    assert not supports_paged(get_config("mixtral-8x22b-smoke"))  # window


def test_bf16_init_draws_stacked_leaves_in_bf16():
    """A bf16 init stores every stacked leaf in bf16, drawn a layer at a
    time at the f32 init's scales."""
    cfg = get_config("moonshot-v1-16b-a3b-smoke")
    p = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu",
                              dtype=torch.bfloat16)
    wi = p["seg1"]["moe"]["wi"]
    assert wi.dtype == torch.bfloat16 and wi.shape[0] == 3
    assert abs(float(wi.float().std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert not torch.equal(wi[0], wi[1])


# ---------------------------------------------------------------------------
# the disaggregated cluster
# ---------------------------------------------------------------------------

def _shared_prefix_trace(cls, vocab):
    """Six requests, four sharing a 24-token head, prompts of 9..41."""
    rng = np.random.default_rng(5)
    head = rng.integers(1, vocab, 24).tolist()
    out = []
    for i, n in enumerate([17, 9, 30, 5, 18, 26]):
        body = rng.integers(1, vocab, n).tolist()
        toks = head + body if i % 3 else body
        out.append(cls(i, 0.1 * i, len(toks), 4 + i % 3,
                       tokens=tuple(toks)))
    return out


@pytest.mark.parametrize("name,mode", [
    ("moonshot-v1-16b-a3b-smoke", "paged"),
    ("moonshot-v1-16b-a3b-smoke", "prefix_chunked"),
    ("mixtral-8x22b-smoke", "slab"),
])
def test_cluster_tokens_and_bytes_match_jax(name, mode):
    """Same trace, same weights: the port's DisaggCluster and the JAX
    DisaggCluster give the same greedy tokens and migrate the same
    bytes; `prefix_chunked` adds the prefix cache and 16-token chunks."""
    cfg, jcfg = get_config(name), jx_get_config(name)
    jp, tp = _params(name)
    kw = dict(n_prefill=1, n_decode=1, max_batch=4, max_len=96,
              lm_tokens=48)
    if mode == "prefix_chunked":
        kw.update(prefix_cache=True, chunk_tokens=16)
    dc = DisaggCluster(cfg, tp, device="cpu", **kw)
    got = dc.run(_shared_prefix_trace(Request, cfg.vocab_size))
    jdc = JDisagg(jcfg, jp, **kw)
    want = jdc.run(_shared_prefix_trace(JRequest, cfg.vocab_size))
    assert sorted(got) == sorted(want) == list(range(6))
    assert dc.decode[0].paged == (mode != "slab")
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    if mode != "prefix_chunked":
        expect = sum(kv_bytes(cfg, r.in_len)
                     for r in _shared_prefix_trace(Request, cfg.vocab_size))
        assert dc.tx.total_bytes == expect
    # with the prefix cache, which request hits depends on measured step
    # times (the schedule): each side's bytes are its own schedule's
    assert dc.tx.total_bytes > 0
    if mode == "prefix_chunked":
        assert dc.prefill[0].fused_dispatches > 0
    else:
        assert dc.tx.total_bytes == jdc.tx.total_bytes
