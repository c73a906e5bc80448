"""The train-step parity checks shared by `tests/test_torch_training_ssm.py`
(mamba2 and the hybrid, through the SSD scan's gradient) and
`tests/test_torch_training_encdec_vlm.py` (the encoder-decoder with
`src_embeds`, the VLM with `frontend_embeds`); the two files run in two
test processes. `tests/test_torch_training.py` holds the dense and MoE
families to the same checks.

The same params (the JAX init, carried over with `weights.from_jax`) and
the same numpy batches go through the JAX loss and train step and the
port's, f32 compute, no remat. The sequence is 24 tokens, not a multiple
of the smoke configs' SSD chunk (16), so the scan's padded tail is in the
backward. Tolerances are those of `tests/test_torch_training.py:1-19`:
- loss within 1e-5 relative;
- with the attention projections at standard scales (ROADMAP C1; a
  family without attention is unchanged by them), grad_norm within 1e-4
  relative and every gradient leaf within 5e-5 of its largest |grad|;
- after 3 AdamW steps from the JAX init, each step's loss within 1e-5 and
  every param within 2 * (lr_1 + lr_2 + lr_3) of JAX's.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jx_get_config
from repro.models.api import build_model as jx_build
from repro.training import train_step as jx_ts
from repro.training.optimizer import AdamWConfig as JxAdamWConfig
from repro.training.optimizer import adamw_init as jx_adamw_init
from repro.training.optimizer import adamw_update as jx_adamw_update
from repro.training.optimizer import clip_by_global_norm as jx_clip
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            global_norm, tree_leaves,
                                            tree_map)
from repro_torch.training.train_step import (make_loss_fn, make_train_step,
                                             value_and_grad)
from repro_torch.weights import from_jax

BATCH, SEQ, SRC_FRAMES = 2, 24, 20
BLOCKS = (16, 16)
LEAF_TOL, NORM_TOL, LOSS_TOL = 5e-5, 1e-4, 1e-5


def _standard_scales(tree):
    """Every attention's wq/wk/wv/wo (a dict holding them, stacked or not)
    at the usual fan-in scales, as `chip_smoke.py::scale_attention`: wq,
    wk, wv (..., d, heads, hd) times sqrt(heads / d), wo (..., heads, hd,
    d) over sqrt(heads)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _standard_scales(v) for k, v in tree.items()}
    if {"wq", "wk", "wv", "wo"} <= out.keys():
        for k in ("wq", "wk", "wv"):
            w = out[k]
            out[k] = w * math.sqrt(w.shape[-2] / w.shape[-3])
        out["wo"] = out["wo"] / math.sqrt(out["wo"].shape[-3])
    return out


@functools.lru_cache(maxsize=None)
def params(arch, init):
    """(JAX params, port params) from the JAX init, `init` "jax_init" or
    "standard_scales"."""
    jp = jax.tree.map(np.asarray, jx_build(jx_get_config(arch)).init(
        jax.random.PRNGKey(0)))
    if init == "standard_scales":
        jp = _standard_scales(jp)
    return jax.tree.map(jnp.asarray, jp), from_jax(jp)


def batch(arch, step=0):
    """(JAX batch, port batch) of step `step`, built in numpy: tokens and
    targets of `SyntheticTokens`, plus the family's embeddings (the VLM's
    targets cover its frontend positions too, as its logits do)."""
    cfg = jx_get_config(arch)
    b = dict(SyntheticTokens(DataConfig(cfg.vocab_size, BATCH, SEQ))
             .batch_at(step))
    rng = np.random.default_rng(100 + step)
    if cfg.frontend_tokens:
        b["frontend_embeds"] = (0.1 * rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
        head = rng.integers(0, cfg.vocab_size, (BATCH, cfg.frontend_tokens))
        b["targets"] = np.concatenate([head.astype(b["targets"].dtype),
                                       b["targets"]], axis=1)
    if cfg.family == "encdec":
        b["src_embeds"] = (0.3 * rng.standard_normal(
            (BATCH, SRC_FRAMES, cfg.d_model))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


_COMPILED = {}


def _compiled(key, fn, *args):
    """`fn` jitted, lowered on `args` and compiled once per key at XLA's
    lowest optimisation level: at smoke size the compile, not the run, is
    the cost."""
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    return _COMPILED[key]


def _jax_value_and_grad(arch, params, batch):
    """JAX's f32 loss and grads of `arch`, compiled once for both checks."""
    loss = jx_ts.make_loss_fn(jx_build(jx_get_config(arch)), remat=False,
                              compute_dtype=jnp.float32, attn_blocks=BLOCKS)
    return _compiled(("value_and_grad", arch),
                     jax.value_and_grad(loss, has_aux=True), params,
                     batch)(params, batch)


def _jax_train_step(arch, params, opt_state, batch):
    """JAX's `make_train_step`: value_and_grad, `clip_by_global_norm`,
    `adamw_update`, the grads from `_jax_value_and_grad`'s program."""
    opt = JxAdamWConfig()
    (_, metrics), grads = _jax_value_and_grad(arch, params, batch)

    def update(params, grads, opt_state):
        grads, _ = jx_clip(grads, opt.grad_clip)
        return jx_adamw_update(params, grads, opt_state, opt)
    params, opt_state = _compiled(("update", arch), update, params, grads,
                                  opt_state)(params, grads, opt_state)
    return params, opt_state, metrics


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def check_loss_and_grads(arch):
    """The loss, grad_norm and every gradient leaf of one step at standard
    attention scales, against JAX."""
    jp, tp = params(arch, "standard_scales")
    jb, tb = batch(arch)
    (jt, jm), jg = _jax_value_and_grad(arch, jp, jb)
    tt, tm, tg = value_and_grad(
        make_loss_fn(build_model(get_config(arch)), remat=False,
                     compute_dtype=torch.float32, attn_blocks=BLOCKS),
        tp, tb)
    assert _rel(tm["loss"], jm["loss"]) < LOSS_TOL
    assert _rel(tt, jt) < LOSS_TOL
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    assert _rel(global_norm(tg), jnp.sqrt(sum(
        jnp.sum(jnp.square(x)) for x in jl))) < NORM_TOL
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert t.shape == j.shape
        scale = max(float(np.abs(j).max()), 1e-30)
        assert float(np.abs(t.numpy() - j).max()) <= LEAF_TOL * scale


def check_three_adamw_steps(arch):
    """Three train steps (clipping, AdamW with warm-up) from the JAX init
    in both packages: each step's loss, then every param."""
    jp, tp = params(arch, "jax_init")
    tp = tree_map(torch.clone, tp)   # the step updates in place
    tstep = make_train_step(build_model(get_config(arch)), AdamWConfig(),
                            remat=False, compute_dtype=torch.float32,
                            attn_blocks=BLOCKS)
    jo, to = jx_adamw_init(jp), adamw_init(tp)
    opt = AdamWConfig()
    bound = 2 * sum(opt.lr * min(s / opt.warmup_steps, 1.0)
                    for s in (1, 2, 3))
    for i in range(3):
        jb, tb = batch(arch, step=i)
        jp, jo, jm = _jax_train_step(arch, jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert _rel(tm["loss"], jm["loss"]) < LOSS_TOL
    assert int(to["step"]) == int(jo["step"]) == 3
    for j, t in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=bound)
