"""Cross-entropy train step with remat and mixed precision (port of
`repro/training/train_step.py`).

Params live in f32 (with f32 AdamW moments); the loss casts them to the
compute dtype at its top (`Model.cast`, `Tensor.to`, which autograd
differentiates), so the gradients arrive in f32 on the f32 leaves. They
come from `torch.autograd.grad` over the floating leaves, where JAX takes
`jax.value_and_grad`. On the card every layer's attention runs the
`flash_prefill` kernel forward and its `flash_prefill_bwd` kernel
backward (`kernels/flash_prefill/ops.py::FlashPrefill`), and every mamba
layer's scan the `ssd_scan` kernel forward and its `ssd_scan_bwd` kernel
backward (`kernels/ssd_scan/ops.py::SsdScan`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from .optimizer import (AdamWConfig, adamw_update, clip_by_global_norm,
                        tree_map)


def cross_entropy(logits, targets):
    """logits: (B, S, V) any float dtype; targets: (B, S) int."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, targets.long()[..., None])[..., 0] \
        .float()
    return torch.mean(lse - picked)


def make_loss_fn(model, *, remat: bool = True,
                 compute_dtype=torch.bfloat16, aux_weight: float = 0.01,
                 attn_blocks=(512, 512), plain: bool = False):
    """`plain=True` runs every kernel's plain version (the reference of
    `chip_smoke.py`'s check on the card)."""
    def loss_fn(params, batch):
        pc = model.cast(params, compute_dtype)
        logits, aux = model.forward(pc, batch, remat=remat,
                                    attn_blocks=attn_blocks, plain=plain)
        loss = cross_entropy(logits, batch["targets"])
        total = loss + aux_weight * aux
        return total, {"loss": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn, params, batch) -> Tuple[Any, Dict, Any]:
    """(total, metrics, grads) of `loss_fn(params, batch)`, the grads a
    tree like `params` over its floating leaves (JAX
    `jax.value_and_grad(loss_fn, has_aux=True)`). The leaves are detached
    views that require grad: no copy of the params."""
    leaves: List[torch.Tensor] = []

    def track(p):
        if not p.is_floating_point():
            return p
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t

    with torch.enable_grad():
        tracked = tree_map(track, params)
        total, metrics = loss_fn(tracked, batch)
        flat = torch.autograd.grad(total, leaves)
    by_id = {id(t): g for t, g in zip(leaves, flat)}
    grads = tree_map(lambda t: by_id.get(id(t), None), tracked)
    metrics = {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
               for k, v in metrics.items()}
    return total.detach(), metrics, grads


def make_train_step(model, opt_cfg: AdamWConfig = AdamWConfig(), *,
                    remat: bool = True, compute_dtype=torch.bfloat16,
                    attn_blocks=(512, 512), plain: bool = False):
    loss_fn = make_loss_fn(model, remat=remat, compute_dtype=compute_dtype,
                           attn_blocks=attn_blocks, plain=plain)

    def train_step(params, opt_state, batch):
        """One step; updates `params` and `opt_state` in place and returns
        them with the metrics (`loss`, `aux`, `total`, `grad_norm`)."""
        total, metrics, grads = value_and_grad(loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, total=total, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step
