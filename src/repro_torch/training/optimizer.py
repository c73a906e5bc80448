"""AdamW + global-norm clipping (port of `repro/training/optimizer.py`).

Params, grads and the optimizer state are nested dicts of tensors, as in
the JAX package. The arithmetic is JAX's, step for step and in the same
order (`adamw_update`); leaves are visited in JAX's tree order (dict
keys sorted), so the global norm sums them in the same order too. The
update writes params and moments in place under `torch.no_grad()`, and
the clip scales the grads in place, where JAX returns new arrays (it
donates the old ones): at full width the state is most of the card's
memory. Both still return what JAX returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_leaves(tree) -> List[Any]:
    """Leaves in `jax.tree.leaves` order: dict keys sorted, lists and
    tuples in order."""
    out: List[Any] = []

    def rec(node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)
        else:
            out.append(node)
    rec(tree)
    return out


def tree_map(fn, tree, *rest):
    """`jax.tree.map` over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def global_norm(tree):
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """Scale `grads` to a global norm of at most `max_norm`, in place (the
    update's inputs; JAX returns a new tree). Returns them and the norm
    before clipping."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    tree_map(lambda g: g.mul_(scale.to(g.dtype)), grads)
    return grads, gnorm


def _lr_at(step, cfg: AdamWConfig):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place on `params` and the moments (JAX
    `adamw_update`'s formulas in its order). Weight decay applies to
    every leaf, as in JAX."""
    step = state["step"] + 1
    lr = _lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float()
        pf = p.float()
        m.mul_(b1).add_((1 - b1) * g)            # b1 m + (1 - b1) g
        v.mul_(b2).add_((1 - b2) * g * g)        # b2 v + (1 - b2) g g
        mh = m / bc1
        vh = v / bc2
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(pf)

    tree_map(upd, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state
