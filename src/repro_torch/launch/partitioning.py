"""Logical-axis -> mesh-axis rule sets and tree placement (port of
`repro/launch/partitioning.py`).

Three modes:
  train      — FSDP("data") x TP("model"); batch over ("pod","data").
  serve      — TP("model") only; weights replicated over "data"; batch over
               ("pod","data") = replica rows.
  serve_2d   — as serve, plus weights 2D-sharded with d_model over "data"
               (for archs whose weights exceed HBM/16: mixtral, internvl2).

Every rule is a candidate LIST; the resolver (`common.ShardingRules`)
picks the first axis whose size divides the tensor dim and isn't already
used in the same spec. The rule tables are the JAX package's, pure Python
over `mesh.shape`. `tree_shardings` gives each leaf's DTensor placements
where JAX gives a NamedSharding; `place_tree` makes the DTensors.
"""
from __future__ import annotations

from typing import Any, Dict

from ..models.common import ShardingRules, tree_map

# archs that need 2D weight sharding to fit 16 GB/chip in serving
SERVE_2D_ARCHS = ("mixtral-8x22b", "internvl2-76b")


def _with_pod(mesh, *axes):
    """Prefix ("pod", ...) when a pod axis exists."""
    if "pod" in mesh.shape:
        return (("pod",) + axes,) if axes else ("pod",)
    return (axes,) if axes else ()


def make_rules(mesh, mode: str, opts=()) -> ShardingRules:
    has_pod = "pod" in mesh.shape
    batch_c = [("pod", "data") if has_pod else "data", "data", None]
    if mode == "train":
        rules = {
            # activations
            "batch": batch_c,
            "embed_act": [None],
            "heads": ["model", None],
            "kv_heads": ["model", None],
            "vocab": ["model", None],
            "kv_seq": [None],
            # params: FSDP on data, TP on model
            "embed": [("pod", "data") if has_pod else "data", "data", None],
            "kv_embed": [("pod", "data") if has_pod else "data", "data", None],
            "kv_batch": batch_c,
            "mlp": ["model", None],
            "expert": ["model", None],
            "ssm_inner": ["model", None],
            "state": [None],
            "layers": [None], "groups": [None],
        }
    elif mode in ("serve", "serve_2d"):
        # decode_weight_stationary: replicate the (tiny) decode activations
        # instead of sharding their batch, so 2D-sharded weights stay put
        # and each matmul reduces small partials.
        act_batch = [None] if "decode_weight_stationary" in opts else batch_c
        rules = {
            "batch": act_batch,
            "kv_batch": batch_c,
            "embed_act": [None],
            "heads": ["model", None],
            "kv_heads": ["model", None],
            "vocab": ["model", None],
            # KV sequence parallelism (default on): falls to the data axis
            # for B=1 long-context cells, and to the model axis for
            # small-kv-head archs; --opt kv_seq_data_only restores the
            # paper-faithful baseline.
            "kv_seq": (["data", None] if "kv_seq_data_only" in opts
                       else ["data", "model", None]),
            "embed": (["data", None] if mode == "serve_2d" else [None]),
            # KV projections of small-kv-head archs would replicate on the
            # model axis; shard their input dim on data instead
            "kv_embed": ["data", None],
            # 2D ff sharding (TP=256 for the FFN)
            "mlp": [("data", "model"), "model", None],
            "expert": ["model", None],
            "ssm_inner": ["model", None],
            "state": [None],
            "layers": [None], "groups": [None],
        }
    else:
        raise ValueError(mode)
    out = ShardingRules(mesh, rules)
    for o in opts:
        setattr(out, o, True)
    return out


def tree_shardings(rules: ShardingRules, shapes_tree, axes_tree):
    """Each leaf's DTensor placements (one per mesh dim) from its shape
    (a tensor or `TensorSpec`) and logical axes."""
    return tree_map(lambda s, ax: rules.placements(ax, tuple(s.shape)),
                    shapes_tree, axes_tree)


def place_tree(rules: ShardingRules, tree, axes_tree):
    """The tensors of `tree` as DTensors over `rules.mesh.device_mesh`,
    placed by their logical axes (each rank keeps its own shard)."""
    from torch.distributed.tensor import distribute_tensor
    dm = rules.mesh.device_mesh

    def one(t, ax):
        return distribute_tensor(t, dm, rules.placements(ax, tuple(t.shape)))
    return tree_map(one, tree, axes_tree)


# logical axes for step inputs --------------------------------------------

def batch_logical_axes(cfg, kind: str) -> Dict[str, Any]:
    if kind == "train":
        ax = {"tokens": ("batch", None), "targets": ("batch", None)}
    else:
        ax = {"tokens": ("batch", None)}
    if cfg.family == "encdec":
        ax["src_embeds"] = ("batch", None, "embed_act")
    if cfg.frontend_tokens:
        ax["frontend_embeds"] = ("batch", None, "embed_act")
    return ax
