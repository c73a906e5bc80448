"""Runs the port's DTensor paths on a real 4-rank `gloo` process group on
the CPU, for `tests/test_torch_sharded_gloo.py` and
`tests/test_torch_moe_dispatch.py`:

    python tests/torch_sharded_worker.py IN.npz OUT.npz PART[,PART...]

PARTs: `cores` (the shard-local attention, decode and scan cores of
`models/sharded.py` on (2, 2) and (1, 4) data x model meshes), `moe`
(`moe_apply_shard_map` and `moe_apply_grouped` on DTensors), `train`
(yi-6b-smoke's loss, gradients and one step, sharded by the train rules
and on plain tensors), `decode_cuda` (the decode core through the kernels
on CUDA tensors of one card, the cache split 4 ways along its sequence;
`tests/test_torch_cuda.py`). Inputs come from IN.npz; rank 0 writes every
result, gathered whole, to OUT.npz. The ranks meet through a file store
beside OUT.npz, so no port is opened.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
F32 = torch.float32


def worker_env():
    """The environment of a subprocess that imports what this one does."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in sys.path if p))


def run_worker(inp, outp, parts: str):
    """Start this script's 4 ranks on IN.npz -> OUT.npz; returns the
    Popen."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(inp), str(outp), parts], env=worker_env())


def _mesh(shape, device_type="cpu"):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), device_type)


def _dt(x, mesh, placements=None):
    """`x` (numpy or tensor) as a DTensor over `mesh` (replicated unless
    `placements`)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    t = torch.as_tensor(x)
    pl = placements or [Replicate()] * mesh.device_mesh.ndim
    return distribute_tensor(t, mesh.device_mesh, pl)


def _whole(t):
    from repro_torch.models.common import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).detach().numpy()


def _ctx(rules):
    import contextlib
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.common import sharding_ctx
    from repro_torch.models.sharded import ShardedExec
    stack = contextlib.ExitStack()
    ex = stack.enter_context(ShardedExec())
    stack.enter_context(sharding_ctx(rules))
    stack.enter_context(implicit_replication())
    return stack, ex


def part_cores(d, out):
    from repro_torch.launch.partitioning import make_rules
    from repro_torch.models import sharded
    meshes = {"22": _mesh((2, 2)), "14": _mesh((1, 4))}
    # attention: case a on (2, 2) from replicated inputs, b (a window) on
    # (2, 2) from the rules' placements, c on (1, 4) where the kv heads
    # do not divide the model axis (each rank narrows to its kv head)
    for case, mesh_key, window, placed in (("a", "22", 0, False),
                                           ("b", "22", 8, True),
                                           ("c", "14", 0, True)):
        mesh = meshes[mesh_key]
        rules = make_rules(mesh, "train")
        q, k, v = (d[f"fl_{case}_{n}"] for n in "qkv")
        if placed:
            pq = rules.placements(("batch", None, "heads", None), q.shape)
            pk = rules.placements(("batch", None, "kv_heads", None), k.shape)
            q, k, v = _dt(q, mesh, pq), _dt(k, mesh, pk), _dt(v, mesh, pk)
        else:
            q, k, v = (_dt(t, mesh) for t in (q, k, v))
        stack, _ = _ctx(rules)
        with stack:
            o = sharded.flash_prefill(q, k, v, causal=True, window=window,
                                      block_q=16, block_kv=16)
        out[f"fl_{case}"] = _whole(o)
    # the scan: B/C groups narrowed to the local heads on both meshes
    for case, mesh_key in (("a", "22"), ("b", "14")):
        mesh = meshes[mesh_key]
        rules = make_rules(mesh, "train")
        args = [_dt(d[f"ssd_{case}_{n}"], mesh)
                for n in ("x", "dt", "A", "B", "C", "D", "h0")]
        stack, _ = _ctx(rules)
        with stack:
            y, h = sharded.ssd_scan(*args[:6], chunk=8, h0=args[6])
        out[f"ssd_{case}_y"], out[f"ssd_{case}_h"] = _whole(y), _whole(h)
    # the decode: the cache sharded along Smax (a: over "data", the heads
    # over "model"; b: the batch over "data", Smax over "model"; c: Smax
    # 4 ways over "model", with ranks that hold no live key), the new row
    # written in place first
    for case, softcap, mesh_key in (("a", 0.0, "22"), ("b", 30.0, "22"),
                                    ("c", 0.0, "14")):
        mesh = meshes[mesh_key]
        rules = make_rules(mesh, "serve")
        kc, vc = d[f"dec_{case}_kc"], d[f"dec_{case}_vc"]
        pc = rules.placements(("kv_batch", "kv_seq", "kv_heads", None),
                              kc.shape)
        out[f"dec_{case}_placements"] = np.array(
            [repr(p) for p in pc])
        kc, vc = _dt(kc, mesh, pc), _dt(vc, mesh, pc)
        q, kn, vn, lens, slot = (_dt(d[f"dec_{case}_{n}"], mesh)
                                 for n in ("q", "kn", "vn", "lens", "slot"))
        stack, _ = _ctx(rules)
        with stack:
            o = sharded.decode_attend(q, kc, vc, lens, slot=slot, k_new=kn,
                                      v_new=vn, softcap=softcap)
        out[f"dec_{case}"] = _whole(o)
        out[f"dec_{case}_kc"], out[f"dec_{case}_vc"] = _whole(kc), \
            _whole(vc)


def decode_cuda_inputs(seed=23):
    """Inputs of `part_decode_cuda` (keys prefixed `cu_`): B=2, Smax=256,
    8 query heads over 2 kv heads, hd 64; the new rows at positions 39 and
    149, so with Smax split 4 ways they land on ranks 0 and 2, and rank 3
    (ranks 1-3 for sequence 0) holds no live key."""
    rng = np.random.default_rng(seed)
    B, Smax, H, Hkv, hd = 2, 256, 8, 2, 64
    pos = np.array([39, 149], np.int32)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"cu_q": f(B, H, hd), "cu_kc": f(B, Smax, Hkv, hd),
            "cu_vc": f(B, Smax, Hkv, hd), "cu_kn": f(B, Hkv, hd),
            "cu_vn": f(B, Hkv, hd), "cu_lens": pos + 1, "cu_slot": pos}


def decode_cuda_expected(d, dtype, device):
    """The unsharded kernel's output over `decode_cuda_inputs`' whole cache
    with the new rows written, and the written caches."""
    from repro_torch.models.attention import slab_attend
    q, kc, vc, kn, vn = (torch.from_numpy(d[f"cu_{n}"]).to(dtype).to(device)
                         for n in ("q", "kc", "vc", "kn", "vn"))
    bi, pos = torch.arange(q.shape[0]), torch.from_numpy(d["cu_slot"]).long()
    kc[bi, pos] = kn
    vc[bi, pos] = vn
    lens = torch.from_numpy(d["cu_lens"]).to(device)
    return slab_attend(q, kc, vc, lens), kc, vc


def part_decode_cuda(d, out):
    """`decode_attend` through the kernels on CUDA tensors of one card:
    each rank's shard of a cache split 4 ways along Smax, the ranks'
    outputs combined over gloo; f32 and bf16."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.partitioning import make_rules
    from repro_torch.models import sharded
    torch.cuda.set_device(0)
    mesh = _mesh((1, 4), "cuda")
    rules = make_rules(mesh, "serve")
    for dn, dtype in (("f32", F32), ("bf16", torch.bfloat16)):
        kc, vc = (torch.as_tensor(d[f"cu_{n}"]).to(dtype)
                  for n in ("kc", "vc"))
        pc = rules.placements(("kv_batch", "kv_seq", "kv_heads", None),
                              kc.shape)
        out["cu_placements"] = np.array([repr(p) for p in pc])
        kc, vc = _dt(kc.cuda(), mesh, pc), _dt(vc.cuda(), mesh, pc)
        q, kn, vn = (_dt(torch.as_tensor(d[f"cu_{n}"]).to(dtype).cuda(),
                         mesh) for n in ("q", "kn", "vn"))
        lens, slot = (_dt(torch.as_tensor(d[f"cu_{n}"]).cuda(), mesh)
                      for n in ("lens", "slot"))
        stack, _ = _ctx(rules)
        with stack:
            o = sharded.decode_attend(q, kc, vc, lens, slot=slot, k_new=kn,
                                      v_new=vn)
        torch.cuda.synchronize()
        cpu = _mesh((1, 4))
        for name, t in (("o", o), ("kc", kc), ("vc", vc)):
            # gathered whole on the CPU: only the combine's collectives
            # take CUDA tensors
            whole = DTensor.from_local(t.to_local().float().cpu(),
                                       cpu.device_mesh, t.placements,
                                       run_check=False).full_tensor()
            out[f"cu_{dn}_{name}"] = whole.numpy()


def part_moe(d, out):
    from repro_torch.configs import get_config
    from repro_torch.launch.partitioning import make_rules, place_tree
    from repro_torch.models import moe
    from repro_torch.models.common import eval_axes
    cfg = get_config(str(d["moe_arch"]))
    cf = float(d["moe_cf"])
    mesh = _mesh((2, 2))
    rules = make_rules(mesh, "train")
    p = {k[6:]: torch.from_numpy(v) for k, v in d.items()
         if k.startswith("moe_p_")}
    axes = eval_axes(moe.moe_params, None, cfg)
    p = place_tree(rules, p, {k: axes[k] for k in p})
    x = _dt(d["moe_x"], mesh,
            rules.placements(("batch", None, "embed_act"), d["moe_x"].shape))
    for name, fn in (("shard_map", moe.moe_apply_shard_map),
                     ("grouped", moe.moe_apply_grouped)):
        stack, _ = _ctx(rules)
        with stack:
            o, aux = fn(p, x, cfg, rules, cf)
        out[f"moe_{name}"], out[f"moe_{name}_aux"] = _whole(o), _whole(aux)


def part_train(d, out):
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.partitioning import (batch_logical_axes,
                                                 make_rules, place_tree)
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import (make_loss_fn,
                                                 make_train_step,
                                                 value_and_grad)
    cfg = get_config(str(d["train_arch"]))
    model = build_model(cfg)
    mesh = _mesh((2, 2))
    rules = make_rules(mesh, "train")
    params, axes = model.init_with_axes(torch.Generator().manual_seed(0),
                                        "cpu")
    # the attention weights at the usual fan-in scales (as
    # `tests/test_torch_training.py::_standard_scales`), so f32 noise
    # stays near its floor
    d_, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    for name, seg in params.items():
        if name.startswith("seg"):
            a = seg["attn"]
            a["wq"].mul_((H / d_) ** 0.5)
            a["wk"].mul_((Hkv / d_) ** 0.5)
            a["wv"].mul_((Hkv / d_) ** 0.5)
            a["wo"].div_(H ** 0.5)
    batch = {k: torch.from_numpy(d[f"train_{k}"])
             for k in ("tokens", "targets")}
    b_axes = batch_logical_axes(cfg, "train")
    kw = dict(compute_dtype=F32, attn_blocks=(16, 16))
    loss_fn = make_loss_fn(model, **kw)
    pd = place_tree(rules, params, axes)
    bd = place_tree(rules, batch, {k: b_axes[k] for k in batch})
    # loss and gradients, sharded and on plain tensors
    stack, ex = _ctx(rules)
    with stack:
        total, _, grads = value_and_grad(loss_fn, pd, bd)
    out["train_total_sharded"] = _whole(total)
    out["train_fallbacks"] = np.array(sorted(ex.fallbacks) or [""])
    total_p, _, grads_p = value_and_grad(loss_fn, params, batch)
    out["train_total_plain"] = total_p.numpy()
    for k, g in _flat(grads).items():
        out[f"train_grad_sharded/{k}"] = _whole(g)
    for k, g in _flat(grads_p).items():
        out[f"train_grad_plain/{k}"] = g.numpy()
    # one launcher step (`launch/train.py::_sharded_step`) and one
    # debug-mesh step from the same params
    step_fn = make_train_step(model, AdamWConfig(), **kw)
    pp = tree_map(torch.clone, params)
    pd2, _, md = train._sharded_step(step_fn, rules, place_tree(
        rules, tree_map(torch.clone, params), axes), adamw_init(pd), bd)
    pp, _, mp_ = step_fn(pp, adamw_init(pp), batch)
    for tag, m, ps in (("sharded", md, pd2), ("plain", mp_, pp)):
        out[f"train_step_loss_{tag}"] = _whole(m["loss"])
        out[f"train_step_gnorm_{tag}"] = _whole(m["grad_norm"])
        for k, t in _flat(ps).items():
            out[f"train_step_param_{tag}/{k}"] = _whole(t)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        res = {}
        for k, v in tree.items():
            res.update(_flat(v, f"{prefix}{k}."))
        return res
    return {} if tree is None else {prefix[:-1]: tree}


PARTS = {"cores": part_cores, "moe": part_moe, "train": part_train,
         "decode_cuda": part_decode_cuda}


def work(rank, inp, outp, parts):
    torch.set_num_threads(1)
    store = os.path.join(os.path.dirname(os.path.abspath(outp)),
                         "gloo_store")
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        d = dict(np.load(inp))
        out = {}
        for part in parts:
            PARTS[part](d, out)
        if rank == 0:
            np.savez(outp, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    inp, outp, parts = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
    mp.spawn(work, args=(inp, outp, parts), nprocs=WORLD)
