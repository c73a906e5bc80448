"""How a step runs on DTensors: the shard-local cores, one dispatch per
kernel op, and the execution mode of a sharded step.

When a launcher places params and inputs as DTensors (the dry-run on a
fake mesh, `launch/train.py --mesh pod1|pod2`), the kernel ops cannot run
on the DTensors themselves: their plain versions index, pad and mask in
ways DTensor has no rules for, the CUDA kernels read raw memory, and a
dense S x S score matrix is not the tile schedule the JAX oracle runs.
The model code calls `flash_prefill`, `ssd_scan` and `slab_attend` here
(and `decode_attend` for a DTensor slab): on plain tensors each is its
kernel op; on DTensors each is the counterpart of GSPMD's partitioning
of the JAX oracle (`flash_reference`, `decode_attend`, `ssd_chunked`). It
redistributes its inputs to the placements the active rules give the
oracle's operands (batch over the data axes, heads over "model", the KV
sequence of a decode cache where the rules put it), runs the kernel op
on each rank's local shard (the CUDA kernel on the card, its plain
version on the CPU), and wraps the result back as a DTensor. A decode
cache sharded along its sequence combines the ranks' partial outputs
across that mesh dim by their log-sum-exps (flash-decoding,
`combine_seq_shards`), on the CPU and on the card alike.

Each core reports the JAX oracle's dot flops to the active cost probe
(`count_flops`, installed by `launch/costs.py::StepProbe`): the band
tiles of `_band_tiles` for attention, `decode_attend`'s two einsums for
a decode step, and `ssd_chunked`'s einsums (with jnp's contraction
order) for the scan; the backward, when autograd runs it, twice the
forward, as JAX's transposes of those dots.

`ShardedExec` is the dispatch mode a sharded step runs under (see its
docstring).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from ..kernels.flash_prefill.ops import flash_prefill_op
from ..kernels.paged_decode.ops import paged_insert_op
# a module, not its function: ssd_scan's plain version imports models.ssd,
# which imports this module
from ..kernels.ssd_scan import ops as scan_ops
from . import attention
from .attention import _band_tiles, slab_page, slab_pages
from .common import current_rules, is_dtensor


# ---------------------------------------------------------------------------
# the cost probe's hooks
# ---------------------------------------------------------------------------

_tls = threading.local()


@contextlib.contextmanager
def cost_probe(probe):
    """Install `probe` (with `add_flops(n)` and `track(t)`) for
    `count_flops` / `count_bytes` in this thread."""
    prev = getattr(_tls, "probe", None)
    _tls.probe = probe
    try:
        yield probe
    finally:
        _tls.probe = prev


def count_flops(n: int) -> None:
    """Report `n` dot flops of a core the probe cannot see through; a
    no-op without a probe."""
    probe = getattr(_tls, "probe", None)
    if probe is not None:
        probe.add_flops(n)


def count_bytes(t) -> None:
    """Report a tensor the probe does not see made (a kernel op's output
    on a shard); a no-op without a probe."""
    probe = getattr(_tls, "probe", None)
    if probe is not None:
        probe.track(t)


# ---------------------------------------------------------------------------
# dot-flop formulas of the JAX oracles
# ---------------------------------------------------------------------------

def flash_flops(B, Sq, Skv, H, hd, *, causal=True, window=0,
                block_q=512, block_kv=512) -> int:
    """`flash_reference`'s dot flops: two einsums per band tile, each
    2 * B * H * block_q * block_kv * hd, over the tiles of `_band_tiles`
    at its padded block sizes."""
    if Sq == 0 or Skv == 0:
        return 0
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    n_q, n_kv = -(-Sq // bq), -(-Skv // bkv)
    tiles = _band_tiles(n_q, n_kv, bq, bkv, causal and Sq == Skv, window)
    return 4 * B * H * hd * bq * bkv * len(tiles)


def decode_flops(B, Smax, H, hd) -> int:
    """`decode_attend`'s two einsums over the whole slab."""
    return 4 * B * H * Smax * hd


def _pair_contraction(a: str, b: str, keep: str) -> Tuple[str, str]:
    """(result, removed) indices of contracting terms a and b when `keep`
    holds the indices still needed elsewhere (opt_einsum's
    `_find_contraction`)."""
    union = set(a) | set(b)
    result = "".join(sorted(i for i in union if i in keep))
    removed = "".join(sorted(i for i in union if i not in keep))
    return result, removed


def _oe_cost(a: str, b: str, removed: str, sizes: Dict[str, int]) -> int:
    """opt_einsum's `flop_count` of one pairwise contraction."""
    union = set(a) | set(b)
    return math.prod(sizes[i] for i in union) * (2 if removed else 1)


def _optimal_path(inputs: List[str], out: str,
                  sizes: Dict[str, int]) -> List[Tuple[int, int]]:
    """opt_einsum's 'optimal' path (what jnp.einsum's 'auto' picks for up
    to four operands): first path of least total cost, ties to the
    first found."""
    best = {"cost": math.inf, "path": None}

    def walk(terms, path, cost):
        if len(terms) == 1:
            if cost < best["cost"]:
                best.update(cost=cost, path=path)
            return
        for i, j in itertools.combinations(range(len(terms)), 2):
            rest = [t for k, t in enumerate(terms) if k not in (i, j)]
            keep = set(out).union(*rest) if rest else set(out)
            res, rem = _pair_contraction(terms[i], terms[j], keep)
            c = cost + _oe_cost(terms[i], terms[j], rem, sizes)
            if c >= best["cost"]:
                continue
            walk(rest + [res], path + [(i, j)], c)

    walk(list(inputs), [], 0)
    return best["path"]


def einsum_dot_flops(spec: str, *shapes: Sequence[int]) -> int:
    """The dot flops JAX counts (`launch/costs.py::_dot_flops` on each
    `dot_general`) for `jnp.einsum(spec, ...)` on operands of `shapes`:
    opt_einsum's path, then per pair jnp's rules (size-1 dims dropped
    against a larger counterpart, indices of one operand summed out
    first, one dot_general of batch x contract x free x free)."""
    lhs, out = spec.replace(" ", "").split("->")
    terms = lhs.split(",")
    sizes: Dict[str, int] = {}
    dims = []
    for t, s in zip(terms, shapes):
        dims.append(dict(zip(t, s)))
        for i, n in zip(t, s):
            sizes[i] = max(sizes.get(i, 1), n)
    ops = list(zip(terms, dims))
    path = ([(0, 1)] if len(terms) == 2
            else _optimal_path(terms, out, sizes))
    flops = 0
    for i, j in path:
        (a, da), (b, db) = ops[i], ops[j]
        rest = [t for k, (t, _) in enumerate(ops) if k not in (i, j)]
        keep = set(out).union(*rest) if rest else set(out)
        res, removed = _pair_contraction(a, b, keep)
        # filter_singleton_dims: a size-1 dim whose counterpart is larger
        a = "".join(c for c in a if not (da[c] == 1 and db.get(c, 1) > 1))
        b = "".join(c for c in b if not (db[c] == 1 and da.get(c, 1) > 1))
        # indices of one operand that are contracted are summed out first
        a = "".join(c for c in a if not (c in removed and c not in b))
        b = "".join(c for c in b if not (c in removed and c not in a))
        batch = [c for c in res if c in a and c in b]
        contract = [c for c in removed if c in a and c in b]
        free_a = [c for c in a if c not in batch and c not in contract]
        free_b = [c for c in b if c not in batch and c not in contract]
        flops += 2 * math.prod(da[c] for c in batch) * \
            math.prod(da[c] for c in contract) * \
            math.prod(da[c] for c in free_a) * \
            math.prod(db[c] for c in free_b)
        rd = {**{c: da[c] for c in a}, **{c: db[c] for c in b}}
        rd = {c: rd.get(c, 1) for c in res}
        ops = [o for k, o in enumerate(ops) if k not in (i, j)] + [(res, rd)]
    return flops


def ssd_flops(b, S, nh, hd, G, N, chunk) -> int:
    """`ssd_chunked`'s dot flops (its four einsums) at a padded length
    S = nc * chunk."""
    nc, Q = S // chunk, chunk
    return (einsum_dot_flops("bcqgn,bcsgn->bcgqs", (b, nc, Q, G, N),
                             (b, nc, Q, G, N))
            + einsum_dot_flops("bchqs,bcshd->bcqhd", (b, nc, nh, Q, Q),
                               (b, nc, Q, nh, hd))
            + einsum_dot_flops("bcqhn,bcqh,bcqhd->bchdn", (b, nc, Q, nh, N),
                               (b, nc, Q, nh), (b, nc, Q, nh, hd))
            + einsum_dot_flops("bcqhn,bcqh,bchdn->bcqhd", (b, nc, Q, nh, N),
                               (b, nc, Q, nh), (b, nc, nh, hd, N)))


class _CountBackward(torch.autograd.Function):
    """Identity whose backward reports `n` flops: the op's gradient."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        count_flops(ctx.n)
        return g, None


def _counted(out, fwd: int):
    """Report an op's forward flops now and its backward (2x) when
    autograd runs it, and its local result's bytes; `out` is that
    result."""
    count_flops(fwd)
    count_bytes(out)
    if torch.is_grad_enabled() and out.requires_grad:
        return _CountBackward.apply(out, 2 * fwd)
    return out


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------

def _rules():
    rules = current_rules()
    if rules is None:
        raise RuntimeError("DTensor inputs need an active sharding_ctx")
    return rules


def _local(x, placements, mesh=None):
    """This rank's shard of `x` at `placements`; a plain tensor counts as
    replicated over `mesh`."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(x.device_mesh, placements).to_local()


def _wrap(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _shard_range(x_mesh, placements, dim: int, size: int) -> Tuple[int, int]:
    """[lo, hi) of tensor dim `dim` (global `size`) held by this rank."""
    from torch.distributed.tensor import Shard
    coord = x_mesh.get_coordinate()
    lo, n = 0, size
    for md, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            m = x_mesh.size(md)
            n //= m
            lo += coord[md] * n
    return lo, lo + n


def _head_placements(rules, q_shape, k_shape, batch_dim, q_head_dim,
                     k_head_dim):
    """Placements of q and k/v: the batch dim over its resolved data
    axes, heads over "model" where both head counts divide (or q's alone,
    with each rank then taking the kv heads its q heads read)."""
    qa = [None] * len(q_shape)
    ka = [None] * len(k_shape)
    qa[batch_dim], ka[batch_dim] = "batch", "batch"
    qa[q_head_dim], ka[k_head_dim] = "heads", "kv_heads"
    return (rules.placements(qa, q_shape), rules.placements(ka, k_shape))


def _kv_for_local_heads(k_loc, mesh, pq, q_head_dim, H, Hkv, k_head_dim):
    """The kv heads (or B/C groups) this rank's q heads read, when q's
    heads are sharded and k's are not. The local q heads [lo, hi) must
    read one kv head, or whole groups of G = H / Hkv heads; else the
    local head -> kv head map would differ from the global one."""
    from torch.distributed.tensor import Shard
    q_sharded = any(isinstance(p, Shard) and p.dim == q_head_dim
                    for p in pq)
    if not q_sharded or k_loc.shape[k_head_dim] != Hkv:
        return k_loc
    lo, hi = _shard_range(mesh, pq, q_head_dim, H)
    G = H // Hkv
    klo, khi = lo // G, (hi - 1) // G + 1
    if khi - klo > 1 and (lo % G or hi % G):
        raise ValueError(f"q heads [{lo}, {hi}) split the groups of {G} "
                         f"heads that share a kv head")
    return k_loc.narrow(k_head_dim, klo, khi - klo)


# ---------------------------------------------------------------------------
# the dispatches and the cores
# ---------------------------------------------------------------------------

def flash_prefill(q, k, v, *, causal=True, window=0, block_q=512,
                  block_kv=512, softcap=0.0, plain=False):
    """`flash_prefill_op`, q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd). On
    DTensors each rank attends its batch and head shard."""
    kw = dict(causal=causal, window=window, softcap=softcap, plain=plain)
    if not is_dtensor(q):
        return flash_prefill_op(q, k, v, block_q=block_q, block_kv=block_kv,
                                **kw)
    rules = _rules()
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    pq, pk = _head_placements(rules, q.shape, k.shape, 0, 2, 2)
    mesh = q.device_mesh
    ql = _local(q, pq)
    kl = _kv_for_local_heads(_local(k, pk), mesh, pq, 2, H, Hkv, 2)
    vl = _kv_for_local_heads(_local(v, pk), mesh, pq, 2, H, Hkv, 2)
    o = flash_prefill_op(ql, kl, vl, **kw)
    o = _counted(o, flash_flops(B, Sq, Skv, H, hd, causal=causal,
                                window=window, block_q=block_q,
                                block_kv=block_kv))
    return _wrap(o, mesh, pq, tuple(q.shape))


def ssd_scan(x, dt, A, B, C, D, *, chunk, h0=None, plain=False):
    """`ssd_scan_op`. On DTensors each rank scans its batch and head
    shard, with the B/C groups its heads read."""
    if not is_dtensor(x):
        return scan_ops.ssd_scan_op(x, dt, A, B, C, D, chunk=chunk, h0=h0,
                                    plain=plain)
    rules = _rules()
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    mesh = x.device_mesh
    px = rules.placements(("batch", None, "heads", None), x.shape)
    pdt = rules.placements(("batch", None, "heads"), dt.shape)
    ph = rules.placements(("heads",), A.shape)
    pb = rules.placements(("batch", None, None, None), B.shape)
    h0l = None
    if h0 is not None:
        ph0 = rules.placements(("batch", "heads", None, None), h0.shape)
        h0l = _local(h0, ph0)
    Bl, Cl = (_kv_for_local_heads(_local(t, pb), mesh, px, 2, nh, G, 2)
              for t in (B, C))
    y, h = scan_ops.ssd_scan_op(_local(x, px), _local(dt, pdt),
                                _local(A, ph), Bl, Cl, _local(D, ph),
                                chunk=chunk, h0=h0l, plain=plain)
    y = _counted(y, ssd_flops(b, S, nh, hd, G, N, chunk))
    count_bytes(h)
    ph_out = rules.placements(("batch", "heads", None, None),
                              (b, nh, hd, N))
    return (_wrap(y, mesh, px, tuple(x.shape)),
            _wrap(h, mesh, ph_out, (b, nh, hd, N)))


def slab_attend(q, k_cache, v_cache, kv_len, *, logit_softcap=0.0,
                plain=False):
    """`attention.slab_attend`; a DTensor cache attends shard by shard
    (`decode_attend`)."""
    if is_dtensor(k_cache):
        return decode_attend(q, k_cache, v_cache, kv_len,
                             softcap=logit_softcap, plain=plain)
    return attention.slab_attend(q, k_cache, v_cache, kv_len,
                                 logit_softcap=logit_softcap, plain=plain)


def combine_seq_shards(o, lse, mesh, seq_dims):
    """Partial attention outputs over disjoint key ranges, one per rank of
    the mesh dims `seq_dims`, into the output over all their keys
    (flash-decoding's combine): o (..., hd) each rank's output over its
    keys, lse (...) f32 the log-sum-exp of its scores. Weights w = exp(lse
    - max over the ranks' lse), then sum(o w) / sum(w), in f32. A rank with
    no live key (lse about -2.38e38, the finite mask) weighs 0 beside any
    rank with one. The CPU core and the card's kernel core both end here."""
    from torch.distributed._functional_collectives import all_reduce
    m = lse
    for md in seq_dims:
        m = all_reduce(m, "max", (mesh, md))
    w = torch.exp(lse - m)
    num, den = o.float() * w[..., None], w
    for md in seq_dims:
        num = all_reduce(num, "sum", (mesh, md))
        den = all_reduce(den, "sum", (mesh, md))
    return num / torch.clamp(den, min=1e-37)[..., None]


def decode_attend(q, k_cache, v_cache, kv_len, *, slot=None, k_new=None,
                  v_new=None, softcap=0.0, plain=False):
    """One query token per sequence over a slab cache: `decode_attend`
    on DTensors q (B, H, hd), caches (B, Smax, Hkv, hd) placed by the
    cache rules, kv_len (B,). With `slot` (B,) the new row k_new/v_new
    (B, Hkv, hd) is written first, in place, on the rank whose shard holds
    it.

    On the card each rank runs `attention.slab_attend` (the `paged_decode`
    kernel) over its batch, head and sequence shard, after `paged_insert`
    of the new rows; on the CPU it attends its local keys in einsums.
    Where the cache is sharded along Smax, kv_len is made local (clamped
    to the shard), and the ranks' outputs combine by their log-sum-exps
    over those mesh dims (`combine_seq_shards`)."""
    from torch.distributed.tensor import Replicate, Shard
    rules = _rules()
    B, H, hd = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    mesh = k_cache.device_mesh
    pc = rules.placements(("kv_batch", "kv_seq", "kv_heads", None),
                          k_cache.shape)
    if slot is not None and tuple(k_cache.placements) != tuple(pc):
        raise ValueError(f"a cache written in place must lie at its "
                         f"rules' placements {pc}, not "
                         f"{tuple(k_cache.placements)}")
    kc, vc = (c.redistribute(mesh, pc).to_local()
              if tuple(c.placements) != tuple(pc) else c.to_local()
              for c in (k_cache, v_cache))
    # q and the new rows follow the cache's batch and head sharding
    pq = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
               Shard(1) if isinstance(p, Shard) and p.dim == 2 else
               Replicate() for p in pc)
    pb = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
               Replicate() for p in pc)
    ql = _local(q, pq)
    lens = _local(kv_len, pb, mesh)
    sl = None if slot is None else _local(slot, pb, mesh)
    seq_dims = [md for md, p in enumerate(pc)      # mesh dims that split Smax
                if isinstance(p, Shard) and p.dim == 1 and mesh.size(md) > 1]
    lo, hi = _shard_range(mesh, pc, 1, Smax)
    count_flops(decode_flops(B, Smax, H, hd))
    if sl is not None:
        own = (sl >= lo) & (sl < hi)               # this shard holds the row
        kn, vn = _local(k_new, pq).to(kc.dtype), _local(v_new, pq).to(kc.dtype)
    if kc.is_cuda:
        if sl is not None:
            # a sequence whose row another rank holds rewrites its row 0
            # with what it holds
            loc = torch.where(own, sl - lo, 0)
            if seq_dims:
                bi = torch.arange(kc.shape[0], device=kc.device)
                kn = torch.where(own[:, None, None], kn, kc[bi, 0])
                vn = torch.where(own[:, None, None], vn, vc[bi, 0])
            kp, vp, table = slab_pages(kc, vc)
            page = slab_page(kc.shape[1])
            pidx = torch.gather(table, 1, (loc // page).long()[:, None])[:, 0]
            paged_insert_op(kp, vp, kn, vn, pidx,
                            (loc % page).to(torch.int32), plain=plain)
        lens_l = (lens - lo).clamp(0, hi - lo).to(torch.int32)
        if not seq_dims:
            o = attention.slab_attend(ql, kc, vc, lens_l,
                                      logit_softcap=softcap, plain=plain)
            return _wrap(o, mesh, pq, (B, H, hd))
        o, lse = attention.slab_attend(ql, kc, vc, lens_l,
                                       logit_softcap=softcap, plain=plain,
                                       return_lse=True)
        o = combine_seq_shards(o, lse, mesh, seq_dims)
        return _wrap(o.to(q.dtype), mesh, pq, (B, H, hd))
    idx = torch.arange(lo, hi, device=kc.device)
    if sl is not None:
        hit = (idx[None, :] == sl[:, None])[..., None, None]   # (b, s, 1, 1)
        kc.copy_(torch.where(hit, kn[:, None], kc))
        vc.copy_(torch.where(hit, vn[:, None], vc))
    Hl, Hkvl = ql.shape[1], kc.shape[2]
    G = Hl // Hkvl
    f32 = torch.float32
    s = torch.einsum("bkgh,bskh->bkgs", ql.reshape(-1, Hkvl, G, hd).to(f32),
                     kc.to(f32)) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = idx[None, :] < lens[:, None]
    s = torch.where(valid[:, None, None, :], s, -2.3819763e38)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, vc.to(f32)) / l[..., None]
    if seq_dims:
        o = combine_seq_shards(o, m[..., 0] + torch.log(l), mesh, seq_dims)
    return _wrap(o.reshape(-1, Hl, hd).to(q.dtype), mesh, pq, (B, H, hd))


def moe_shard_local(p, x, cfg, rules, capacity_factor: float, groups: int):
    """The routed experts of `moe_apply_shard_map` / `moe_apply_grouped`
    on DTensors: manual over the (pod, data) mesh dims, DTensor ("auto")
    over the rest. The batch's `groups` token groups are aligned with its
    shards over the manual dims; each rank routes its own shard's groups
    (`moe.route_groups`) through the router and expert weights
    all-gathered over the manual dims and still sharded over "model", as
    DTensors on the "model" sub-mesh; aux is averaged over the manual
    dims. The body's flops count once for every manual shard, as JAX
    counts a shard_map body (the probe scales a product on a sub-mesh by
    the shards of the other dims)."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate
    from .moe import route_groups
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    manual = [i for i, n in enumerate(names) if n in ("pod", "data")]
    auto = [i for i, n in enumerate(names) if i not in manual]
    B, S, d = x.shape
    px = rules.placements(("batch", None, "embed_act"), x.shape)
    px = tuple(pl if i in manual else Replicate() for i, pl in enumerate(px))
    xl = _local(x, px)
    split = B // xl.shape[0]
    if groups % split:
        raise NotImplementedError(
            f"{groups} token groups over a batch split {split} ways")
    sub = mesh[tuple(names[i] for i in auto)] if len(auto) > 1 else \
        mesh[names[auto[0]]]

    def on_sub(w):
        keep = tuple(Replicate() if i in manual else pl
                     for i, pl in enumerate(w.placements))
        wl = w.redistribute(mesh, keep).to_local()
        return DTensor.from_local(
            wl, sub, [keep[i] for i in auto], run_check=False,
            shape=w.shape, stride=torch.empty(w.shape, device="meta")
            .stride())

    xs = DTensor.from_local(xl.reshape(-1, d), sub,
                            [Replicate()] * len(auto), run_check=False)
    out, aux = route_groups(xs, on_sub(p["router"]), on_sub(p["wi"]),
                            on_sub(p["wo"]), cfg, capacity_factor,
                            groups // split)
    out = out.redistribute(sub, [Replicate()] * len(auto)).to_local()
    aux = aux.redistribute(sub, [Replicate()] * len(auto)).to_local()
    for i in manual:
        aux = all_reduce(aux, "sum", (mesh, i)) / mesh.size(i)
    return (_wrap(out.reshape(xl.shape), mesh, px, tuple(x.shape)),
            _wrap(aux, mesh, (Replicate(),) * mesh.ndim, ()))


# ---------------------------------------------------------------------------
# the execution mode of a sharded step
# ---------------------------------------------------------------------------

aten = torch.ops.aten

_VIEWS = (aten.view.default, aten._unsafe_view.default,
          aten.view_copy.default, aten.reshape.default)

_SPLITS = (aten.split.Tensor, aten.split_with_sizes.default,
           aten.split_with_sizes_copy.default, aten.split_copy.Tensor)


def _inplace(func) -> bool:
    return func._schema.name.endswith("_") or any(
        a.alias_info is not None and a.alias_info.is_write
        for a in func._schema.arguments)


def _replicate_dims(x, dims):
    """`x` replicated over the mesh dims `dims`."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if i in dims else p
               for i, p in enumerate(x.placements))
    if pl == tuple(x.placements):
        raise RuntimeError(f"no sharded mesh dim of {pl} to gather")
    return x.redistribute(x.device_mesh, pl)


def _gather_dim(x, dim: int):
    """`x` with tensor dim `dim` gathered whole (replicated over the mesh
    dims that shard it). A split along a sharded dim leaves each part on
    a subset of the ranks, which no placement describes; DTensor would
    otherwise move the shard to another dim (an all-to-all that leaves
    strided shards behind)."""
    from torch.distributed.tensor import Shard
    dim = dim % x.ndim
    dims = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]
    return _replicate_dims(x, dims) if dims else x


def _view(func, args, kwargs):
    """A view of a DTensor. Where the view would leave a strided shard
    (which later redistributes cannot take) or cannot split a sharded dim
    evenly, it is taken again from its input gathered over the offending
    mesh dims: the strided ones, else the innermost that shards it. Where
    the local shard's strides admit no view (a kernel op's transposed
    output), it is taken from a contiguous copy, as `reshape` does."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    x = args[0]
    while True:
        try:
            out = func(x, *args[1:], **kwargs)
        except (RuntimeError, ValueError) as e:
            inner = [i for i, p in enumerate(x.placements)
                     if isinstance(p, Shard)][-1:]
            # DTensor's words for a view that cannot keep the shard:
            # "Cannot unflatten unevenly sharded tensor" (torch 2.13),
            # "Attempted to split the sharded dimension" (torch 2.11)
            if isinstance(e, RuntimeError) and "sharded" in str(e) and inner:
                x = _replicate_dims(x, inner)
            elif not x.to_local().is_contiguous():
                # DTensor.contiguous() looks at the global strides only
                x = _wrap(x.to_local().contiguous(), x.device_mesh,
                          x.placements, tuple(x.shape))
            else:
                raise
            continue
        strided = [i for i, p in enumerate(out.placements)
                   if isinstance(p, _StridedShard)]
        if not strided:
            return out
        x = _replicate_dims(x, strided)


def _reduce_partial(out):
    """An op's partial sums (a sharded contraction, a sum over a sharded
    dim, a vocab-parallel gather), all-reduced where they arise, as GSPMD
    reduces them; DTensor would carry the partials on and pick strategies
    that shard the sequence."""
    from torch.distributed.tensor import Partial, Replicate
    if not is_dtensor(out) or not any(isinstance(p, Partial)
                                      for p in out.placements):
        return out
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in out.placements)
    return out.redistribute(out.device_mesh, pl)


def _refused(e: Exception) -> bool:
    """Whether `e` is DTensor refusing to shard an op: no strategy
    registered (torch 2.13) or its sharding propagation failing (torch
    2.11 wraps the strategy's own error so, e.g. an index with a batch
    over two mesh dims). Running the op again on replicated inputs
    raises any error of the op itself."""
    msg = str(e)
    return (isinstance(e, NotImplementedError) and "sharding strategy" in msg
            ) or (isinstance(e, RuntimeError)
                  and "Sharding propagation failed" in msg)


class ShardedExec(TorchDispatchMode):
    """The dispatch mode a step on DTensors runs under (GSPMD's choices
    where DTensor's differ): a split along a sharded dim takes its input
    gathered along that dim; a view that would leave a strided or uneven
    shard takes its input gathered (`_view`); partial sums are reduced
    where they arise (`_reduce_partial`); an op DTensor refuses to shard
    (`_refused`) runs on replicated inputs, is counted in `fallbacks` and
    passed to `on_fallback(op_name)` (an in-place one only where its
    target is replicated already). Any other error propagates."""

    def __init__(self, on_fallback: Optional[Callable[[str], None]] = None):
        super().__init__()
        self.fallbacks: Dict[str, int] = collections.Counter()
        self.on_fallback = on_fallback

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dts = [a for a in tree_flatten((args, kwargs))[0] if is_dtensor(a)]
        if not dts:
            return func(*args, **kwargs)
        if func in _SPLITS and is_dtensor(args[0]):
            args = (_gather_dim(args[0], args[2] if len(args) > 2
                                else kwargs.get("dim", 0)),) + args[1:]
        if func in _VIEWS and is_dtensor(args[0]):
            out = _view(func, args, kwargs)
        else:
            try:
                out = func(*args, **kwargs)
            except (NotImplementedError, RuntimeError) as e:
                if not _refused(e):
                    raise
                out = self._replicated(func, args, kwargs,
                                       dts[0].device_mesh)
        if not _inplace(func):
            out = tree_map(_reduce_partial, out)
        return out

    def _replicated(self, func, args, kwargs, mesh):
        from torch.distributed.tensor import DTensor, Replicate
        if _inplace(func) and is_dtensor(args[0]) and any(
                not isinstance(p, Replicate) for p in args[0].placements):
            raise NotImplementedError(
                f"DTensor refuses to shard {func}, which writes a sharded "
                f"tensor ({args[0].placements}) in place")
        name = str(func)
        self.fallbacks[name] += 1
        if self.on_fallback is not None:
            self.on_fallback(name)
        rep = [Replicate()] * mesh.ndim

        def loc(x):
            if is_dtensor(x):
                return x.redistribute(mesh, rep).to_local()
            return x

        out = func(*tree_map(loc, args), **tree_map(loc, kwargs))

        def wrap(x):
            if isinstance(x, torch.Tensor) and not is_dtensor(x):
                return DTensor.from_local(x, mesh, rep, run_check=False)
            return x
        return tree_map(wrap, out)
