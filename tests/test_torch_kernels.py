"""The port's kernel packages on the CPU: each plain PyTorch version against
the JAX oracle and the JAX Pallas kernel (interpret mode), on the shapes of
`tests/test_kernels.py`. Inputs are drawn with numpy from a seed and fed to
both frameworks. The CUDA kernels themselves run only on the card
(`python3 chip_smoke.py` holds each one against these plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill.kernel import flash_prefill as jx_flash
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jx_flash_ref
from repro.kernels.paged_decode.kernel import (paged_decode as jx_decode,
                                               paged_insert as jx_insert)
from repro.kernels.paged_decode.ref import (paged_decode_ref as jx_decode_ref,
                                            paged_insert_ref as jx_insert_ref)
from repro.kernels.prefix_prefill.kernel import prefix_prefill as jx_prefix
from repro.kernels.prefix_prefill.ref import \
    prefix_prefill_ref as jx_prefix_ref
from repro.models import attention as jx_attn
from repro_torch import kernels as tk
from repro_torch.kernels.build import (KernelError, bhs_strides,
                                      head_dim_instance)
from repro_torch.kernels.flash_prefill import kernel as flash_kernel
from repro_torch.kernels.flash_prefill.ops import flash_prefill_op
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.paged_decode import kernel as decode_kernel
from repro_torch.kernels.paged_decode.ops import (paged_decode_op,
                                                  paged_insert_op)
from repro_torch.kernels.paged_decode.ref import (paged_decode_ref,
                                                  paged_insert_ref)
from repro_torch.kernels.prefix_prefill import kernel as prefix_kernel
from repro_torch.kernels.prefix_prefill.ops import prefix_prefill_op
from repro_torch.kernels.prefix_prefill.ref import prefix_prefill_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.models import attention as tx_attn

# tests/test_kernels.py:16-17
TOLS = {"float32": dict(atol=5e-5, rtol=5e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a torch tensor of `dtype`
    (both round f32 -> bf16 to nearest even)."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(np.array(a)).to(TDT[dtype]))


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOLS[dtype])


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, Sq, Skv, hd, causal, window)
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 1, 96, 256, 64, True, 0),
    (2, 4, 4, 128, 128, 128, False, 0),
    (1, 4, 2, 256, 256, 64, True, 64),
    (1, 2, 2, 64, 64, 32, True, 0),
])
def test_flash_prefill_plain_matches_jax(shape, dtype):
    B, H, Hkv, Sq, Skv, hd, causal, window = shape
    rng = np.random.default_rng(0)
    jq, tq = _pair(_normal(rng, B, H, Sq, hd), dtype)
    jk, tk_ = _pair(_normal(rng, B, Hkv, Skv, hd), dtype)
    jv, tv = _pair(_normal(rng, B, Hkv, Skv, hd), dtype)
    out = flash_prefill_ref(tq, tk_, tv, causal=causal, window=window)
    _close(out, jx_flash_ref(jq, jk, jv, causal=causal, window=window), dtype)
    _close(out, jx_flash(jq, jk, jv, causal=causal, window=window,
                         block_q=64, block_kv=64, interpret=True), dtype)


@pytest.mark.parametrize("shape", [
    # (B, Sq, Skv, H, Hkv, hd, window, softcap, block)
    (2, 48, 48, 4, 2, 16, 0, 0.0, 16),
    (1, 32, 80, 4, 1, 16, 0, 0.0, 32),     # offset mask: Sq < Skv
    (1, 64, 64, 4, 2, 16, 8, 0.0, 16),     # sliding window
    (1, 40, 40, 2, 2, 32, 0, 30.0, 16),    # soft cap
])
def test_flash_plain_matches_model_flash_reference(shape):
    """The JAX model's prefill runs `models/attention.py::flash_reference`;
    the port's `flash_prefill` plain version (and the port's own copy of
    that blocked reference) must match it."""
    B, Sq, Skv, H, Hkv, hd, window, cap, blk = shape
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, B, Sq, H, hd), _normal(rng, B, Skv, Hkv, hd),
               _normal(rng, B, Skv, Hkv, hd))
    want = jx_attn.flash_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, block_q=blk, block_kv=blk,
                                   logit_softcap=cap)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_prefill_op(tq, tk_, tv, causal=True, window=window,
                           softcap=cap)
    _close(got, want, "float32")
    own = tx_attn.flash_reference(tq, tk_, tv, causal=True, window=window,
                                  block_q=blk, block_kv=blk,
                                  logit_softcap=cap)
    _close(own, want, "float32")
    dense = jx_attn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window, logit_softcap=cap)
    _close(tx_attn.dense_attention(tq, tk_, tv, causal=True, window=window,
                                   logit_softcap=cap), dense, "float32")


def test_flash_reference_prefix_len_masks_padding():
    """`prefix_len` masks the padded tail of a gathered prefix."""
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, 1, 16, 4, 16), _normal(rng, 1, 48, 2, 16),
               _normal(rng, 1, 48, 2, 16))
    want = jx_attn.flash_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=16, block_kv=16,
                                   prefix_len=20)
    got = tx_attn.flash_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                  block_q=16, block_kv=16, prefix_len=20)
    _close(got, want, "float32")


def _decode_inputs(shape, dtype, seed=0, lens=None):
    B, H, Hkv, hd, pages, page, pps = shape
    rng = np.random.default_rng(seed)
    q = _normal(rng, B, H, hd)
    kp = _normal(rng, pages, page, Hkv, hd)
    vp = _normal(rng, pages, page, Hkv, hd)
    table = rng.permutation(pages)[:B * pps].reshape(B, pps).astype(np.int32)
    if lens is None:
        lens = [1 + (11 * i + 7) % (pps * page) for i in range(B)]
    lens = np.asarray(lens, np.int32)
    j = [_pair(x, dtype)[0] for x in (q, kp, vp)] + [jnp.asarray(table),
                                                      jnp.asarray(lens)]
    t = [_pair(x, dtype)[1] for x in (q, kp, vp)] + [torch.from_numpy(table),
                                                      torch.from_numpy(lens)]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, hd, num_pages, page, pages_per_seq)
    (2, 8, 2, 64, 16, 16, 4),
    (3, 4, 4, 128, 32, 8, 8),
    (1, 16, 1, 64, 8, 32, 2),
])
def test_paged_decode_plain_matches_jax(shape, dtype):
    j, t = _decode_inputs(shape, dtype)
    out = paged_decode_ref(*t)
    _close(out, jx_decode_ref(*j), dtype)
    _close(out, jx_decode(*j, interpret=True), dtype)
    # the public op routes CPU tensors to the plain version
    assert torch.equal(paged_decode_op(*t), out)


def test_paged_decode_full_page_boundary():
    """lens exactly on page boundaries (sequential table)."""
    shape = (2, 4, 2, 64, 8, 16, 3)
    j, t = _decode_inputs(shape, "float32", seed=1, lens=[16, 48])
    tab = np.arange(6, dtype=np.int32).reshape(2, 3)
    j[3], t[3] = jnp.asarray(tab), torch.from_numpy(tab)
    out = paged_decode_op(*t)
    _close(out, jx_decode_ref(*j), "float32")
    _close(out, jx_decode(*j, interpret=True), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 2, 64, 16, 16, 4),
                                   (3, 4, 4, 128, 32, 8, 8)])
def test_paged_decode_dbuf_parity(shape, dtype):
    """`dbuf=True` passes through the port's op (same kernel, same plain
    version) and matches the JAX double-buffered kernel."""
    j, t = _decode_inputs(shape, dtype, seed=5)
    out = paged_decode_op(*t, dbuf=True)
    _close(out, jx_decode(*j, dbuf=True, interpret=True), dtype)
    assert torch.equal(out, paged_decode_op(*t, dbuf=False))


def _prefix_inputs(shape, dtype, seed=0, table=None, plens=None,
                   slens=None):
    B, H, Hkv, Sq, hd, pages, page, npp = shape
    rng = np.random.default_rng(seed)
    arrs = [_normal(rng, B, H, Sq, hd), _normal(rng, B, Hkv, Sq, hd),
            _normal(rng, B, Hkv, Sq, hd), _normal(rng, pages, page, Hkv, hd),
            _normal(rng, pages, page, Hkv, hd)]
    if table is None:
        table = rng.permutation(pages)[:B * npp].reshape(B, npp)
    if plens is None:
        plens = [1 + (7 * i + 5) % (npp * page) for i in range(B)]
    ints = [np.asarray(table, np.int32), np.asarray(plens, np.int32)]
    if slens is not None:
        ints.append(np.asarray(slens, np.int32))
    j = [_pair(a, dtype)[0] for a in arrs] + [jnp.asarray(x) for x in ints]
    t = [_pair(a, dtype)[1] for a in arrs] + [torch.from_numpy(x)
                                              for x in ints]
    return j, t


def _model_layout(t):
    """The op takes (B, S, heads, hd): transpose q, k_suf, v_suf."""
    return [x.transpose(1, 2) for x in t[:3]] + t[3:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, Sq, hd, num_pages, page, npp)
    (2, 4, 2, 64, 64, 16, 16, 3),
    (1, 8, 1, 96, 64, 32, 8, 6),
    (2, 4, 4, 128, 128, 16, 16, 2),
    (1, 2, 2, 32, 32, 8, 32, 1),
])
def test_prefix_prefill_plain_matches_jax(shape, dtype):
    j, t = _prefix_inputs(shape, dtype)
    out = prefix_prefill_ref(*t)
    _close(out, jx_prefix_ref(*j), dtype)
    _close(out, jx_prefix(*j, block_q=32, block_kv=32, interpret=True), dtype)
    op = prefix_prefill_op(*_model_layout(t)).transpose(1, 2)
    assert torch.equal(op, out)


def _ragged_case(dtype="float32", seed=2):
    shape = (2, 4, 2, 48, 64, 12, 8, 4)
    table = np.arange(8).reshape(2, 4)
    table[1, 2:] = 0                       # trash-padded slots past plen
    return _prefix_inputs(shape, dtype, seed=seed, table=table,
                          plens=[32, 16], slens=[48, 39])


def test_prefix_prefill_ragged_suffix_and_full_pages():
    """suffix_lens masking, prefix_lens on page boundaries, and a
    trash-padded table slot beyond the live prefix."""
    j, t = _ragged_case()
    out = prefix_prefill_op(*_model_layout(t)).transpose(1, 2)
    _close(out, jx_prefix_ref(*j), "float32")
    _close(out, jx_prefix(*j, block_q=16, block_kv=16, interpret=True),
           "float32")


def test_prefix_prefill_dbuf_parity():
    """`dbuf=True` passes through the port's op and matches the JAX
    double-buffered kernel."""
    j, t = _ragged_case(seed=6)
    out = prefix_prefill_op(*_model_layout(t), dbuf=True).transpose(1, 2)
    _close(out, jx_prefix(*j, block_q=16, block_kv=16, dbuf=True,
                          interpret=True), "float32")


def test_prefix_prefill_matches_flash_with_dense_prefix():
    """Cross-oracle: attention over pool pages == flash attention over the
    dense [prefix ++ suffix] with the offset causal mask."""
    rng = np.random.default_rng(3)
    B, H, Hkv, Sq, hd, page, npp = 1, 4, 2, 32, 64, 8, 3
    P = npp * page
    q, k, v = (torch.from_numpy(_normal(rng, B, H, Sq, hd)),
               torch.from_numpy(_normal(rng, B, Hkv, Sq, hd)),
               torch.from_numpy(_normal(rng, B, Hkv, Sq, hd)))
    kp = torch.from_numpy(_normal(rng, npp, page, Hkv, hd))
    vp = torch.from_numpy(_normal(rng, npp, page, Hkv, hd))
    table = torch.arange(npp, dtype=torch.int32)[None]
    out = prefix_prefill_ref(q, k, v, kp, vp, table,
                             torch.tensor([P], dtype=torch.int32))
    kd = torch.cat([kp.reshape(1, P, Hkv, hd).transpose(1, 2), k], dim=2)
    vd = torch.cat([vp.reshape(1, P, Hkv, hd).transpose(1, 2), v], dim=2)
    want = flash_prefill_ref(q, kd, vd, causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=5e-5,
                               rtol=5e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_insert_parity(dtype):
    """The in-place insert == the JAX scatter oracle and the JAX kernel,
    byte for byte; untouched pages keep their bits."""
    B, Hkv, hd, pages, page = 4, 2, 64, 8, 16
    rng = np.random.default_rng(4)
    jkp, tkp = _pair(_normal(rng, pages, page, Hkv, hd), dtype)
    jvp, tvp = _pair(_normal(rng, pages, page, Hkv, hd), dtype)
    kn, vn = _normal(rng, B, Hkv, hd), _normal(rng, B, Hkv, hd)
    pidx = np.array([3, 1, 7, 5], np.int32)
    off = np.array([0, 7, 15, 3], np.int32)
    orig = tkp.clone()
    ok_, ov = paged_insert_op(tkp, tvp, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(pidx),
                              torch.from_numpy(off))
    assert ok_ is tkp and ov is tvp                      # in place
    args = (jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pidx),
            jnp.asarray(off))
    rk, rv = jx_insert_ref(jkp, jvp, *args)
    ik, iv = jx_insert(jkp, jvp, *args, interpret=True)
    for got, want in ((tkp, rk), (tvp, rv), (tkp, ik), (tvp, iv)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    untouched = [p for p in range(pages) if p not in set(pidx.tolist())]
    assert torch.equal(tkp[untouched], orig[untouched])


def test_paged_insert_duplicate_trash_targets_stay_in_trash():
    """Idle slots all write trash page 0: one of the rows wins, and no
    live page changes."""
    kp = torch.zeros(4, 8, 2, 16)
    vp = torch.zeros(4, 8, 2, 16)
    kn = torch.arange(3 * 2 * 16, dtype=torch.float32).reshape(3, 2, 16)
    pidx = torch.tensor([0, 0, 2], dtype=torch.int32)
    off = torch.tensor([5, 5, 1], dtype=torch.int32)
    paged_insert_ref(kp, vp, kn, kn + 1, pidx, off)
    assert any(torch.equal(kp[0, 5], kn[b]) for b in (0, 1))
    assert torch.equal(kp[2, 1], kn[2])
    assert kp[1].abs().sum() == 0 and kp[3].abs().sum() == 0


def test_cuda_launchers_refuse_cpu_tensors_without_counting():
    """A launch wrapper takes CUDA tensors only and raises on others
    (before any build); the public ops never count a CPU call."""
    tk.reset_launch_counts()
    q = torch.zeros(1, 4, 16)
    pool = torch.zeros(4, 8, 2, 16)
    tab = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_kernel.paged_decode(q, pool, pool, tab, lens)
    with pytest.raises(ValueError):
        decode_kernel.paged_insert(pool, pool, q[:, :2], q[:, :2], lens,
                                   lens)
    q4 = torch.zeros(1, 4, 16, 16)
    with pytest.raises(ValueError):
        flash_kernel.flash_prefill(q4, q4[:, :2], q4[:, :2])
    with pytest.raises(ValueError):
        flash_kernel.flash_prefill_bwd(q4, q4[:, :2], q4[:, :2], q4,
                                       torch.zeros(1, 4, 16), q4)
    with pytest.raises(ValueError):
        prefix_kernel.prefix_prefill(q4, q4[:, :2], q4[:, :2], pool, pool,
                                     tab, lens)
    x, dt, nh = torch.zeros(1, 16, 2, 16), torch.zeros(1, 16, 2), 2
    bc, a = torch.zeros(1, 16, 1, 16), torch.zeros(nh)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan_bwd(x, dt, a, bc, bc, a, (), x, chunk=16)
    paged_decode_op(q, pool, pool, tab, lens)
    flash_prefill_op(q4, q4[:, :, :2], q4[:, :, :2])
    ssd_scan_op(x, dt, a, bc, bc, a, chunk=16)
    assert tk.launch_counts() == {"paged_decode": 0, "paged_insert": 0,
                                  "paged_insert_decode": 0,
                                  "prefix_prefill": 0, "flash_prefill": 0,
                                  "flash_prefill_bwd": 0, "ssd_scan": 0,
                                  "ssd_scan_bwd": 0}
    assert issubclass(KernelError, RuntimeError)


def test_kernel_strides_read_model_layout_views():
    """The kernels take (B, heads, S, hd) views of the model's (B, S,
    heads, hd) tensors through their strides, with no copy."""
    x = torch.zeros(2, 5, 4, 16)                       # (B, S, H, hd)
    view = x.transpose(1, 2)                          # (B, H, S, hd)
    assert list(bhs_strides(view)) == [5 * 4 * 16, 16, 4 * 16]
    out = torch.empty_like(view)
    assert out.stride() == view.stride()          # output keeps the layout
    with pytest.raises(ValueError):
        bhs_strides(x.transpose(2, 3))


def test_flash_heads_per_block_is_a_function_of_shapes():
    """The bf16 kernel serves two query heads of one kv head a block where
    the group size is even and the grid still has a block for 3/4 of the
    SMs; otherwise one (yi-6b: 32 heads over 4 kv heads). Head dims above
    128 (gemma3-1b's 256) always take one: two would not fit in shared
    memory."""
    hpb = flash_kernel.flash_heads_per_block
    assert hpb(1, 32, 4, 1024) == 2           # 16 pairs x 16 q tiles
    assert hpb(1, 32, 4, 512) == 2            # 16 x 8 = 128 blocks
    assert hpb(1, 32, 4, 200) == 1            # 16 x 4 = 64 blocks
    assert hpb(2, 32, 4, 200) == 2
    assert hpb(8, 6, 2, 1024) == 1            # a group of 3
    assert hpb(1, 32, 4, 512, sm_count=200) == 1
    assert hpb(8, 32, 4, 1024, hd=112) == 2   # the 128 instance
    assert hpb(8, 8, 2, 1024, hd=256) == 1


def test_bwd_warpgroups_is_a_function_of_shapes():
    """The bf16 backward's dK/dV kernel takes two consumer warpgroups
    where a block's walk has at least two (query head, 64-row q tile)
    items, one otherwise (seamless-m4t's cross-attention: 64 queries, a
    group of 1); its dQ kernel serves query heads as the forward does.
    Head dims above 128 run the mma.sync kernels, which take neither."""
    bw = flash_kernel.bwd_warpgroups
    assert bw(4, 32, 4, 1024) == (2, 2)       # yi-6b training
    assert bw(1, 16, 16, 1024, 64) == (2, 1)  # seamless encoder
    assert bw(1, 16, 16, 64, 64) == (1, 1)    # seamless cross
    assert bw(1, 32, 32, 1024, 112) == (2, 1)  # zamba2-7b (hd 112)
    assert bw(1, 16, 16, 65, 64) == (2, 1)    # two q tiles
    assert bw(1, 8, 4, 64, 128) == (2, 1)     # a group of 2, 4 blocks
    assert bw(1, 4, 1, 1024, 256) == (1, 1)   # gemma3-1b
    assert bw(4, 32, 4, 1024, sm_count=2000) == (2, 1)


def test_bwd_dq_split_is_a_function_of_shapes():
    """The bf16 dQ kernel cuts each q tile's kv walk where its grid fills
    less than half the SMs, into as many parts as fill the card, each at
    least two 64-key tiles: seamless-m4t's cross-attention (64 queries,
    16 heads, 1024 frames) 8 ways, the training shapes not at all."""
    sp = flash_kernel.bwd_dq_split
    assert sp(1, 16, 64, 1024, 1) == 8         # seamless cross
    assert sp(4, 32, 1024, 1024, 2) == 1       # yi-6b training
    assert sp(1, 16, 1024, 1024, 1) == 1       # seamless encoder
    assert sp(1, 32, 1024, 1024, 1) == 1       # zamba2-7b
    assert sp(1, 4, 70, 200, 1) == 2           # 8 blocks, 4 kv tiles
    assert sp(1, 4, 64, 100, 1) == 1           # 2 kv tiles: one part
    assert sp(1, 16, 64, 1024, 1, hd=256) == 1  # the mma.sync instance
    assert sp(1, 16, 64, 1024, 1, sm_count=64) == 4


def test_bhs_strides_of_size_one_dims_are_16_byte_units():
    """A tensor map wants every stride in 16-byte units; PyTorch leaves
    the stride of a dim of size 1 free, so it is replaced by one that
    qualifies (never stepped over)."""
    x = torch.zeros(1, 7, 1, 64)[:, :, :, :].transpose(1, 2)  # (1, 1, 7, 64)
    st = list(bhs_strides(x))
    assert st[2] == x.stride(2)
    assert all(s * 2 % 16 == 0 for s in st)


@pytest.mark.parametrize("hd,instance", [(16, 16), (32, 32), (48, 64),
                                         (64, 64), (112, 128), (128, 128),
                                         (144, 256), (256, 256)])
def test_head_dim_instance_is_the_next_one_up(hd, instance):
    """Any multiple of 16 up to 256 runs on the smallest compiled instance
    that holds it (the kernels zero-fill and mask the columns between)."""
    assert head_dim_instance("op", hd) == instance


@pytest.mark.parametrize("hd", [0, 8, 120, 272, 512])
def test_head_dim_instance_refuses_other_head_dims(hd):
    with pytest.raises(ValueError, match="head dim"):
        head_dim_instance("op", hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [112, 256])
def test_plain_versions_match_jax_at_wide_head_dims(hd, dtype):
    """zamba2-7b's hd 112 and gemma3-1b's hd 256: the plain versions the
    kernels are held against match the JAX oracles (flash_prefill under a
    window, paged_decode over a GQA group of 4, prefix_prefill)."""
    rng = np.random.default_rng(hd)
    jq, tq = _pair(_normal(rng, 1, 4, 40, hd), dtype)
    jk, tk_ = _pair(_normal(rng, 1, 1, 40, hd), dtype)
    jv, tv = _pair(_normal(rng, 1, 1, 40, hd), dtype)
    _close(flash_prefill_ref(tq, tk_, tv, causal=True, window=16),
           jx_flash_ref(jq, jk, jv, causal=True, window=16), dtype)
    j, t = _decode_inputs((3, 4, 1, hd, 12, 8, 4), dtype, seed=hd)
    _close(paged_decode_ref(*t), jx_decode_ref(*j), dtype)
    j, t = _prefix_inputs((1, 4, 1, 24, hd, 8, 8, 3), dtype, seed=hd)
    _close(prefix_prefill_ref(*t), jx_prefix_ref(*j), dtype)
