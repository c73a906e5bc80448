"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit and skip without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; `tests/conftest.py` imports JAX, so run it as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The shapes are those of the JAX package's kernel sweeps
(`tests/test_kernels.py`), plus the model's (B, S, H, hd) views. Tolerances
are those of `tests/test_kernels.py:16-17`; the SSD scan's f32 tolerance is
that of its JAX sweep (`tests/test_kernels.py:237`, 3e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels.flash_prefill.ops import flash_prefill_op
from repro_torch.kernels.build import HD_INSTANCES
from repro_torch.kernels.paged_decode.ops import (paged_decode_op,
                                                  paged_insert_decode_op,
                                                  paged_insert_op)
from repro_torch.kernels.paged_decode.kernel import decode_split
from repro_torch.kernels.paged_decode.ref import (insert_at_lens,
                                                  paged_decode_ref,
                                                  paged_decode_split_ref,
                                                  paged_insert_decode_ref,
                                                  paged_insert_ref)
from repro_torch.kernels.prefix_prefill.ops import prefix_prefill_op
from repro_torch.kernels.prefix_prefill.ref import prefix_prefill_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op

TOLS = {torch.float32: dict(atol=5e-5, rtol=5e-5),
        torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    """The card, or a skip: decided per test, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, dev, dtype, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev).to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, Sq, Skv, hd, causal, window, softcap)
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 1, 96, 256, 64, True, 0, 0.0),
    (2, 4, 4, 128, 128, 128, False, 0, 0.0),
    (1, 4, 2, 256, 256, 64, True, 64, 0.0),
    (1, 2, 2, 64, 64, 32, True, 0, 0.0),
    (1, 4, 2, 70, 70, 16, True, 0, 30.0),
])
def test_flash_prefill_kernel(cuda, shape, dtype):
    B, H, Hkv, Sq, Skv, hd, causal, window, cap = shape
    rng = np.random.default_rng(0)
    q = _t(rng, cuda, dtype, B, Sq, H, hd)          # model layout
    k = _t(rng, cuda, dtype, B, Skv, Hkv, hd)
    v = _t(rng, cuda, dtype, B, Skv, Hkv, hd)
    before = tk.launch_counts()["flash_prefill"]
    got = flash_prefill_op(q, k, v, causal=causal, window=window,
                           softcap=cap)
    assert tk.launch_counts()["flash_prefill"] == before + 1
    want = flash_prefill_op(q, k, v, causal=causal, window=window,
                            softcap=cap, plain=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [512, 1024, 200])
def test_flash_prefill_kernel_yi6b_width(cuda, S, dtype, monkeypatch):
    """yi-6b heads (H=32, Hkv=4, hd 128) at the serve phase's from-scratch
    prefill lengths and the PERF shape, in the model's layout; in bf16
    with one and with two query heads a block; two identical calls give
    identical bits."""
    from repro_torch.kernels.flash_prefill import kernel as fk
    rng = np.random.default_rng(12)
    q = _t(rng, cuda, dtype, 1, S, 32, 128).transpose(1, 2)
    k = _t(rng, cuda, dtype, 1, S, 4, 128).transpose(1, 2)
    v = _t(rng, cuda, dtype, 1, S, 4, 128).transpose(1, 2)
    want = flash_prefill_op(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), plain=True).transpose(1, 2)
    for qh in ((1, 2) if dtype == torch.bfloat16 else (1,)):
        monkeypatch.setattr(fk, "flash_heads_per_block",
                            lambda *shape, qh=qh, **_: qh)
        got = fk.flash_prefill(q, k, v)
        again = fk.flash_prefill(q, k, v)
        _close(got, want, dtype)
        assert torch.equal(got, again)


@pytest.mark.parametrize("case", [
    # (B, H, Hkv, Sq, Skv, hd, window, softcap)
    (1, 8, 2, 300, 300, 128, 100, 20.0),      # window + soft cap, hd 128
    (2, 8, 2, 190, 190, 64, 64, 30.0),        # window + soft cap, hd 64
    (1, 6, 2, 100, 357, 128, 0, 0.0),         # Sq < Skv; H/Hkv = 3
    (2, 3, 1, 129, 129, 64, 0, 0.0),          # odd group, ragged S
    (1, 4, 4, 65, 65, 32, 0, 5.0),            # MHA, hd 32, one extra row
])
def test_flash_prefill_kernel_bf16_edges(cuda, case, monkeypatch):
    """The wgmma kernel's edges in bf16: the window's lower edge and the
    soft cap at hd 64 and 128, the offset mask of Sq < Skv, groups of odd
    size (one query head a block), S not a multiple of 64; with two heads
    a block wherever the group allows."""
    from repro_torch.kernels.flash_prefill import kernel as fk
    B, H, Hkv, Sq, Skv, hd, window, cap = case
    dt = torch.bfloat16
    rng = np.random.default_rng(13)
    q = _t(rng, cuda, dt, B, Sq, H, hd).transpose(1, 2)
    k = _t(rng, cuda, dt, B, Skv, Hkv, hd).transpose(1, 2)
    v = _t(rng, cuda, dt, B, Skv, Hkv, hd).transpose(1, 2)
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    want = flash_prefill_ref(q, k, v, causal=True, window=window,
                             softcap=cap)
    for qh in ((1, 2) if (H // Hkv) % 2 == 0 else (1,)):
        monkeypatch.setattr(fk, "flash_heads_per_block",
                            lambda *shape, qh=qh, **_: qh)
        got = fk.flash_prefill(q, k, v, causal=True, window=window,
                               softcap=cap)
        _close(got, want, dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, hd, num_pages, page, pages_per_seq)
    (2, 8, 2, 64, 16, 16, 4),
    (3, 4, 4, 128, 32, 8, 8),
    (1, 16, 1, 64, 8, 32, 2),
    (8, 32, 4, 128, 520, 16, 64),                   # yi-6b, context 1024
])
def test_paged_decode_kernel(cuda, shape, dtype):
    B, H, Hkv, hd, pages, page, pps = shape
    rng = np.random.default_rng(1)
    q = _t(rng, cuda, dtype, B, H, hd)
    kp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    vp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    table = torch.from_numpy(rng.permutation(pages)[:B * pps]
                             .reshape(B, pps).astype(np.int32)).to(cuda)
    lens = torch.tensor([1 + (11 * i + 7) % (pps * page) for i in range(B)],
                        dtype=torch.int32, device=cuda)
    lens[0] = pps * page                               # a full table
    got = paged_decode_op(q, kp, vp, table, lens)
    _close(got, paged_decode_ref(q, kp, vp, table, lens), dtype)
    _close(paged_decode_op(q, kp, vp, table, lens, dbuf=True), got, dtype)


def _serve_decode_inputs(rng, dev, dtype, B, lens, pps=128, page=16):
    """yi-6b decode at the serve phase's shapes: H=32, Hkv=4, hd 128, a
    table of `pps` pages of `page`; slots past each live length point at
    the trash page 0 (filled with large values), as the engine leaves
    them."""
    H, Hkv, hd = 32, 4, 128
    pages = 1 + B * pps
    q = _t(rng, dev, dtype, B, H, hd)
    kp = _t(rng, dev, dtype, pages, page, Hkv, hd)
    vp = _t(rng, dev, dtype, pages, page, Hkv, hd)
    kp[0], vp[0] = 50.0, -50.0
    table = (1 + rng.permutation(B * pps)).reshape(B, pps).astype(np.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // page):] = 0
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


DECODE_SERVE_CASES = {
    # B=8 as the serve phase's decode batch, lengths up to 1532
    "serve_b8": [1532, 1100, 903, 640, 517, 300, 200, 33],
    "b1_ctx1500": [1500],
    # splits of 8 pages (128 rows): most splits of most rows are empty
    "empty_splits": [1, 17, 128, 129, 0, 255, 1532, 2],
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(DECODE_SERVE_CASES))
def test_paged_decode_kernel_serve_shapes(cuda, case, dtype):
    """The split kernel at the serve path's shapes against the one-pass
    plain version and the split-and-merge plain version; two identical
    calls give identical bits (no atomics); lens = 0 gives 0."""
    lens = DECODE_SERVE_CASES[case]
    args = _serve_decode_inputs(np.random.default_rng(7), cuda, dtype,
                                len(lens), lens)
    before = tk.launch_counts()["paged_decode"]
    got = paged_decode_op(*args)
    again = paged_decode_op(*args)
    assert tk.launch_counts()["paged_decode"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    live = [b for b, n in enumerate(lens) if n > 0]
    _close(got[live], paged_decode_ref(*args)[live], dtype)
    per, _ = decode_split(len(lens), 4, 128, 16,
                          torch.cuda.get_device_properties(cuda)
                          .multi_processor_count)
    _close(got, paged_decode_split_ref(*args, split_pages=per), dtype)
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.count_nonzero(got[b]) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_softcap_and_groups(cuda, dtype):
    """Soft cap, and query-head groups of 1, 4 and 16 (the kernel's
    largest)."""
    rng = np.random.default_rng(8)
    for H, Hkv in ((8, 8), (16, 4), (32, 2)):
        B, hd, pages, page, pps = 3, 64, 40, 16, 12
        q = _t(rng, cuda, dtype, B, H, hd)
        kp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
        vp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
        table = torch.from_numpy(rng.permutation(pages)[:B * pps]
                                 .reshape(B, pps).astype(np.int32)).to(cuda)
        lens = torch.tensor([190, 7, 100], dtype=torch.int32, device=cuda)
        got = paged_decode_op(q, kp, vp, table, lens, softcap=3.0)
        _close(got, paged_decode_ref(q, kp, vp, table, lens, softcap=3.0),
               dtype)


def test_paged_decode_kernel_refuses_large_groups(cuda):
    """A group of 32 query heads, above the split kernel's 16, no longer
    raises: it runs as two launches of 16 heads (one call of the op) and
    equals the plain version; H not a multiple of Hkv still raises."""
    rng = np.random.default_rng(9)
    q = _t(rng, cuda, torch.float32, 1, 32, 64)
    kp = _t(rng, cuda, torch.float32, 4, 16, 1, 64)
    vp = _t(rng, cuda, torch.float32, 4, 16, 1, 64)
    tab = torch.tensor([[1, 3]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([21], dtype=torch.int32, device=cuda)
    before = tk.launch_counts()["paged_decode"]
    got = paged_decode_op(q, kp, vp, tab, lens)
    assert tk.launch_counts()["paged_decode"] == before + 1
    _close(got, paged_decode_ref(q, kp, vp, tab, lens), torch.float32)
    pool4 = torch.zeros(4, 16, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        paged_decode_op(q[:, :30].contiguous(), pool4, pool4, tab, lens)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,P", [(512, 1024), (512, 384)])
def test_prefix_prefill_kernel_serve_shapes(cuda, Sq, P, dtype):
    """A 512-token chunk over a 1024- and a 384-token prefix, yi-6b heads
    (H=32, Hkv=4, hd 128), in the model's layout."""
    rng = np.random.default_rng(9)
    H, Hkv, hd, page = 32, 4, 128, 16
    npp = P // page
    q = _t(rng, cuda, dtype, 1, Sq, H, hd)
    k = _t(rng, cuda, dtype, 1, Sq, Hkv, hd)
    v = _t(rng, cuda, dtype, 1, Sq, Hkv, hd)
    kp = _t(rng, cuda, dtype, npp + 1, page, Hkv, hd)
    vp = _t(rng, cuda, dtype, npp + 1, page, Hkv, hd)
    table = torch.from_numpy((1 + rng.permutation(npp))[None]
                             .astype(np.int32)).to(cuda)
    plens = torch.tensor([P], dtype=torch.int32, device=cuda)
    args = (q, k, v, kp, vp, table, plens)
    before = tk.launch_counts()["prefix_prefill"]
    got = prefix_prefill_op(*args)
    assert tk.launch_counts()["prefix_prefill"] == before + 1
    _close(got, prefix_prefill_op(*args, plain=True), dtype)


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_prefix_prefill_kernel_ragged_suffix_and_trash_slots_bf16(cuda,
                                                                  softcap):
    """The ragged case of the f32 test below in bf16 on the tensor-core
    tile, at hd 128 and hd 64, with and without the soft cap."""
    rng = np.random.default_rng(10)
    for hd in (128, 64):
        B, H, Hkv, Sq, page, npp = 2, 4, 2, 100, 8, 12
        dt = torch.bfloat16
        q = _t(rng, cuda, dt, B, H, Sq, hd)
        k = _t(rng, cuda, dt, B, Hkv, Sq, hd)
        v = _t(rng, cuda, dt, B, Hkv, Sq, hd)
        kp = _t(rng, cuda, dt, 30, page, Hkv, hd)
        vp = _t(rng, cuda, dt, 30, page, Hkv, hd)
        kp[0], vp[0] = 50.0, -50.0
        table = torch.arange(1, 25, dtype=torch.int32,
                             device=cuda).reshape(2, 12)
        table[1, 9:] = 0                     # trash past the live prefix
        plens = torch.tensor([96, 67], dtype=torch.int32, device=cuda)
        slens = torch.tensor([100, 71], dtype=torch.int32, device=cuda)
        from repro_torch.kernels.prefix_prefill.kernel import prefix_prefill
        got = prefix_prefill(q, k, v, kp, vp, table, plens, slens,
                             softcap=softcap)
        _close(got, prefix_prefill_ref(q, k, v, kp, vp, table, plens, slens,
                                       softcap=softcap), dt)


def test_prefix_prefill_kernel_refuses_misaligned_views(cuda):
    """16-byte vector copies: a view that starts off 16 bytes, or rows that
    are not whole 16-byte chunks apart, raise (no scalar path)."""
    from repro_torch.kernels.prefix_prefill.kernel import prefix_prefill
    rng = np.random.default_rng(11)
    dt = torch.bfloat16
    big = _t(rng, cuda, dt, 1, 2, 33, 64)
    q = big[:, :, 1:]                        # starts 128 bytes in: fine
    k = _t(rng, cuda, dt, 1, 1, 32, 64)
    pool = _t(rng, cuda, dt, 4, 8, 1, 64)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    plens = torch.tensor([16], dtype=torch.int32, device=cuda)
    prefix_prefill(q, k, k, pool, pool, table, plens)
    wide = _t(rng, cuda, dt, 1, 2, 32, 68)[..., 2:66]   # starts 4 bytes in
    with pytest.raises(ValueError):
        prefix_prefill(wide, k, k, pool, pool, table, plens)
    odd = _t(rng, cuda, dt, 1, 1, 32, 66)[..., :64]     # 132-byte rows
    with pytest.raises(ValueError):
        prefix_prefill(q, odd, odd, pool, pool, table, plens)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, Sq, hd, num_pages, page, npp)
    (2, 4, 2, 64, 64, 16, 16, 3),
    (1, 8, 1, 96, 64, 32, 8, 6),
    (2, 4, 4, 128, 128, 16, 16, 2),
    (1, 2, 2, 32, 32, 8, 32, 1),
])
def test_prefix_prefill_kernel(cuda, shape, dtype):
    B, H, Hkv, Sq, hd, pages, page, npp = shape
    rng = np.random.default_rng(2)
    q = _t(rng, cuda, dtype, B, Sq, H, hd)          # model layout
    k = _t(rng, cuda, dtype, B, Sq, Hkv, hd)
    v = _t(rng, cuda, dtype, B, Sq, Hkv, hd)
    kp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    vp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    table = torch.from_numpy(rng.permutation(pages)[:B * npp]
                             .reshape(B, npp).astype(np.int32)).to(cuda)
    plens = torch.tensor([1 + (7 * i + 5) % (npp * page) for i in range(B)],
                         dtype=torch.int32, device=cuda)
    args = (q, k, v, kp, vp, table, plens)
    _close(prefix_prefill_op(*args), prefix_prefill_op(*args, plain=True),
           dtype)


def test_prefix_prefill_kernel_ragged_suffix_and_trash_slots(cuda):
    rng = np.random.default_rng(3)
    B, H, Hkv, Sq, hd, page, npp = 2, 4, 2, 48, 64, 8, 4
    q = _t(rng, cuda, torch.float32, B, H, Sq, hd)
    k = _t(rng, cuda, torch.float32, B, Hkv, Sq, hd)
    v = _t(rng, cuda, torch.float32, B, Hkv, Sq, hd)
    kp = _t(rng, cuda, torch.float32, 12, page, Hkv, hd)
    vp = _t(rng, cuda, torch.float32, 12, page, Hkv, hd)
    table = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    table[1, 2:] = 0
    plens = torch.tensor([32, 16], dtype=torch.int32, device=cuda)
    slens = torch.tensor([48, 39], dtype=torch.int32, device=cuda)
    from repro_torch.kernels.prefix_prefill.kernel import prefix_prefill
    got = prefix_prefill(q, k, v, kp, vp, table, plens, slens)
    _close(got, prefix_prefill_ref(q, k, v, kp, vp, table, plens, slens),
           torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_insert_kernel_is_byte_exact(cuda, dtype):
    rng = np.random.default_rng(4)
    B, Hkv, hd, pages, page = 4, 2, 64, 8, 16
    kp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    vp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    kn = _t(rng, cuda, torch.float32, B, Hkv, hd)   # cast like the JAX op
    vn = _t(rng, cuda, torch.float32, B, Hkv, hd)
    pidx = torch.tensor([3, 1, 7, 5], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 7, 15, 3], dtype=torch.int32, device=cuda)
    k2, v2 = kp.clone(), vp.clone()
    paged_insert_op(kp, vp, kn, vn, pidx, off)
    paged_insert_ref(k2, v2, kn, vn, pidx, off)
    torch.cuda.synchronize()
    assert torch.equal(kp, k2) and torch.equal(v2, vp)


def _insert_decode_inputs(rng, dev, dtype, B, H, Hkv, hd, page, pps, lens,
                          new_dtype=None):
    """q, new K/V rows, pools and a permuted table for the fused op; table
    slots past each live length point at trash page 0 (large values)."""
    pages = 1 + B * pps
    q = _t(rng, dev, dtype, B, H, hd)
    kn = _t(rng, dev, new_dtype or dtype, B, Hkv, hd)
    vn = _t(rng, dev, new_dtype or dtype, B, Hkv, hd)
    kp = _t(rng, dev, dtype, pages, page, Hkv, hd)
    vp = _t(rng, dev, dtype, pages, page, Hkv, hd)
    kp[0], vp[0] = 50.0, -50.0
    table = (1 + rng.permutation(B * pps)).reshape(B, pps).astype(np.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // page):] = 0
    return (q, kn, vn, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _insert_decode_check(args, dtype, live=None):
    """The fused kernel against its plain version on copies of the same
    pools: output within tolerance on live rows, pools byte-equal. Counts
    one launch of each op. Returns the kernel's output and pools."""
    q, kn, vn, kp, vp, table, lens = args
    kp2, vp2 = kp.clone(), vp.clone()
    before = tk.launch_counts()
    got = paged_insert_decode_op(q, kn, vn, kp, vp, table, lens)
    after = tk.launch_counts()
    assert after["paged_decode"] == before["paged_decode"] + 1
    assert after["paged_insert"] == before["paged_insert"] + 1
    want = paged_insert_decode_ref(q, kn, vn, kp2, vp2, table, lens)
    live = list(range(q.shape[0])) if live is None else live
    _close(got[live], want[live], dtype)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    return got, kp, vp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HD_INSTANCES + (48, 112))
def test_paged_insert_decode_kernel_head_dims(cuda, hd, dtype):
    """The fused kernel at every head dim instance and at two head dims
    below theirs (48 on the 64 instance, zamba2-7b's 112 on the 128 one),
    with splits of one page (many splits, most of them not the owner) and
    writes at row 0 of a page, mid page and the last row of a full
    table."""
    rng = np.random.default_rng(20 + hd)
    B, H, Hkv, page, pps = 4, 8, 2, 16, 6
    lens = [1, 17, 40, pps * page]
    _insert_decode_check(_insert_decode_inputs(
        rng, cuda, dtype, B, H, Hkv, hd, page, pps, lens), dtype)


@pytest.mark.parametrize("case", sorted(DECODE_SERVE_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_insert_decode_kernel_serve_shapes(cuda, dtype, case):
    """yi-6b widths at the serve phase's tables (lens = 0 writes nothing and
    gives 0); the output equals the decode-only kernel's over the pools
    the fused call left, bit for bit; two identical calls give identical
    bits on live rows; f32 new rows into bf16 pools."""
    lens = DECODE_SERVE_CASES[case]
    for new_dtype in ((None, torch.float32) if dtype == torch.bfloat16
                      else (None,)):
        args = _insert_decode_inputs(np.random.default_rng(21), cuda, dtype,
                                     len(lens), 32, 4, 128, 16, 128, lens,
                                     new_dtype)
        live = [b for b, n in enumerate(lens) if n > 0]
        got, kp, vp = _insert_decode_check(args, dtype, live)
        q, kn, vn, _, _, table, lens_t = args
        assert torch.equal(got, paged_decode_op(q, kp, vp, table, lens_t))
        again = paged_insert_decode_op(q, kn, vn, kp, vp, table, lens_t)
        torch.cuda.synchronize()
        assert torch.equal(got[live], again[live])
        for b, n in enumerate(lens):
            if n == 0:
                assert torch.count_nonzero(got[b]) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_insert_decode_kernel_attends_the_new_row(cuda, dtype):
    """Poison: the target rows hold a large finite K (and V) before the
    call, so a kernel that attended over the stale row instead of the new
    one would put most of the weight on it and fail by far."""
    rng = np.random.default_rng(22)
    lens = [33, 1, 128, 77, 16]
    q, kn, vn, kp, vp, table, lens_t = _insert_decode_inputs(
        rng, cuda, dtype, len(lens), 16, 4, 128, 16, 8, lens)
    poison_k = torch.full_like(kn, 200.0)
    insert_at_lens(kp, vp, poison_k, -poison_k, table, lens_t)
    stale = paged_decode_ref(q, kp, vp, table, lens_t)   # over the poison
    got, _, _ = _insert_decode_check((q, kn, vn, kp, vp, table, lens_t),
                                     dtype)
    assert (got.float() - stale.float()).abs().max() > 10.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, hd, page, pps, lens)
    (3, 4, 4, 64, 8, 8, [64, 9, 2]),
    (2, 32, 2, 128, 32, 3, [96, 33]),
    (5, 6, 2, 32, 16, 40, [640, 1, 301, 17, 32]),
])
def test_paged_insert_decode_kernel_groups_and_pages(cuda, shape, dtype):
    """Query-head groups of 1, 3 and 16, pages of 8..32 rows, softcap."""
    B, H, Hkv, hd, page, pps, lens = shape
    args = _insert_decode_inputs(np.random.default_rng(23), cuda, dtype, B,
                                 H, Hkv, hd, page, pps, lens)
    q, kn, vn, kp, vp, table, lens_t = args
    kp2, vp2 = kp.clone(), vp.clone()
    got = paged_insert_decode_op(q, kn, vn, kp, vp, table, lens_t,
                                 softcap=5.0)
    want = paged_insert_decode_ref(q, kn, vn, kp2, vp2, table, lens_t,
                                   softcap=5.0)
    _close(got, want, dtype)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)


# ---------------------------------------------------------------------------
# head dims 112 (zamba2-7b) and 256 (gemma3-1b): any multiple of 16 up to
# 256 runs on the next instance up, its padding columns zero-filled
# ---------------------------------------------------------------------------
WIDE_HDS = [112, 256]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("shape", [
    # (B, H, Hkv, Sq, Skv, causal, window, softcap)
    (1, 4, 1, 300, 300, True, 128, 0.0),      # gemma3-1b heads, a window
    (2, 4, 4, 130, 130, True, 0, 20.0),       # MHA, soft cap, ragged S
    (1, 4, 2, 70, 200, True, 0, 0.0),         # Sq < Skv
])
def test_flash_prefill_kernel_wide_head_dims(cuda, shape, hd, dtype,
                                             monkeypatch):
    """flash_prefill at hd 112 and 256 in the model's layout; in bf16 with
    one and (hd 112, even groups) two query heads a block."""
    from repro_torch.kernels.flash_prefill import kernel as fk
    B, H, Hkv, Sq, Skv, causal, window, cap = shape
    rng = np.random.default_rng(30 + hd)
    q = _t(rng, cuda, dtype, B, Sq, H, hd)
    k = _t(rng, cuda, dtype, B, Skv, Hkv, hd)
    v = _t(rng, cuda, dtype, B, Skv, Hkv, hd)
    want = flash_prefill_op(q, k, v, causal=causal, window=window,
                            softcap=cap, plain=True)
    two = dtype == torch.bfloat16 and hd <= 128 and (H // Hkv) % 2 == 0
    for qh in ((1, 2) if two else (1,)):
        monkeypatch.setattr(fk, "flash_heads_per_block",
                            lambda *shape, qh=qh, **_: qh)
        before = tk.launch_counts()["flash_prefill"]
        got = flash_prefill_op(q, k, v, causal=causal, window=window,
                               softcap=cap)
        assert tk.launch_counts()["flash_prefill"] == before + 1
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", WIDE_HDS)
def test_prefix_prefill_kernel_wide_head_dims(cuda, hd, dtype):
    """prefix_prefill at hd 112 and 256: groups of 4 (two query heads a
    bf16 block) and 1, a ragged suffix and trash-padded table slots."""
    rng = np.random.default_rng(40 + hd)
    for H, Hkv in ((4, 1), (4, 4)):
        B, Sq, page, npp = 2, 100, 16, 8
        q = _t(rng, cuda, dtype, B, Sq, H, hd)
        k = _t(rng, cuda, dtype, B, Sq, Hkv, hd)
        v = _t(rng, cuda, dtype, B, Sq, Hkv, hd)
        kp = _t(rng, cuda, dtype, 1 + B * npp, page, Hkv, hd)
        vp = _t(rng, cuda, dtype, 1 + B * npp, page, Hkv, hd)
        kp[0], vp[0] = 50.0, -50.0
        table = torch.arange(1, 1 + B * npp, dtype=torch.int32,
                             device=cuda).reshape(B, npp)
        table[1, 5:] = 0                     # trash past the live prefix
        plens = torch.tensor([128, 70], dtype=torch.int32, device=cuda)
        slens = torch.tensor([100, 61], dtype=torch.int32, device=cuda)
        args = (q, k, v, kp, vp, table, plens, slens)
        got = prefix_prefill_op(*args, softcap=10.0)
        want = prefix_prefill_op(*args, softcap=10.0, plain=True)
        torch.cuda.synchronize()
        _close(got[0], want[0], dtype)
        _close(got[1, :61], want[1, :61], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", WIDE_HDS)
def test_paged_decode_kernel_wide_head_dims(cuda, hd, dtype):
    """paged_decode at hd 112 and 256, groups of 4 and 16, soft cap on and
    off, contexts of 1..the full table; two calls give identical bits."""
    rng = np.random.default_rng(50 + hd)
    for H, Hkv, cap in ((4, 1, 0.0), (32, 2, 5.0)):
        B, page, pps = 4, 16, 24
        q = _t(rng, cuda, dtype, B, H, hd)
        kp = _t(rng, cuda, dtype, 1 + B * pps, page, Hkv, hd)
        vp = _t(rng, cuda, dtype, 1 + B * pps, page, Hkv, hd)
        table = torch.from_numpy((1 + rng.permutation(B * pps)).reshape(
            B, pps).astype(np.int32)).to(cuda)
        lens = torch.tensor([1, 200, 383, pps * page], dtype=torch.int32,
                            device=cuda)
        got = paged_decode_op(q, kp, vp, table, lens, softcap=cap)
        again = paged_decode_op(q, kp, vp, table, lens, softcap=cap)
        _close(got, paged_decode_ref(q, kp, vp, table, lens, softcap=cap),
               dtype)
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", WIDE_HDS)
def test_paged_insert_kernel_wide_head_dims(cuda, hd, dtype):
    """The standalone insert copies rows of any width: hd 112 and 256,
    byte-exact against the plain version."""
    rng = np.random.default_rng(60 + hd)
    B, Hkv, pages, page = 4, 1, 8, 16
    kp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    vp = _t(rng, cuda, dtype, pages, page, Hkv, hd)
    kn = _t(rng, cuda, dtype, B, Hkv, hd)
    vn = _t(rng, cuda, dtype, B, Hkv, hd)
    pidx = torch.tensor([3, 1, 7, 5], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 7, 15, 3], dtype=torch.int32, device=cuda)
    k2, v2 = kp.clone(), vp.clone()
    before = tk.launch_counts()["paged_insert"]
    paged_insert_op(kp, vp, kn, vn, pidx, off)
    assert tk.launch_counts()["paged_insert"] == before + 1
    paged_insert_ref(k2, v2, kn, vn, pidx, off)
    torch.cuda.synchronize()
    assert torch.equal(kp, k2) and torch.equal(v2, vp)


@pytest.mark.parametrize("hd", [272, 320])
def test_attention_kernels_refuse_other_head_dims(cuda, hd):
    """A head dim above 256 (272, 320: no compiled instance, and no config
    of either package has one) raises ValueError in each attention
    kernel's wrapper, before any launch. (Dims that are not a multiple of
    16 run zero-padded: `test_attention_kernels_pad_odd_head_dims`.)"""
    z = lambda *shape: torch.zeros(shape, device=cuda)     # noqa: E731
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    tab = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    pool = z(4, 16, 1, hd)
    with pytest.raises(ValueError):
        flash_prefill_op(z(1, 64, 4, hd), z(1, 64, 1, hd), z(1, 64, 1, hd))
    with pytest.raises(ValueError):
        prefix_prefill_op(z(1, 64, 4, hd), z(1, 64, 1, hd), z(1, 64, 1, hd),
                          pool, pool, tab, one)
    with pytest.raises(ValueError):
        paged_decode_op(z(1, 4, hd), pool, pool, tab, one)
    with pytest.raises(ValueError):
        paged_insert_decode_op(z(1, 4, hd), z(1, 1, hd), z(1, 1, hd), pool,
                               pool, tab, one)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["local", "global"])
def test_slab_attn_decode_kernels_vs_plain(cuda, kind, dtype):
    """gemma3-1b's slab decode attention (4/1 heads, hd 256) through the
    kernels against the plain versions on copies of one slab layer: a
    512-slot ring (local: the standalone insert at pos % 512, then
    paged_decode over the slab's page view) and a 2048-slot slab (global:
    the fused insert + decode), B=8 with pos before and past the window.
    The output projection is the identity (d = H * hd), so the attention
    output is held to the tolerance itself; the slabs must be byte-equal
    after the insert."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config("gemma3-1b"), d_model=1024)
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    rng = np.random.default_rng(71)
    p = {"wq": _t(rng, cuda, dtype, d, H, hd) * d ** -0.5,
         "wk": _t(rng, cuda, dtype, d, Hkv, hd) * d ** -0.5,
         "wv": _t(rng, cuda, dtype, d, Hkv, hd) * d ** -0.5,
         "wo": torch.eye(d, device=cuda, dtype=dtype).reshape(H, hd, d),
         "q_norm": _t(rng, cuda, dtype, hd) * 0.1,
         "k_norm": _t(rng, cuda, dtype, hd) * 0.1}
    smax = 512 if kind == "local" else 2048
    B = 8
    kc = _t(rng, cuda, dtype, B, smax, Hkv, hd)
    vc = _t(rng, cuda, dtype, B, smax, Hkv, hd)
    k2, v2 = kc.clone(), vc.clone()
    x = _t(rng, cuda, dtype, B, d)
    pos = torch.tensor([0, 3, 200, 511, 512, 700, 1531, 1600],
                       dtype=torch.int32, device=cuda)
    slots = tf.slab_slots(pos, kc, kind == "local")
    before = tk.launch_counts()
    got = tf.attn_decode(p, x, cfg, kind, kc, vc, pos, slots)
    after = tk.launch_counts()
    assert after["paged_decode"] == before["paged_decode"] + 1
    assert after["paged_insert"] == before["paged_insert"] + 1
    fused = after["paged_insert_decode"] - before["paged_insert_decode"]
    assert fused == (0 if kind == "local" else 1)
    want = tf.attn_decode(p, x, cfg, kind, k2, v2, pos, slots, plain=True)
    _close(got, want, dtype)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


# ssd_scan: f32 as the JAX sweep (tests/test_kernels.py:237); in bf16 both
# sides read the same bf16 inputs and compute in f32, so y differs by about
# one bf16 rounding and h_final (f32) stays at the f32 tolerance
SSD_TOLS = {torch.float32: dict(atol=3e-4, rtol=3e-4),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


def _ssd_inputs(rng, dev, dtype, b, S, nh, hd, G, N):
    """(x, dt, A, B, C, D) with the distributions of the JAX sweep; dt in
    f32, the rest in `dtype` (a bf16 model keeps A and D in bf16)."""
    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, B, C = n(b, S, nh, hd), n(b, S, G, N), n(b, S, G, N)
    dt = np.log1p(np.exp(n(b, S, nh))) * 0.1
    A, D = -np.exp(n(nh)), n(nh)
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(t)
                 for a, t in ((x, dtype), (dt, torch.float32), (A, dtype),
                              (B, dtype), (C, dtype), (D, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (b, S, nh, hd, G, N, chunk): tests/test_kernels.py:220-225
    (2, 64, 4, 8, 2, 16, 16),
    (1, 128, 2, 64, 1, 128, 32),
    (2, 96, 4, 16, 4, 32, 32),
    (1, 200, 2, 16, 1, 16, 200),             # one ragged chunk
    (2, 1, 4, 16, 2, 16, 1),                 # a 1-token prompt
    (1, 2048, 80, 64, 1, 128, 256),          # mamba2-2.7b, 8 chunks
])
def test_ssd_scan_kernel(cuda, shape, dtype):
    b, S, nh, hd, G, N, chunk = shape
    args = _ssd_inputs(np.random.default_rng(5), cuda, dtype, b, S, nh, hd,
                       G, N)
    before = tk.launch_counts()["ssd_scan"]
    y, h = ssd_scan_op(*args, chunk=chunk)
    assert tk.launch_counts()["ssd_scan"] == before + 1
    ry, rh = ssd_scan_op(*args, chunk=chunk, plain=True)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), **SSD_TOLS[dtype])
    np.testing.assert_allclose(h.cpu().numpy(), rh.cpu().numpy(),
                               **SSD_TOLS[torch.float32])


def test_ssd_scan_kernel_initial_state_and_padded_tail(cuda):
    """h0 (null means zeros in the kernel), and a tail of dt = 0 steps
    that must leave the state as it was."""
    b, S, pad, nh, hd, G, N, chunk = 2, 40, 24, 4, 32, 2, 64, 32
    rng = np.random.default_rng(6)
    x, dt, A, B, C, D = _ssd_inputs(rng, cuda, torch.float32, b, S + pad,
                                    nh, hd, G, N)
    dt[:, S:] = 0.0
    h0 = torch.from_numpy(rng.standard_normal((b, nh, hd, N)).astype(
        np.float32)).to(cuda)
    y, h = ssd_scan_op(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    ry, rh = ssd_scan_op(x, dt, A, B, C, D, chunk=chunk, h0=h0, plain=True)
    _, h40 = ssd_scan_op(x[:, :S], dt[:, :S], A, B[:, :S], C[:, :S], D,
                         chunk=S, h0=h0)
    torch.cuda.synchronize()
    tol = SSD_TOLS[torch.float32]
    np.testing.assert_allclose(y.cpu().numpy(), ry.cpu().numpy(), **tol)
    np.testing.assert_allclose(h.cpu().numpy(), rh.cpu().numpy(), **tol)
    np.testing.assert_allclose(h.cpu().numpy(), h40.cpu().numpy(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (b, S, nh, hd, G, N, chunk)
    (1, 1536, 80, 64, 1, 128, 256),          # the traced prefill, 6 chunks
    (2, 400, 8, 32, 2, 64, 200),             # G = 2, 4 heads a block
    (1, 192, 12, 128, 2, 128, 96),           # hd 128, ragged query tiles
])
def test_ssd_scan_kernel_chunks_groups_and_h0(cuda, shape, dtype):
    """The three-phase kernel with an initial state, against the plain
    version; G = 2 splits the heads across head blocks of one group each;
    two identical calls give identical bits (no atomics)."""
    b, S, nh, hd, G, N, chunk = shape
    rng = np.random.default_rng(14)
    args = _ssd_inputs(rng, cuda, dtype, b, S, nh, hd, G, N)
    h0 = torch.from_numpy(rng.standard_normal((b, nh, hd, N)).astype(
        np.float32)).to(cuda)
    y, h = ssd_scan_op(*args, chunk=chunk, h0=h0)
    y2, h2 = ssd_scan_op(*args, chunk=chunk, h0=h0)
    ry, rh = ssd_scan_op(*args, chunk=chunk, h0=h0, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), **SSD_TOLS[dtype])
    np.testing.assert_allclose(h.cpu().numpy(), rh.cpu().numpy(),
                               **SSD_TOLS[torch.float32])


# ---------------- the planning stack over live clusters on the card -------

def _smoke_serving(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.h100 import H100
    from repro_torch.core.latency_model import (EngineCharge, LatencyModel,
                                                Parallelism)
    from repro_torch.models.api import build_model
    cfg = get_config("yi-6b-smoke")
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cuda)
    lm = LatencyModel(cfg, H100)
    return cfg, params, lm, EngineCharge(lm, Parallelism())


def _smoke_trace(cfg, gap, n=8):
    """Prompts of 20..70 tokens, the first five sharing a 24-token head,
    arriving `gap` seconds apart."""
    from repro_torch.core.workload import Request
    rng = np.random.default_rng(0)
    head = rng.integers(1, cfg.vocab_size, 24).tolist()
    out = []
    for i, L in enumerate([70, 40, 20, 55, 45, 30, 64, 26][:n]):
        body = rng.integers(1, cfg.vocab_size, L).tolist()
        toks = (head + body)[:L] if i < 5 else body
        out.append(Request(i, gap * (i + 1), L, 4 + i % 5,
                           tokens=tuple(toks)))
    return out


@pytest.mark.parametrize("chunk_tokens", [None, 32])
def test_charged_live_cluster_matches_sim_on_card(cuda, chunk_tokens):
    """A live `DisaggCluster` on the card under `EngineCharge(H100)` gives
    the port's `SimDisaggBackend` timeline to the float, with the kernels
    making the tokens. Arrivals 1 s apart: every migration reaches an idle
    decode instance (the live cluster pulls at its next poll, the sim at
    dispatch)."""
    from repro_torch.core.latency_model import Parallelism
    from repro_torch.core.simulator import InstanceConfig, SimDisaggBackend
    from repro_torch.serving.cluster import DisaggCluster
    cfg, params, lm, charge = _smoke_serving(cuda)
    trace = _smoke_trace(cfg, 1.0)
    live = DisaggCluster(cfg, params, n_prefill=2, n_decode=2, max_batch=4,
                         max_len=96, lm_tokens=1, chunk_tokens=chunk_tokens,
                         charge=charge, device=cuda)
    sim = SimDisaggBackend(lm, InstanceConfig(Parallelism(), 2),
                           InstanceConfig(Parallelism(), 2),
                           transfer_bw=live.tx.bandwidth, lm_tokens=1,
                           chunk_tokens=chunk_tokens, max_decode_batch=4,
                           prefix_cache=False)
    before = tk.launch_counts()
    for b in (live, sim):
        for r in trace:
            b.submit(dataclasses.replace(r))
        b.drain()
    after = tk.launch_counts()
    assert after["flash_prefill"] > before["flash_prefill"]
    assert after["paged_decode"] > before["paged_decode"]
    times = {rid: [e.t for e in st.events] for rid, st in live.states.items()}
    assert times == {rid: [e.t for e in st.events]
                     for rid, st in sim.states.items()}
    assert live.dispatcher.decisions == sim.disp.decisions
    assert all(len(r.tokens) == t.in_len + t.out_len
               for r, t in zip((live.results[i] for i in range(8)), trace))


def test_router_decisions_match_sim_fleet_on_card(cuda):
    """Two live clusters on the card (prefix cache, 32-token chunks) behind
    `FleetRouter(policy="prefix_affinity")` under the H100 charge route
    the trace exactly as two `SimDisaggBackend`s do."""
    from repro_torch.core.latency_model import Parallelism
    from repro_torch.core.simulator import InstanceConfig, SimDisaggBackend
    from repro_torch.serving.cluster import DisaggCluster
    from repro_torch.serving.router import FleetRouter
    cfg, params, lm, charge = _smoke_serving(cuda)
    kw = dict(lm_tokens=1, chunk_tokens=32, prefix_cache=True)
    live = [DisaggCluster(cfg, params, n_prefill=1, n_decode=1, max_batch=4,
                          max_len=96, charge=charge, seed=i, device=cuda,
                          **kw) for i in range(2)]
    sims = [SimDisaggBackend(lm, InstanceConfig(Parallelism(), 1),
                             InstanceConfig(Parallelism(), 1),
                             transfer_bw=live[0].tx.bandwidth,
                             max_decode_batch=4, **kw) for _ in range(2)]
    routers = [FleetRouter(f, policy="prefix_affinity") for f in (live, sims)]
    before = tk.launch_counts()["prefix_prefill"]
    res = []
    for fr in routers:
        for r in _smoke_trace(cfg, 0.05):
            fr.submit(r)
        res.append(fr.drain())
    assert routers[0].decisions == routers[1].decisions
    assert {d[2] for d in routers[0].decisions if d[0] == "route"} == {0, 1}
    assert sorted(res[0]) == sorted(res[1]) == list(range(8))
    assert sum(c.prefill[0].prefix_hit_tokens for c in live) > 0
    assert tk.launch_counts()["prefix_prefill"] > before


# ---------------------------------------------------------------------------
# head dims that are not a multiple of 16 (zero-padded in the wrappers),
# query-head groups above 16 (sliced), non-causal flash_prefill with
# Sq != Skv (the encoder-decoder's cross-attention), ssd_scan at zamba2-7b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [72, 200])
def test_attention_kernels_pad_odd_head_dims(cuda, hd, dtype):
    """hd 72 and 200 run in flash_prefill (causal, Sq < Skv), in
    prefix_prefill and in paged_decode / the fused insert + decode: each
    equals its plain version (at the scale of the true head dim), and
    the fused op writes the new rows into the unpadded pools."""
    rng = np.random.default_rng(70 + hd)
    H, Hkv = 4, 2
    q = _t(rng, cuda, dtype, 1, 70, H, hd)
    k = _t(rng, cuda, dtype, 1, 100, Hkv, hd)
    v = _t(rng, cuda, dtype, 1, 100, Hkv, hd)
    _close(flash_prefill_op(q, k, v), flash_prefill_op(q, k, v, plain=True),
           dtype)
    page, npp = 16, 4
    kp = _t(rng, cuda, dtype, 1 + npp, page, Hkv, hd)
    vp = _t(rng, cuda, dtype, 1 + npp, page, Hkv, hd)
    table = torch.arange(1, 1 + npp, dtype=torch.int32,
                         device=cuda)[None]
    plens = torch.tensor([50], dtype=torch.int32, device=cuda)
    args = (q, k[:, :70], v[:, :70], kp, vp, table, plens)
    _close(prefix_prefill_op(*args), prefix_prefill_op(*args, plain=True),
           dtype)
    qd = _t(rng, cuda, dtype, 1, H, hd)
    lens = torch.tensor([37], dtype=torch.int32, device=cuda)
    _close(paged_decode_op(qd, kp, vp, table, lens),
           paged_decode_ref(qd, kp, vp, table, lens), dtype)
    kn = _t(rng, cuda, dtype, 1, Hkv, hd)
    vn = _t(rng, cuda, dtype, 1, Hkv, hd)
    k2, v2 = kp.clone(), vp.clone()
    got = paged_insert_decode_op(qd, kn, vn, kp, vp, table, lens)
    want = paged_insert_decode_ref(qd, kn, vn, k2, v2, table, lens)
    _close(got, want, dtype)
    assert torch.equal(kp, k2) and torch.equal(vp, v2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused", [False, True])
def test_paged_decode_kernel_group_of_24(cuda, fused, dtype):
    """A group of 24 query heads a kv head (48 over 2) runs as slices of
    16 and 8; with the fused insert the row goes in once, with the first
    slice, and both pools equal the plain version's."""
    rng = np.random.default_rng(24)
    B, H, Hkv, hd, page, pps = 3, 48, 2, 128, 16, 8
    q = _t(rng, cuda, dtype, B, H, hd)
    kp = _t(rng, cuda, dtype, 1 + B * pps, page, Hkv, hd)
    vp = _t(rng, cuda, dtype, 1 + B * pps, page, Hkv, hd)
    table = torch.from_numpy((1 + rng.permutation(B * pps)).reshape(
        B, pps).astype(np.int32)).to(cuda)
    lens = torch.tensor([5, 70, 128], dtype=torch.int32, device=cuda)
    if not fused:
        _close(paged_decode_op(q, kp, vp, table, lens, softcap=4.0),
               paged_decode_ref(q, kp, vp, table, lens, softcap=4.0), dtype)
        return
    kn = _t(rng, cuda, dtype, B, Hkv, hd)
    vn = _t(rng, cuda, dtype, B, Hkv, hd)
    k2, v2 = kp.clone(), vp.clone()
    before = tk.launch_counts()["paged_insert_decode"]
    got = paged_insert_decode_op(q, kn, vn, kp, vp, table, lens)
    assert tk.launch_counts()["paged_insert_decode"] == before + 1
    _close(got, paged_insert_decode_ref(q, kn, vn, k2, v2, table, lens),
           dtype)
    assert torch.equal(kp, k2) and torch.equal(vp, v2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Sq,Skv", [(64, 1024), (300, 70)])
def test_flash_prefill_kernel_non_causal_cross(cuda, Sq, Skv, hd, dtype):
    """Non-causal flash_prefill with queries fewer and more than keys (the
    decoder's cross-attention over the encoder's frames), 16/16 and 16/4
    heads, in the model's layout."""
    rng = np.random.default_rng(Sq + Skv + hd)
    for H, Hkv in ((16, 16), (16, 4)):
        q = _t(rng, cuda, dtype, 1, Sq, H, hd)
        k = _t(rng, cuda, dtype, 1, Skv, Hkv, hd)
        v = _t(rng, cuda, dtype, 1, Skv, Hkv, hd)
        before = tk.launch_counts()["flash_prefill"]
        got = flash_prefill_op(q, k, v, causal=False)
        assert tk.launch_counts()["flash_prefill"] == before + 1
        _close(got, flash_prefill_op(q, k, v, causal=False, plain=True),
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_kernel_zamba2_shape(cuda, with_h0, dtype):
    """zamba2-7b's scan: nh 112, hd 64, G 1, N 64, a 600-token prompt in
    chunks of 256 (the last padded with dt = 0 steps), with and without
    an initial state."""
    b, S, nh, hd, G, N, chunk = 1, 768, 112, 64, 1, 64, 256
    rng = np.random.default_rng(112)
    args = _ssd_inputs(rng, cuda, dtype, b, S, nh, hd, G, N)
    args[1][:, 600:] = 0.0
    h0 = torch.from_numpy(rng.standard_normal((b, nh, hd, N)).astype(
        np.float32)).to(cuda) if with_h0 else None
    y, h = ssd_scan_op(*args, chunk=chunk, h0=h0)
    ry, rh = ssd_scan_op(*args, chunk=chunk, h0=h0, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), **SSD_TOLS[dtype])
    np.testing.assert_allclose(h.cpu().numpy(), rh.cpu().numpy(),
                               **SSD_TOLS[torch.float32])
