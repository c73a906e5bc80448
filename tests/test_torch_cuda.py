"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit and skip without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; `tests/conftest.py` imports JAX, so run it as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The shapes are those of the JAX package's kernel sweeps
(`tests/test_kernels.py`), plus the model's (B, S, H, hd) views. Tolerances
are those of `tests/test_kernels.py:16-17`.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels.flash_prefill.ops import flash_prefill_op
from repro_torch.kernels.paged_decode.ops import (paged_decode_op,
                                                  paged_insert_op)
from repro_torch.kernels.paged_decode.ref import (paged_decode_ref,
                                                  paged_insert_ref)
from repro_torch.kernels.prefix_prefill.ops import prefix_prefill_op
from repro_torch.kernels.prefix_prefill.ref import prefix_prefill_ref

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
