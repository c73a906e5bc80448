"""The split-and-merge algorithm of the port's `paged_decode` kernel on the
CPU: its plain version (`paged_decode_split_ref`) against the JAX Pallas
kernel (interpret mode) and the JAX oracle, over several split sizes and
the cases that stress the merge; and the host-side choice of the split
count as a pure function. Inputs are drawn with numpy from a seed and fed
to both frameworks."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode.kernel import paged_decode as jx_decode
from repro.kernels.paged_decode.kernel import paged_insert as jx_insert
from repro.kernels.paged_decode.ref import paged_decode_ref as jx_decode_ref
from repro_torch.kernels.build import require_aligned
from repro_torch.kernels.paged_decode.kernel import DEC_ROWS, decode_split
from repro_torch.kernels.paged_decode.ref import (paged_decode_ref,
                                                  paged_decode_split_ref)

# tests/test_kernels.py:16-17
TOLS = {"float32": dict(atol=5e-5, rtol=5e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

B, H, HKV, HD, PAGE, PPS = 3, 8, 2, 32, 8, 8
NUM_PAGES = 1 + B * PPS                 # page 0 is the trash page
FULL = PPS * PAGE

# name -> (lens, softcap, trash-pad the table past the live pages)
CASES = {
    "lens_1": ([1, 1, 1], 0.0, False),
    "full_table": ([FULL, FULL, FULL], 0.0, False),
    "empty_splits": ([5, 17, FULL - 3], 0.0, False),
    "trash_slots": ([9, 30, 50], 0.0, True),
    "softcap": ([23, FULL, 40], 5.0, False),
    "zero_len": ([0, 3, 0], 0.0, True),
}


@functools.lru_cache(maxsize=None)
def _case(name: str, dtype: str):
    """(torch inputs, JAX kernel output as f32 numpy, softcap)."""
    lens, cap, trash = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    kp = rng.standard_normal((NUM_PAGES, PAGE, HKV, HD)).astype(np.float32)
    vp = rng.standard_normal((NUM_PAGES, PAGE, HKV, HD)).astype(np.float32)
    kp[0], vp[0] = 100.0, -100.0       # loud if a trash page leaked in
    table = (1 + rng.permutation(B * PPS)).reshape(B, PPS).astype(np.int32)
    if trash:
        for b, n in enumerate(lens):
            table[b, -(-n // PAGE):] = 0
    lens = np.asarray(lens, np.int32)
    j = [jnp.asarray(x).astype(JDT[dtype]) for x in (q, kp, vp)]
    want = jx_decode(*j, jnp.asarray(table), jnp.asarray(lens), softcap=cap,
                     interpret=True)
    t = [torch.from_numpy(x).to(TDT[dtype]) for x in (q, kp, vp)]
    t += [torch.from_numpy(table), torch.from_numpy(lens)]
    return t, np.asarray(want, np.float32), cap


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("split_pages", [1, 2, 3, PPS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_jax_kernel(dtype, split_pages, case):
    """Split sizes of one page, two, one that does not divide the table (3
    of 8) and the whole table, each against the JAX kernel."""
    t, want, cap = _case(case, dtype)
    got = paged_decode_split_ref(*t, split_pages=split_pages, softcap=cap)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, HD)
    np.testing.assert_allclose(got.float().numpy(), want, **TOLS[dtype])


@pytest.mark.parametrize("case", ["lens_1", "full_table", "empty_splits",
                                  "trash_slots", "softcap"])
def test_split_merge_matches_jax_oracle_and_plain_version(case):
    """Where every sequence has a live position, the split-and-merge also
    matches the JAX oracle and the port's one-pass plain version."""
    t, _, cap = _case(case, "float32")
    got = paged_decode_split_ref(*t, split_pages=2, softcap=cap)
    j = [jnp.asarray(x.numpy()) for x in t]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jx_decode_ref(*j, softcap=cap)),
                               **TOLS["float32"])
    np.testing.assert_allclose(got.numpy(),
                               paged_decode_ref(*t, softcap=cap).numpy(),
                               **TOLS["float32"])


@functools.lru_cache(maxsize=None)
def _insert_case(name: str, dtype: str):
    """Case `name` with new K/V rows (f32, rounded to `dtype`): (torch
    inputs, new rows, and the JAX paged_insert at position lens - 1
    followed by the JAX paged_decode, both in interpret mode, as f32 numpy
    (out, k pool, v pool))."""
    t, _, cap = _case(name, dtype)
    rng = np.random.default_rng(100 + sorted(CASES).index(name))
    kn, vn = (rng.standard_normal((B, HKV, HD)).astype(np.float32)
              for _ in range(2))
    q, kp, vp, table, lens = (x.numpy() if x.dtype != torch.bfloat16
                              else x.float().numpy() for x in t)
    wp = np.minimum(lens, FULL) - 1
    jd = JDT[dtype]
    jk, jv = jx_insert(jnp.asarray(kp).astype(jd), jnp.asarray(vp).astype(jd),
                       jnp.asarray(kn).astype(jd), jnp.asarray(vn).astype(jd),
                       jnp.asarray(table[np.arange(B), wp // PAGE]),
                       jnp.asarray(wp % PAGE), interpret=True)
    out = jx_decode(jnp.asarray(q).astype(jd), jk, jv, jnp.asarray(table),
                    jnp.asarray(lens), softcap=cap, interpret=True)
    new = tuple(torch.from_numpy(x).to(TDT[dtype]) for x in (kn, vn))
    return t, new, cap, tuple(np.asarray(x, np.float32)
                              for x in (out, jk, jv))


@pytest.mark.parametrize("case", sorted(set(CASES) - {"zero_len"}))
@pytest.mark.parametrize("split_pages", [1, 2, 3, PPS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_with_owner_insert_matches_jax(dtype, split_pages, case):
    """The insert instance's algorithm: the split that holds position
    lens - 1 writes the new row before it reads its pages; the result is
    the JAX insert followed by the JAX kernel (output within tolerance,
    pools byte-equal), for every split size."""
    t, (kn, vn), cap, (want, jk, jv) = _insert_case(case, dtype)
    q, kp, vp, table, lens = t
    kp, vp = kp.clone(), vp.clone()
    got = paged_decode_split_ref(q, kp, vp, table, lens,
                                 split_pages=split_pages, softcap=cap,
                                 k_new=kn, v_new=vn)
    np.testing.assert_allclose(got.float().numpy(), want, **TOLS[dtype])
    np.testing.assert_array_equal(kp.float().numpy(), jk)
    np.testing.assert_array_equal(vp.float().numpy(), jv)


def test_split_merge_zero_length_gives_zero():
    """lens[b] = 0: every split is empty and the output row is 0, as the
    TPU kernel gives (its walk computes nothing and divides 0 by 1e-37)."""
    t, want, _ = _case("zero_len", "float32")
    got = paged_decode_split_ref(*t, split_pages=1)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.count_nonzero(got[2]) == 0
    assert np.count_nonzero(want[0]) == 0


def test_split_merge_is_deterministic():
    t, _, _ = _case("empty_splits", "float32")
    a = paged_decode_split_ref(*t, split_pages=3)
    assert torch.equal(a, paged_decode_split_ref(*t, split_pages=3))


def test_decode_split_at_the_serve_shape():
    """yi-6b serve phase: B=8, Hkv=4, 128 pages of 16 a table. At least
    2 x 132 blocks, and about 512."""
    per, n = decode_split(8, 4, 128, 16, 132)
    assert (per, n) == (8, 16)
    assert 8 * 4 * n >= 2 * 132
    assert per * n >= 128


@pytest.mark.parametrize("B,Hkv,pps,page", [
    (8, 4, 128, 16), (1, 4, 94, 16), (1, 4, 128, 16), (3, 2, 7, 8),
    (64, 8, 128, 16), (2, 1, 5, 32), (1, 1, 1, 16), (4, 4, 3, 4),
    (1, 2, 1000, 1), (16, 8, 64, 64),
])
def test_decode_split_invariants(B, Hkv, pps, page):
    """Never more splits than pages; the splits cover the table; pages per
    split are a power of two (or the whole table); a split is at least one
    32-row tile unless the table is shorter; as many blocks as 2 x 132
    allows."""
    per, n = decode_split(B, Hkv, pps, page, 132)
    assert 1 <= n <= pps
    assert per * n >= pps and per * (n - 1) < pps
    assert per == pps or per & (per - 1) == 0
    assert per * page >= min(DEC_ROWS, pps * page) or per == pps
    if B * Hkv * n < 2 * 132 and per > 1:
        assert per * page <= 2 * DEC_ROWS     # stopped at the smallest tile


def test_decode_split_one_page_table_is_one_split():
    assert decode_split(8, 4, 1, 16) == (1, 1)
    assert decode_split(1, 1, 1, 1) == (1, 1)


def test_decode_split_many_blocks_is_one_split():
    """With B * Hkv at or above 2 x 132 blocks there is nothing to split."""
    assert decode_split(96, 4, 128, 16, 132) == (128, 1)


def test_require_aligned_refuses_unaligned_views():
    """The kernels' 16-byte vector copies take tensors that start on 16
    bytes with strides in 16-byte units; the wrappers raise otherwise."""
    x = torch.zeros(2, 5, 4, 16)                       # (B, S, H, hd)
    require_aligned("t", x.transpose(1, 2))            # model-layout view
    require_aligned("t", x[:, 1:].transpose(1, 2))     # 4 * 16 floats in
    with pytest.raises(ValueError):
        require_aligned("t", x[..., 1:])              # starts 4 bytes in
    y = torch.zeros(3, 18, dtype=torch.bfloat16)[:, :16]
    with pytest.raises(ValueError):
        require_aligned("t", y)                       # 36-byte row stride
    require_aligned("t", y[:1])                       # one row: no stride
