"""The fused insert-and-decode op of the port (`paged_insert_decode_op`) on
the CPU, where it runs its plain version: against the JAX `paged_insert`
followed by the JAX `paged_decode`, both Pallas kernels in interpret mode,
with the write position taken from `lens` as the decode step takes it
(page `table[b, (lens-1) // page]`, row `(lens-1) % page`). Outputs agree
within the tolerances of `tests/test_kernels.py:16-17`; the pools after
the call are byte-equal. Inputs are drawn with numpy from a seed and fed to
both frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode.kernel import paged_decode as jx_decode
from repro.kernels.paged_decode.kernel import paged_insert as jx_insert
from repro_torch import kernels as tk
from repro_torch.kernels.paged_decode import kernel as decode_kernel
from repro_torch.kernels.paged_decode.ops import (paged_decode_op,
                                                  paged_insert_decode_op,
                                                  paged_insert_op)
from repro_torch.kernels.paged_decode.ref import insert_at_lens
from repro_torch.models import transformer as tx_tf

# tests/test_kernels.py:16-17
TOLS = {"float32": dict(atol=5e-5, rtol=5e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

B, H, HKV, HD, PAGE, PPS = 3, 8, 2, 32, 8, 8
NUM_PAGES = 1 + B * PPS                 # page 0 is the trash page
FULL = PPS * PAGE

# name -> (lens, rows whose table is all trash page 0 (idle slots))
CASES = {
    # every write goes to row 0 of a page nothing has written yet
    "row0_of_fresh_page": ([1, 9, 33], ()),
    # the last row of a split's range, for splits of 1, 2 and 3 pages
    "last_row_of_split_1": ([PAGE, 2 * PAGE, 5 * PAGE], ()),
    "last_row_of_split_2": ([2 * PAGE, 4 * PAGE, 6 * PAGE], ()),
    "last_row_of_split_3": ([3 * PAGE, 6 * PAGE, 3 * PAGE], ()),
    # lens = pps * page: the clamped cursor writes the table's last row
    "clamped_full_table": ([FULL, FULL, 13], ()),
    # idle slots: table rows all trash page 0, cursors past the table
    "idle_trash_rows": ([FULL, 21, 13], (0, 2)),
    "mid_page": ([5, 27, 60], ()),
}


def _inputs(name):
    """numpy f32 inputs of case `name`: q, k/v pools (trash page 0 loud),
    the table, lens, the new rows and the idle rows."""
    lens, idle = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    kp = rng.standard_normal((NUM_PAGES, PAGE, HKV, HD)).astype(np.float32)
    vp = rng.standard_normal((NUM_PAGES, PAGE, HKV, HD)).astype(np.float32)
    kp[0], vp[0] = 100.0, -100.0
    kn = rng.standard_normal((B, HKV, HD)).astype(np.float32)
    vn = rng.standard_normal((B, HKV, HD)).astype(np.float32)
    table = (1 + rng.permutation(B * PPS)).reshape(B, PPS).astype(np.int32)
    for b in idle:
        table[b] = 0
    return q, kp, vp, table, np.asarray(lens, np.int32), kn, vn, idle


def _jax(q, kp, vp, table, lens, kn, vn, dtype, new_f32):
    """JAX paged_insert at (lens - 1), then JAX paged_decode, both in
    interpret mode -> (out, k pool, v pool) as f32 numpy."""
    wp = np.minimum(lens, FULL) - 1
    pidx = table[np.arange(B), wp // PAGE]
    jd = JDT[dtype]
    new = [jnp.asarray(x) if new_f32 else jnp.asarray(x).astype(jd)
           for x in (kn, vn)]
    jk, jv = jx_insert(jnp.asarray(kp).astype(jd), jnp.asarray(vp).astype(jd),
                       *new, jnp.asarray(pidx), jnp.asarray(wp % PAGE),
                       interpret=True)
    out = jx_decode(jnp.asarray(q).astype(jd), jk, jv, jnp.asarray(table),
                    jnp.asarray(lens), interpret=True)
    return tuple(np.asarray(x, np.float32) for x in (out, jk, jv))


def _torch(q, kp, vp, table, lens, kn, vn, dtype, new_f32):
    td = TDT[dtype]
    tq, tkp, tvp = (torch.from_numpy(x.copy()).to(td) for x in (q, kp, vp))
    tkn, tvn = (torch.from_numpy(x).to(torch.float32 if new_f32 else td)
                for x in (kn, vn))
    return tq, tkn, tvn, tkp, tvp, torch.from_numpy(table), \
        torch.from_numpy(lens)


def _check(name, dtype, new_f32):
    q, kp, vp, table, lens, kn, vn, idle = _inputs(name)
    want, jk, jv = _jax(q, kp, vp, table, lens, kn, vn, dtype, new_f32)
    tq, tkn, tvn, tkp, tvp, ttab, tlens = _torch(q, kp, vp, table, lens, kn,
                                                 vn, dtype, new_f32)
    got = paged_insert_decode_op(tq, tkn, tvn, tkp, tvp, ttab, tlens)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, HD)
    assert tkp.dtype == TDT[dtype]                 # written in place
    live = [b for b in range(B) if b not in idle]
    np.testing.assert_allclose(got[live].float().numpy(), want[live],
                               **TOLS[dtype])
    # byte-equal pools; with idle slots, page 0 holds racing trash rows
    pages = slice(1, None) if idle else slice(None)
    np.testing.assert_array_equal(tkp.float().numpy()[pages], jk[pages])
    np.testing.assert_array_equal(tvp.float().numpy()[pages], jv[pages])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_insert_decode_matches_jax_insert_then_decode(dtype, case):
    _check(case, dtype, new_f32=False)


@pytest.mark.parametrize("case", ["row0_of_fresh_page", "idle_trash_rows",
                                  "clamped_full_table"])
def test_insert_decode_f32_rows_into_bf16_pools(case):
    """f32 new rows into bf16 pools are rounded as the JAX insert rounds
    them (`astype` of the pool dtype, nearest even)."""
    _check(case, "bfloat16", new_f32=True)


def test_insert_decode_equals_insert_op_then_decode_op():
    """The fused op computes exactly the two public ops in a row, at the
    write position the decode step used to compute (clamp, gather, mod)."""
    q, kp, vp, table, lens, kn, vn, _ = _inputs("mid_page")
    a = _torch(q, kp, vp, table, lens, kn, vn, "float32", False)
    tq, tkn, tvn, tkp, tvp, ttab, tlens = a
    k2, v2 = tkp.clone(), tvp.clone()
    got = paged_insert_decode_op(tq, tkn, tvn, tkp, tvp, ttab, tlens,
                                 softcap=3.0)
    wpos = torch.clamp(tlens - 1, max=FULL - 1)
    pidx = ttab[torch.arange(B), (wpos // PAGE).long()]
    paged_insert_op(k2, v2, tkn, tvn, pidx, wpos % PAGE)
    want = paged_decode_op(tq, k2, v2, ttab, tlens, softcap=3.0)
    assert torch.equal(got, want)
    assert torch.equal(tkp, k2) and torch.equal(tvp, v2)


def test_insert_decode_zero_length_writes_nothing():
    """lens = 0 (never passed by the decode step): no write for that
    sequence, and the output of paged_decode over the updated pools."""
    q, kp, vp, table, _, kn, vn, _ = _inputs("mid_page")
    lens = np.array([0, 4, 0], np.int32)
    tq, tkn, tvn, tkp, tvp, ttab, tlens = _torch(q, kp, vp, table, lens, kn,
                                                 vn, "float32", False)
    before = tkp.clone()
    got = paged_insert_decode_op(tq, tkn, tvn, tkp, tvp, ttab, tlens)
    changed = (tkp != before).flatten(1).any(1).nonzero().flatten().tolist()
    assert changed == [int(ttab[1, 0])]            # sequence 1's page only
    assert torch.equal(got, paged_decode_op(tq, tkp, tvp, ttab, tlens))


@pytest.mark.parametrize("first,n,want", [(0, None, [0, 1, 2]), (0, 1, [0]),
                                          (1, 2, [1]), (3, 5, [2]),
                                          (6, 2, [])])
def test_insert_at_lens_writes_only_the_owner_split(first, n, want):
    """`insert_at_lens` restricted to table slots [first, first + n)
    writes exactly the sequences whose position len - 1 lies there
    (lens 5, 9, 33 at page 8: slots 0, 1, 4)."""
    _, kp, vp, table, _, kn, vn, _ = _inputs("mid_page")
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    lens = torch.tensor([5, 9, 33], dtype=torch.int32)
    ttab = torch.from_numpy(table)
    tkn = torch.from_numpy(kn)
    insert_at_lens(tkp, tvp, tkn, torch.from_numpy(vn), ttab, lens, first, n)
    wp = lens.long() - 1
    wrote = [b for b in range(B)
             if torch.equal(tkp[ttab[b, wp[b] // PAGE], wp[b] % PAGE],
                            tkn[b])]
    assert wrote == want
    changed = (tkp != torch.from_numpy(kp)).any(-1).any(-1)
    assert int(changed.sum()) == len(want)


def test_decode_step_runs_one_fused_op_a_layer(monkeypatch):
    """`decode_step_paged` calls `paged_insert_decode_op` once per layer
    with lens = min(pos + 1, pps * page), and no separate insert."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("yi-6b-smoke")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    page, pps, pages = 8, 4, 10
    specs = tx_tf.paged_cache_specs(cfg, 3, pages, page, torch.float32,
                                    max_len=pps * page)
    cache = {k: ({c: torch.zeros(s.shape, dtype=s.dtype)
                  for c, s in v.items()} if isinstance(v, dict)
                 else torch.zeros(v.shape, dtype=v.dtype))
             for k, v in specs.items()}
    cache["block_tables"][0] = torch.tensor([1, 2, 3, 0])
    cache["pos"][:] = torch.tensor([19, 0, 40])
    seen = []
    fused = tx_tf.paged_insert_decode_op

    def spy(q, k, v, kp, vp, table, lens, **kw):
        seen.append(lens.tolist())
        return fused(q, k, v, kp, vp, table, lens, **kw)
    monkeypatch.setattr(tx_tf, "paged_insert_decode_op", spy)
    tk.reset_launch_counts()
    tx_tf.decode_step_paged(params, cache, torch.tensor([1, 2, 3]), cfg)
    assert seen == [[20, 1, 32]] * cfg.num_layers
    assert cache["pos"].tolist() == [20, 1, 41]
    assert tk.launch_counts()["paged_insert"] == 0     # CPU: plain versions


def test_fused_launcher_refuses_cpu_tensors_without_counting():
    """The fused kernel's wrapper takes CUDA tensors only and raises on
    others (before any build); the op's CPU path counts no launch."""
    q, kp, vp, table, lens, kn, vn, _ = _inputs("mid_page")
    args = _torch(q, kp, vp, table, lens, kn, vn, "float32", False)
    tk.reset_launch_counts()
    with pytest.raises(ValueError):
        decode_kernel.paged_insert_decode(*args)
    paged_insert_decode_op(*args)
    assert tk.launch_counts()["paged_decode"] == 0
    assert tk.launch_counts()["paged_insert"] == 0
