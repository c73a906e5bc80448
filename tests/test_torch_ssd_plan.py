"""The algorithm of the port's `ssd_scan` kernel on the CPU: its launch
plan as a pure function of the shapes (every (batch, chunk, head, query
tile) served exactly once, heads of a block in one group, every C.B^T tile
pair once, scratch shapes), and its plain version `ssd_scan_split_ref`
(chunk states, state passing, chunk outputs by 64-row query tiles with
C.B^T shared by a group) against the JAX Pallas kernel in interpret mode,
the JAX chunked reference and the sequential recurrence. Inputs are drawn
with numpy from a seed and fed to both frameworks."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jx_scan
from repro.models import ssd as jx_ssd
from repro_torch.kernels.ssd_scan.kernel import (MAX_HEADS_PER_BLOCK, TILE,
                                                 ssd_bwd_plan, ssd_plan)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_split_ref

TOL = dict(atol=3e-4, rtol=3e-4)          # tests/test_kernels.py:237


def _inputs(seed, b, S, nh, hd, G, N):
    """The distributions of `tests/test_kernels.py::test_ssd_scan_sweep`."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x = n(b, S, nh, hd)
    dt = (np.log1p(np.exp(n(b, S, nh))) * 0.1).astype(np.float32)
    A = -np.exp(n(nh))
    return x, dt, A, n(b, S, G, N), n(b, S, G, N), n(nh)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


PLAN_SHAPES = [
    # (b, S, nh, G, chunk)
    (1, 2048, 80, 1, 256),       # mamba2-2.7b, 8 chunks
    (1, 1536, 80, 1, 256),       # the serve phase's traced prefill
    (1, 200, 80, 1, 200),        # one ragged chunk
    (1, 1, 80, 1, 1),            # a 1-token prompt
    (2, 512, 8, 2, 256),
    (3, 400, 12, 2, 200),
    (2, 7, 6, 2, 1),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_ssd_plan_covers_every_output_tile_once(shape):
    b, S, nh, G, chunk = shape
    hd, N = 64, 128
    plan = ssd_plan(b, S, nh, hd, G, N, chunk)
    nc, nqt = S // chunk, -(-chunk // TILE)
    assert (plan.chunks, plan.q_tiles) == (nc, nqt)
    hb = plan.heads_per_block
    rep = nh // G
    assert 1 <= hb <= MAX_HEADS_PER_BLOCK and rep % hb == 0
    seen = []
    gx, gy, gz = plan.grid_out
    for x, y, z in itertools.product(range(gx), range(gy), range(gz)):
        bi, c, qt, heads = plan.out_block(x, y, z)
        assert len({h // rep for h in heads}) == 1      # one group a block
        seen += [(bi, c, h, qt) for h in heads]
    want = list(itertools.product(range(b), range(nc), range(nh),
                                  range(nqt)))
    assert sorted(seen) == want                         # each exactly once
    # heaviest query tiles (most source tiles) are launched first
    assert plan.out_block(0, 0, 0)[2] == nqt - 1
    assert plan.grid_state == (nc, nh, b)
    assert plan.grid_pass == (-(-hd * N // 256), nh, b)
    assert plan.states_shape == (b, nc, nh, N, hd)
    assert plan.acum_shape == (b, nh, S)
    # C.B^T: every (batch, chunk, group, query tile, source tile <= it)
    # once, in a scratch tile of its own
    pairs = [plan.cb_block(x, y, z) for x, y, z in itertools.product(
        *(range(n) for n in plan.grid_cb))]
    assert sorted(pairs) == [
        (bi, c, g, qt, si) for bi in range(b) for c in range(nc)
        for g in range(G) for qt in range(nqt) for si in range(qt + 1)]
    assert plan.cb_shape == (b, nc, G, nqt * TILE, nqt * TILE)


def test_ssd_plan_heads_per_block_fills_the_card():
    """Up to 8 heads of a group share a block while the grid still has a
    block for every SM; fewer when the chunks alone do not give enough."""
    assert ssd_plan(1, 2048, 80, 64, 1, 128, 256).heads_per_block == 8
    assert ssd_plan(1, 1536, 80, 64, 1, 128, 256).heads_per_block == 8
    p = ssd_plan(1, 200, 80, 64, 1, 128, 200)
    assert p.heads_per_block == 2 and 4 * 80 // 2 >= 132
    assert ssd_plan(1, 1, 80, 64, 1, 128, 1).heads_per_block == 1
    # G = 2: a block's heads never straddle the groups
    assert ssd_plan(1, 2048, 6, 64, 2, 128, 256).heads_per_block == 1
    assert ssd_plan(4, 2048, 8, 64, 2, 128, 256).heads_per_block == 4


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_ssd_bwd_plan_serves_every_tile_once(shape):
    """The gradient's launch plan: every (batch, chunk, head, 64-row tile)
    served once by a source-side, a head-side and a query-side block,
    each block's heads in one group, the heaviest tiles first; the scratch
    shapes, with no (b, S, nh, N) row a head."""
    b, S, nh, G, chunk = shape
    hd, N = 64, 128
    p = ssd_bwd_plan(b, S, nh, hd, G, N, chunk)
    nc, nqt = S // chunk, -(-chunk // TILE)
    QP, hb, rep = nqt * TILE, p.heads_per_block, nh // G
    assert (p.chunks, p.q_tiles) == (nc, nqt)
    assert hb == ssd_plan(b, S, nh, hd, G, N, chunk).heads_per_block
    assert 1 <= hb <= MAX_HEADS_PER_BLOCK and rep % hb == 0
    want = list(itertools.product(range(b), range(nc), range(nh),
                                  range(nqt)))
    seen = []
    for x, y, z in itertools.product(*(range(n) for n in p.grid_head)):
        bi, c, tile, h = p.head_block(x, y, z)
        seen.append((bi, c, h, tile))
    assert sorted(seen) == want
    for grid, block in ((p.grid_src, p.src_block),
                        (p.grid_qry, p.qry_block)):
        seen = []
        for x, y, z in itertools.product(*(range(n) for n in grid)):
            bi, c, tile, heads = block(x, y, z)
            assert len(heads) == hb and len({h // rep for h in heads}) == 1
            seen += [(bi, c, h, tile) for h in heads]
        assert sorted(seen) == want
    # source tile 0 pairs with every query tile, query tile nqt - 1 with
    # every source tile: each launch starts with them
    assert p.src_block(0, 0, 0)[2] == 0
    assert p.qry_block(0, 0, 0)[2] == nqt - 1
    npass = -(-hd * N // 256)
    assert p.grid_dstate == (nc, nh, b)
    assert p.grid_pass == (npass, nh, b)
    assert p.grid_scan == (nh, nc, b)
    assert p.grid_reduce[0] * 256 >= max(b * S * G * N, nh)
    nhb = nh // hb
    assert p.scratch_shapes() == dict(
        dstates=(b, nc, nh, N, hd), dsplit=(0,), hsplit=(0,),
        decay=(b, nh, nc, npass),
        dcb=(b, nc, nhb, QP, QP), vecs=(b, nc, nh, nqt + 4, QP),
        dyx=(b, nc, nh, nqt), dBp=(b, S, nhb, N), dCp=(b, S, nhb, N),
        pA=(b, nc, nh), pD=(b, nc, nh))
    assert len(p.grids) == 7 and all(len(g) == 3 for g in p.grids)
    # bf16: dS and h_in as bf16 pairs, each the states' bytes
    pb = ssd_bwd_plan(b, S, nh, hd, G, N, chunk, bf16=True)
    assert pb.split_shape == (b, nc, nh, N, hd) and pb.grids == p.grids


def test_ssd_bwd_plan_heads_per_block():
    """The forward's rule: mamba2-2.7b's and zamba2-7b's training shapes
    take 8 heads a block; a group of 4 heads takes 4, 2 or 1 as the SMs
    ask; the dB / dC row parts shrink by the heads a block."""
    p = ssd_bwd_plan(2, 2048, 80, 64, 1, 128, 256)
    assert p.heads_per_block == 8 and p.parts_shape == (2, 2048, 10, 128)
    assert ssd_bwd_plan(2, 2048, 112, 64, 1, 64, 256).heads_per_block == 8
    for sms, hb in ((16, 4), (32, 2), (64, 1)):
        assert ssd_bwd_plan(2, 200, 8, 16, 2, 32, 100,
                            sms).heads_per_block == hb


SPLIT_SHAPES = [
    # (b, S, nh, hd, G, N, chunk)
    (2, 64, 4, 8, 2, 16, 16),
    (1, 256, 4, 16, 1, 32, 128),             # two query tiles a chunk
    (1, 400, 4, 16, 2, 16, 200),             # ragged query tiles, G = 2
    (1, 200, 2, 16, 1, 16, 200),             # one ragged chunk
    (2, 1, 4, 16, 2, 16, 1),                 # a 1-token prompt
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_ref_matches_jax_kernel_and_oracles(shape):
    b, S, nh, hd, G, N, chunk = shape
    arrs = _inputs(0, b, S, nh, hd, G, N)
    y, h = ssd_scan_split_ref(*[torch.from_numpy(a) for a in arrs],
                              chunk=chunk)
    assert y.dtype == torch.float32 and tuple(h.shape) == (b, nh, hd, N)
    j = [jnp.asarray(a) for a in arrs]
    for want_y, want_h in (jx_scan(*j, chunk=chunk, interpret=True),
                           jx_ssd.ssd_reference(*j)):
        _close(y, want_y)
        _close(h, want_h)


@pytest.mark.parametrize("shape", [(2, 48, 4, 16, 2, 32, 16),
                                   (1, 200, 4, 8, 2, 16, 200),
                                   (2, 1, 4, 16, 2, 16, 1)])
def test_split_ref_with_initial_state(shape):
    """h0 (the hybrid family passes one), with several chunks, a ragged
    chunk and a 1-token prompt: against JAX `ssd_chunked(h0=)` and the
    sequential recurrence from the same state, and the port's chunked
    plain version."""
    b, S, nh, hd, G, N, chunk = shape
    arrs = _inputs(2, b, S, nh, hd, G, N)
    h0 = np.random.default_rng(3).standard_normal(
        (b, nh, hd, N)).astype(np.float32)
    t = [torch.from_numpy(a) for a in arrs]
    y, h = ssd_scan_split_ref(*t, chunk=chunk, h0=torch.from_numpy(h0))
    j = [jnp.asarray(a) for a in arrs]
    for want_y, want_h in (jx_ssd.ssd_chunked(*j, chunk, h0=jnp.asarray(h0)),
                           jx_ssd.ssd_reference(*j, h0=jnp.asarray(h0))):
        _close(y, want_y)
        _close(h, want_h)
    ry, rh = ssd_scan_ref(*t, chunk=chunk, h0=torch.from_numpy(h0))
    _close(y, ry.numpy())
    _close(h, rh.numpy())


def test_split_ref_bf16_inputs_keep_the_state_in_f32():
    """bf16 x, B, C: y comes back bf16 within one rounding of JAX, h_final
    in f32 at the f32 tolerance, as the kernel's state path must."""
    b, S, nh, hd, G, N, chunk = 1, 128, 4, 16, 1, 32, 64
    x, dt, A, B, C, D = _inputs(4, b, S, nh, hd, G, N)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C)]
    y, h = ssd_scan_split_ref(tb[0], torch.from_numpy(dt),
                              torch.from_numpy(A), tb[1], tb[2],
                              torch.from_numpy(D), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, B, C)]
    jy, jh = jx_ssd.ssd_chunked(jb[0], jnp.asarray(dt), jnp.asarray(A),
                                jb[1], jb[2], jnp.asarray(D), chunk)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=3e-2, rtol=3e-2)
    _close(h, jh)
