"""Each roofline's and MFU's operations and bytes against a hand count at
a small shape, and the layer products against a flop counter run over
the plain reference."""
from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import reduce, tinycell
from bench.cell import BENCH, load_module
from bench.model import family

DENSE = family(tinycell.CONFIG)
N = DENSE.dims(tinycell.CONFIG)  # L 2, d 64, H 4, Hkv 2, hd 16, ff 128, V 256


def _m(name):
    return load_module(BENCH / "metrics" / f"{name}.py")


def _layer_weights(n):
    # wq, wk, wv, wo; the FFN's gate, up and down
    return (n["d"] * n["H"] * n["hd"] + 2 * n["d"] * n["Hkv"] * n["hd"]
            + n["H"] * n["hd"] * n["d"] + 3 * n["d"] * n["ff"])


def test_flash_prefill_work_by_hand():
    S = 3
    flops, byts = _m("flash_prefill_roofline").work(N, S)
    pairs = sum(1 for q in range(S) for k in range(S) if k <= q)   # 6
    # per layer and head: QK^T and PV, hd multiply-adds a pair each
    assert flops == N["L"] * N["H"] * pairs * 2 * (2 * N["hd"])
    q = S * N["H"] * N["hd"]
    kv = 2 * S * N["Hkv"] * N["hd"]
    assert byts == N["L"] * (q + kv + q) * 2


def test_paged_decode_work_by_hand():
    ctxs = [5, 9]
    flops, byts = _m("paged_decode_roofline").work(N, ctxs)
    assert flops == N["L"] * N["H"] * sum(ctxs) * 2 * (2 * N["hd"])
    kv_read = sum(ctxs) * 2 * N["Hkv"] * N["hd"]
    q_o = len(ctxs) * 2 * N["H"] * N["hd"]
    row = len(ctxs) * 2 * N["Hkv"] * N["hd"]
    assert byts == N["L"] * (kv_read + q_o + row) * 2


def test_prefill_model_flops_by_hand():
    S = 7
    f = _m("mfu.prefill").prefill_flops(N, S)
    attn = N["L"] * N["H"] * (S * (S + 1) // 2) * 4 * N["hd"]
    assert f == 2 * S * N["L"] * _layer_weights(N) + attn \
        + 2 * N["d"] * N["V"]


def test_decode_step_work_by_hand():
    ctxs = [4, 6, 11]
    f, b = _m("mfu.decode").step_work(N, ctxs)
    af, ab = _m("paged_decode_roofline").work(N, ctxs)
    weights = N["L"] * _layer_weights(N) + N["d"] * N["V"]
    assert f == 2 * len(ctxs) * weights + af
    assert b == 2 * (weights + len(ctxs) * N["d"]) + ab


def test_layer_products_match_a_flop_counter_over_the_reference():
    ref = load_module(BENCH / "configs" / "dense.py")
    params = DENSE.draw_weights(tinycell.CONFIG, 3, "cpu")
    T, first = 9, 4
    toks = torch.arange(1, T + 1)
    with FlopCounterMode(display=False) as fc:
        ref.logits(params, tinycell.CONFIG, toks, first)
    # the reference scores every (q, k) pair and masks: T^2 pairs
    attn_full = N["L"] * N["H"] * T * T * 4 * N["hd"]
    assert fc.get_total_flops() == 2 * T * reduce.matmul_params(N) \
        + attn_full + 2 * (T - first) * N["d"] * N["V"]


def test_roofline_share_is_the_larger_bound():
    assert reduce.roofline_share(989e12, 0, 2.0) == pytest.approx(50.0)
    assert reduce.roofline_share(0, 3.35e12, 4.0) == pytest.approx(25.0)
    assert reduce.roofline_share(0, 0, 1.0) is None


def test_kernel_patterns_take_the_forward_kernels_only():
    fp = _m("flash_prefill_roofline").KERNELS
    pd = _m("paged_decode_roofline").KERNELS
    assert fp.search("void flash_prefill_wgmma_kernel<128, 2, false>(...)")
    assert not fp.search("void flash_prefill_bwd_dkdv_kernel<128>(...)")
    assert pd.search("void paged_decode_split_kernel<bf16, 128, false, "
                     "true, float>(...)")
    assert pd.search("void paged_decode_combine_kernel<bf16, 128, false>")
    assert not pd.search("void paged_insert_kernel<bf16>(...)")


def test_the_roofline_readers_count_only_the_profiled_work():
    run = types.SimpleNamespace(
        dims=N, profile=types.SimpleNamespace(
            kernel_seconds=lambda pat: 1e-6), profiled=(0, 1), w0=0.0,
        w1=10.0, span_t0=0.0, requests=[],
        spans=[types.SimpleNamespace(name="prefill_batch", t0=1.0, t1=1.1,
                                     dur=0.1, args={"tokens": 100}),
               types.SimpleNamespace(name="prefill_batch", t0=2.0, t1=2.1,
                                     dur=0.1, args={"tokens": 999})])
    f, b = _m("flash_prefill_roofline").work(N, 100)
    want = 100 * max(f / 989e12, b / 3.35e12) / 1e-6
    assert _m("flash_prefill_roofline").read(run) == pytest.approx(want)
    assert _m("flash_prefill_roofline.peak").read(run) == \
        pytest.approx(want)
