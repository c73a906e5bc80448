"""The arithmetic from a run's requests and spans to the end-to-end and
span metrics, on hand-made runs."""
from __future__ import annotations

import types

import numpy as np
import pytest

from bench import reduce
from bench.cell import load_module, BENCH
from bench.serve import Req, Run


def _metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py").read


def _run(reqs, w0=1.0, w1=11.0, spans=None, limits=(0.5, 0.1)):
    cell = types.SimpleNamespace(
        traffic={"limits": {"ttft_s": limits[0], "tpot_s": limits[1]},
                 "drain_cap_s": 30.0},
        config={"num_hidden_layers": 2, "hidden_size": 64,
                "num_attention_heads": 4, "num_key_value_heads": 2,
                "head_dim": 16, "intermediate_size": 128,
                "vocab_size": 256})
    run = Run(cell, 0, None, 1.0, {})
    run.w0, run.w1 = w0, w1
    run.requests = reqs
    run.spans = spans
    return run


def _req(rid, arrive, times, in_len=10, out_len=None, finished=True):
    r = Req(rid, arrive, in_len, out_len or len(times), [])
    r.times = tuple(times)
    r.first = times[0] if times else -1.0
    r.finished = finished
    return r


def test_percentile_is_numpys_linear():
    xs = list(np.random.default_rng(0).random(37))
    for q in (0.1, 0.5, 0.9, 0.99):
        assert reduce.percentile(xs, q) == pytest.approx(
            np.percentile(xs, 100 * q))


def test_attainment_counts_failures_and_unfinished_as_misses():
    reqs = [
        _req(0, 2.0, [2.2, 2.3, 2.4]),                 # meets both
        _req(1, 3.0, [3.9, 4.0]),                      # TTFT 0.9 misses
        _req(2, 4.0, [4.1, 4.5, 4.9]),                 # TPOT 0.4 misses
        _req(3, 5.0, [5.1], out_len=3, finished=False),  # never finished
        _req(4, 6.0, [], out_len=2, finished=False),   # never started
        _req(5, 7.0, [7.05]),                          # one token: TTFT only
        _req(6, 0.5, [0.6, 0.7]),                      # before the window
    ]
    run = _run(reqs)
    assert len(run.window) == 6
    assert _metric("slo_attainment")(run) == pytest.approx(2 / 6)
    # the never-started request waits until the drain's cap
    ttfts = sorted(reduce.ttft(run, r) for r in run.window)
    assert ttfts[-1] == pytest.approx(11.0 + 30.0 - 6.0)
    assert _metric("ttft_p90_s")(run) == pytest.approx(
        reduce.percentile(ttfts, 0.9))
    # TPOT over the finished ones of two or more tokens
    assert _metric("tpot_p90_s")(run) == pytest.approx(
        reduce.percentile([0.1, 0.1, 0.4], 0.9))


def test_tokens_per_s_counts_work_landed_in_the_window():
    reqs = [
        _req(0, 0.2, [0.5, 1.5, 2.5], in_len=100),   # prompt before w0
        _req(1, 5.0, [6.0, 7.0], in_len=40),
        _req(2, 9.0, [10.5, 11.5, 12.0], in_len=7),  # two tokens after w1
    ]
    run = _run(reqs)
    pre, out = reduce.tokens_in_window(run)
    assert (pre, out) == (40 + 7, 2 + 2 + 1)
    assert _metric("tokens_per_s")(run) == pytest.approx(52 / 10.0)


def _span(name, t0, t1, **args):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, dur=t1 - t0,
                                 rid=args.pop("rid", None), args=args)


def test_decode_steps_find_each_members_context():
    reqs = [_req(0, 2.0, [2.5, 3.0, 3.5], in_len=10),
            _req(1, 2.1, [2.9, 3.5], in_len=20)]
    spans = [_span("decode_step", 2.5, 3.0, batch=1),
             _span("decode_step", 3.0, 3.5, batch=2),
             _span("prefill_batch", 2.8, 2.9, tokens=20),
             _span("queued", 2.1, 2.8, rid=1)]
    run = _run(reqs, spans=spans)
    steps = reduce.decode_steps(run)
    assert [c for _, c in steps] == [[11], [12, 21]]
    assert _metric("decode_step_ms")(run) == pytest.approx(500.0)
    assert _metric("decode_batch_mean.peak")(run) == pytest.approx(1.5)
    assert _metric("prefill_step_ms")(run) == pytest.approx(100.0)
    assert _metric("queue_wait_p90_s")(run) == pytest.approx(0.7)
    # the profiled stretch's spans stay out of the step times
    run.profiled = (1, 2)
    assert _metric("decode_step_ms")(run) == pytest.approx(500.0)
    assert [c for _, c in reduce.decode_steps(run, profiled=True)] == \
        [[12, 21]]


def test_idle_share_reads_the_profile():
    p = types.SimpleNamespace(window_s=2.0, busy_s=0.5, ops=[("k", 0, 1)])
    run = _run([])
    run.profile = p
    assert _metric("device_idle_share")(run) == pytest.approx(75.0)
    assert _metric("device_idle_share.peak")(run) == pytest.approx(75.0)
    run.profile = None
    assert _metric("device_idle_share")(run) is None
