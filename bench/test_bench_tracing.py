"""The readers of the engine's phase spans, the admissions' page writes and
the step ranges' idle time, on hand-made spans and profiles (host ranges
and device operations on one clock, in us)."""
from __future__ import annotations

import types

import pytest

from bench.cell import BENCH, load_module
from bench.devtrace import Profile
from bench.serve import Run
from repro_torch.core.telemetry import Span

NAMES = ("decode_launch_ms", "decode_sync_ms", "admit_device_ms",
         "decode_step_idle_share", "prefill_step_idle_share.peak")


def _metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py").read


def _run(spans=None, profile=None, profiled=(0, 0)):
    run = Run(types.SimpleNamespace(), 0, None, 1.0, {})
    run.w0, run.w1 = 1.0, 11.0
    run.span_t0 = 100.0                 # the tracer's time of arrival 0
    run.spans = spans
    run.profile = profile
    run.profiled = profiled
    return run


def _step(spans, name, t0, phases, kind="decode"):
    """A step span at virtual `t0` (since arrival 0) and its children,
    (phase, seconds) each, laid end to end; the step charges all but the
    readback."""
    i = len(spans)
    total = sum(d for p, d in phases if p != "sample")
    spans.append(Span("step", name, "decode0", 100.0 + t0, t1=100.0 + t0
                      + total, args={"compute": total}))
    t = 100.0 + t0
    for p, d in phases:
        spans.append(Span("host", f"{kind}.{p}", "decode0", t, t1=t + d,
                          args={"step": i}))
        t += d


def test_phase_means_take_the_window_steps_outside_the_profile():
    s = []
    _step(s, "decode_step", 0.5, [("launch", 0.9), ("sync", 0.9)])  # early
    _step(s, "decode_step", 2.0, [("launch", 0.040), ("sync", 0.010),
                                  ("sample", 0.5)])
    _step(s, "prefill_batch", 2.5, [("launch", 0.7), ("sync", 0.7)],
          kind="prefill")
    i0 = len(s)
    _step(s, "decode_step", 5.0, [("launch", 0.1), ("sync", 0.1)])  # profiled
    i1 = len(s)
    _step(s, "decode_step", 6.0, [("launch", 0.030), ("sync", 0.020)])
    _step(s, "decode_step", 11.5, [("launch", 0.9), ("sync", 0.9)])  # late
    run = _run(s, profiled=(i0, i1))
    assert _metric("decode_launch_ms")(run) == pytest.approx(35.0)
    assert _metric("decode_sync_ms")(run) == pytest.approx(15.0)
    # launch + sync is the steps' charged time, as `decode_step_ms` reads
    assert _metric("decode_launch_ms")(run) + _metric("decode_sync_ms")(
        run) == pytest.approx(_metric("decode_step_ms")(run)) \
        == pytest.approx(50.0)


def _profile(ops, host, launches=None):
    """Device operations and host ranges; each operation's launch call at
    its start unless `launches` gives their times."""
    p = Profile("cpu")
    p.ops = [("k", a, b) for a, b in ops]
    if launches is None:
        launches = [a for a, _ in ops]
    p.host = host + [("cudaLaunchKernel", t, t + 1) for t in launches]
    return p


def test_step_idle_shares_count_the_device_idle_inside_the_ranges():
    ops = [(0, 10), (8, 12), (15, 30), (100, 110), (300, 400)]
    host = [("cluster.poke_decode", 0, 120),      # not a step
            ("decode_step", 5, 25),               # own: 8-12, 15-30: 19
            ("decode.launch", 5, 12),             # a phase, not the step
            ("decode_step", 40, 60),              # own: none
            ("prefill_batch", 95, 115),           # own: 100-110: 10
            ("aten::mm", 200, 250)]
    run = _run(profile=_profile(ops, host))
    assert _metric("decode_step_idle_share")(run) == pytest.approx(
        100.0 * (1 + 20) / 40)
    assert _metric("prefill_step_idle_share.peak")(run) == \
        pytest.approx(50.0)


def test_admit_device_ms_averages_the_timed_writes_of_the_window():
    """An admission's operations are those launched in its `admit` range,
    wherever the device ran them; their busy time over the profiled
    stretch's admissions."""
    host = [("cluster.poke_decode", 95, 170),
            ("admit", 100, 112),                  # 105-115, 118-130: 22
            ("decode_step", 133, 165),
            ("cluster.poke_decode", 195, 260),
            ("admit", 200, 208),                  # 205-207: 2
            ("admit", 209, 220),                  # 210-218, 238-245: 15
            ("decode_step", 240, 255)]
    ops = [(0, 50),                               # the step before
           (105, 115), (118, 130),                # the last after the range
           (135, 160),                            # the decode step's
           (205, 207), (210, 214), (212, 218),    # overlapping: merged
           (238, 245),                            # queued behind the others
           (305, 309)]
    launches = [-10, 101, 111, 134, 201, 209, 210, 219, 300]
    run = _run(profile=_profile(ops, host, launches))
    assert _metric("admit_device_ms")(run) == pytest.approx(
        1e-3 * (22 + 2 + 15) / 3)


def test_device_operations_are_read_by_their_launch():
    """The profiler's device clock drifts from the host's (on an H100 host,
    by 12-213 ms over a 3 s stretch): operations launched inside
    a range count there all the same."""
    host, launches, ops = [], [], []
    for i in range(40):                   # a step every 50 ms for 2 s
        t = 50e3 * i
        host.append(("decode_step", t, t + 40e3))
        for j in range(10):               # 10 ops of 0.5 ms inside
            launches.append(t + 1e3 + 2e3 * j)
        host.append(("admit", t + 42e3, t + 42.5e3))
        launches += [t + 42.1e3, t + 42.2e3]
        host.append(("cluster.poke_decode", t + 45e3, t + 46e3))
    for t in launches:                    # each starts 5 us after launch
        d = 500 if (t % 50e3) < 41e3 else (t % 50e3 - 42e3) / 2
        ops.append((t + 5, t + 5 + d))    # an admission's: 50 and 100 us
    drift = [(a + 300 + 0.05 * a, b + 300 + 0.05 * a) for a, b in ops]
    # a launch call at the stretch's start whose operation the trace lacks
    run = _run(profile=_profile(drift, host, [-1e3] + launches))
    assert _metric("decode_step_idle_share")(run) == pytest.approx(87.5)
    assert _metric("admit_device_ms")(run) == pytest.approx(0.15)
    # more operations than launch calls: no pairing, no number
    short = _run(profile=_profile(drift, host, launches[:-1]))
    for name in ("decode_step_idle_share", "admit_device_ms"):
        assert _metric(name)(short) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_run_without_the_spans_or_ranges_reads_none(name):
    """A program that records no phases, admissions or step ranges (the
    parent of this change) gives no number and raises nothing."""
    s = []
    _step(s, "decode_step", 2.0, [])
    s.append(Span("phase", "queued", "prefill0", 101.0, rid=1, t1=102.0))
    prof = _profile([(0, 10)], [("aten::mm", 0, 5)])
    for run in (_run(s, prof), _run(None, None),
                _run(s, _profile([], [("decode_step", 0, 5)]))):
        assert _metric(name)(run) is None
