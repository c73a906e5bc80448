"""The reader of the decode steps' `graph` arg, on hand-made spans."""
from __future__ import annotations

import types

import pytest

from bench.cell import BENCH, load_module
from bench.serve import Run
from repro_torch.core.telemetry import Span

read = load_module(BENCH / "metrics" / "decode_graph_share.py").read


def _run(graphs, profiled=(0, 0)):
    """One `decode_step` span a virtual second from 0.5 s on (the window is
    1-11 s), arg `graph` each of `graphs` (None: no such arg)."""
    run = Run(types.SimpleNamespace(), 0, None, 1.0, {})
    run.w0, run.w1 = 1.0, 11.0
    run.span_t0 = 100.0
    run.spans = [Span("step", "decode_step", "decode0", 100.5 + i,
                      t1=100.55 + i, args={} if g is None else {"graph": g})
                 for i, g in enumerate(graphs)]
    run.profiled = profiled
    return run


def test_the_share_counts_the_window_steps_outside_the_profile():
    # 0.5 s is before the window, 11.5 s after it; steps 3-4 are profiled
    run = _run([0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0], profiled=(3, 5))
    # the window outside the profile: steps 1, 2 and 5-10
    assert read(run) == pytest.approx(100.0)
    assert read(_run([1, 0, 1, 0, 1, 1])) == pytest.approx(60.0)
    assert read(_run([1, 0, 0, 0])) == pytest.approx(0.0)


def test_steps_without_the_arg_read_none():
    """A program without the graph records no `graph`: no number, no
    error."""
    assert read(_run([None] * 4)) is None
    assert read(_run([1, None, 1])) is None
    assert read(_run([1])) is None           # no step in the window
    empty = _run([])
    empty.spans = None
    assert read(empty) is None
