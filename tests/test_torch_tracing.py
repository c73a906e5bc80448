"""The live cluster's tracing on the CPU (yi-6b-smoke, plain versions):
each engine step's `host` spans and `record_function` ranges, the
migration's `admit` span, `Request.prefill_start`, the decode steps'
`graph` arg (0 here: the decode graph is the card's), and nothing at all
of them with tracing off."""
import dataclasses
import math
from unittest import mock

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.h100 import H100
from repro_torch.core.latency_model import (EngineCharge, LatencyModel,
                                            Parallelism)
from repro_torch.core.simulator import InstanceConfig, SimDisaggBackend
from repro_torch.core.telemetry import Tracer
from repro_torch.core.workload import Request
from repro_torch.serving.cluster import ColocatedCluster, DisaggCluster
from repro_torch.serving.engine import Sequence

CFG = get_config("yi-6b-smoke")
KW = dict(max_batch=4, max_len=96, page_size=16, device="cpu")
TRACE = [Request(i, 0.01 * i, 20 + 9 * i, 3 + i % 4) for i in range(6)]
STEPS = {"decode_step": "decode", "prefill_batch": "prefill",
         "chunk": "prefill"}


def _serve(tracer=None, trace=TRACE, **kw):
    c = DisaggCluster(CFG, None, tracer=tracer, **dict(KW, **kw))
    for r in trace:
        c.submit(dataclasses.replace(r))
    c.drain()
    return c


def _tokens(c):
    return {rid: r.tokens for rid, r in c.results.items()}


@pytest.fixture(scope="module")
def runs():
    """The same trace untraced, then traced under the CPU profiler:
    (untraced cluster, traced cluster, tracer, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off = _serve()
        tr = Tracer()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = _serve(tr)
    finally:
        torch.set_num_threads(n)
    return off, on, tr, prof.events()


def _children(tr, i):
    return [s for s in tr.spans if s.cat == "host" and s.name != "admit"
            and s.args["step"] == i]


@pytest.mark.parametrize("step", ["decode_step", "prefill_batch"])
def test_each_step_is_launch_then_sync_summing_to_its_charge(runs, step):
    _, _, tr, _ = runs
    kind = STEPS[step]
    idx = [i for i, s in enumerate(tr.spans) if s.name == step]
    assert len(idx) > 3
    for i in idx:
        s = tr.spans[i]
        kids = {c.name: c for c in _children(tr, i)}
        assert sorted(kids) == sorted(f"{kind}.{p}" for p in
                                      ("launch", "sync", "sample"))
        launch, sync = kids[f"{kind}.launch"], kids[f"{kind}.sync"]
        charged = s.args["compute"] if step == "decode_step" else s.dur
        assert launch.dur + sync.dur == pytest.approx(charged, abs=1e-9)
        assert launch.t0 == s.t0 and launch.t1 == pytest.approx(sync.t0)
        # the readback follows the charged interval
        assert kids[f"{kind}.sample"].t0 >= sync.t1 - 1e-12
        assert all(c.lane == s.lane for c in kids.values())


def test_ranges_follow_the_steps_in_number_and_order(runs):
    _, _, tr, events = runs
    ranges = sorted((e for e in events if e.name in STEPS
                     or e.name.startswith(("decode.", "prefill.",
                                           "cluster.", "admit"))),
                    key=lambda e: e.time_range.start)
    steps = [s.name for s in tr.spans if s.name in STEPS]
    assert [e.name for e in ranges if e.name in STEPS] == steps
    # each phase range sits inside its umbrella, the umbrella inside the
    # cluster's event range
    umb = [e for e in ranges if e.name in STEPS]
    for e in ranges:
        if e.name.endswith((".launch", ".sync")):
            assert any(u.time_range.start <= e.time_range.start
                       and e.time_range.end <= u.time_range.end
                       for u in umb), e.name
    names = {e.name for e in ranges}
    assert {"cluster.arrive", "cluster.poke_prefill",
            "cluster.dispatch_decode", "cluster.poke_decode"} <= names
    assert sum(e.name == "admit" for e in ranges) == \
        sum(s.name == "admit" for s in tr.spans) == len(TRACE)


def test_admit_spans_count_the_pages_written(runs):
    _, on, tr, _ = runs
    admits = {s.rid: s for s in tr.spans if s.name == "admit"}
    assert sorted(admits) == [r.rid for r in TRACE]
    for r in TRACE:
        a = admits[r.rid]
        assert a.cat == "host" and a.lane == "decode0"
        assert a.args["pages"] == math.ceil(r.in_len / 16)
        assert a.args["host_s"] > 0 and a.dur == a.args["host_s"]
        # the write's device time is the device trace's, not the span's
        assert "device_s" not in a.args


def test_tracing_off_records_nothing_and_serves_the_same(runs):
    off, on, _, _ = runs
    assert _tokens(off) == _tokens(on)
    assert all(not x.engine.trace and not x.engine.phases for x in off.inst)
    assert all(x.engine.trace for x in on.inst)
    # a fresh untraced run: no range opened and no CUDA event made
    with mock.patch("torch.profiler.record_function") as rf, \
            mock.patch("torch.cuda.Event") as ev:
        again = _serve(trace=TRACE[:3])
    assert rf.call_count == 0 and ev.call_count == 0
    assert all(not x.engine.phases for x in again.inst)


def test_prefill_start_opens_the_prefilling_phase(runs):
    _, on, tr, _ = runs
    chunked_tr, prefix_tr = Tracer(), Tracer()
    chunked = _serve(chunked_tr, trace=TRACE[:4], chunk_tokens=32)
    prefix = _serve(prefix_tr, trace=TRACE[:4], prefix_cache=True)
    for c, t in ((on, tr), (chunked, chunked_tr), (prefix, prefix_tr)):
        first = {}
        for s in t.spans:
            if s.name == "prefilling":
                first.setdefault(s.rid, s.t0)
        for rid, st in c.states.items():
            r = st.request
            assert r.arrive <= r.prefill_start <= r.first_token, rid
            assert r.prefill_start == first[rid]
    # a chunk's phases, and a prefill's over a cached prefix, sum to it
    # as a whole prompt's do; both sample inside the charged interval
    for t, step in ((chunked_tr, "chunk"), (prefix_tr, "prefill_batch")):
        idx = [i for i, s in enumerate(t.spans) if s.name == step]
        assert idx
        for i in idx:
            kids = {c.name: c for c in _children(t, i)}
            launch = kids["prefill.launch"]
            assert launch.dur + kids["prefill.sync"].dur \
                == pytest.approx(t.spans[i].dur, abs=1e-9)
            if "prefill.sample" in kids:
                assert launch.t0 <= kids["prefill.sample"].t0 \
                    <= kids["prefill.sample"].t1 <= launch.t1


@pytest.mark.parametrize("chunk_tokens", [None, 32])
def test_prefill_start_equals_the_simulators_under_a_charge(chunk_tokens):
    """Requests 1 s apart, so every migration meets an idle decode
    instance and the charged live cluster's timeline is the simulator's
    (as `test_torch_plan.py` holds for the token times)."""
    par = Parallelism()
    lm = LatencyModel(CFG, H100)
    trace = [Request(i, 1.0 * (i + 1), 16 + 6 * i, 2 + i % 3)
             for i in range(5)]
    tr = Tracer()
    live = _serve(tr, trace, lm_tokens=1, chunk_tokens=chunk_tokens,
                  charge=EngineCharge(lm, par))
    sim = SimDisaggBackend(lm, InstanceConfig(par, 1), InstanceConfig(par, 1),
                           transfer_bw=live.tx.bandwidth, lm_tokens=1,
                           chunk_tokens=chunk_tokens, max_decode_batch=4)
    for r in trace:
        sim.submit(dataclasses.replace(r))
    sim.drain()
    got = {rid: st.request.prefill_start for rid, st in live.states.items()}
    want = {rid: st.request.prefill_start for rid, st in sim.states.items()}
    assert got == want and all(v > 0 for v in got.values())
    # under a charge the virtual step is the model's: no host spans
    assert not [s for s in tr.spans if s.cat == "host"]


@pytest.mark.parametrize("step", ["prefill_request", "prefill_chunk",
                                  "decode_step"])
def test_a_step_that_raises_leaves_no_range_open(step):
    """A step that fails (an out-of-memory error, say, which the failover
    paths survive) exits the ranges it entered, so that the profile does
    not label the idle time after it as that step."""
    c = DisaggCluster(CFG, None, tracer=Tracer(), **KW)
    role = "decode" if step == "decode_step" else "prefill"
    e = next(x.engine for x in c.inst if x.role == role)
    seq = Sequence(7, list(range(1, 21)), 3, slot=0)
    entered, opened = [], []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)
            opened.append(self.name)

        def __exit__(self, *exc):
            assert opened.pop() == self.name      # innermost first

    boom = mock.Mock(side_effect=RuntimeError("out of memory"))
    args = {"prefill_request": (seq,), "prefill_chunk": (seq, 32),
            "decode_step": ([seq],)}[step]
    with mock.patch("torch.profiler.record_function", Range), \
            mock.patch.object(e, "_forward_chunk", boom), \
            mock.patch.object(e.model, "decode_step_paged", boom), \
            pytest.raises(RuntimeError):
        getattr(e, step)(*args)
    assert boom.called and opened == []
    assert entered[1] == role + ".launch"


def test_cpu_engines_capture_no_decode_graph(runs):
    """The decode step's CUDA graph is the card's: on the CPU every engine
    runs the model's own launches at every step."""
    off, on, _, _ = runs
    for x in off.inst + on.inst:
        e = x.engine
        assert e.graph_captures == e.graph_replays == 0
        assert e.decode_graph is None and not e.replayed
    assert any(x.engine.decode_tokens for x in on.inst)


@pytest.mark.parametrize("cluster", ["disagg", "colocated"])
def test_every_decode_step_span_marks_graph_0_on_the_cpu(runs, cluster):
    """Both places that record a `decode_step` span say whether the step
    replayed the graph: never, on the CPU."""
    if cluster == "disagg":
        tr = runs[2]
    else:
        tr = Tracer()
        c = ColocatedCluster(CFG, None, tracer=tr, n_engines=1, **KW)
        c.run([dataclasses.replace(r) for r in TRACE[:3]])
    steps = [s for s in tr.spans if s.name == "decode_step"]
    assert len(steps) > 3
    assert all(s.args["graph"] == 0 for s in steps)
