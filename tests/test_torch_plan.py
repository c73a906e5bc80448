"""The port's planning stack and launcher against the JAX package, on the
CPU: the copied simulator, goodput, placement, replan and router modules
are the JAX sources byte for byte; the simulator's timelines, the
searches' plans, the launcher's live run, the charged live cluster, the
fleet router's decisions and the elastic replanner are equal between the
two packages (timelines and plans exactly; greedy f32 tokens with the
JAX params through `weights.from_jax`); and the H100 `Chip` fit recovers
known efficiencies."""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jx_get_config
from repro.core import hw as jhw
from repro.core.goodput import max_goodput as jx_max_goodput
from repro.core.latency_model import EngineCharge as JCharge
from repro.core.latency_model import LatencyModel as JLM
from repro.core.latency_model import Parallelism as JPar
from repro.core.placement import algo2_low_affinity as jx_algo2
from repro.core.replan import Replanner as JReplanner
from repro.core.simulator import InstanceConfig as JInst
from repro.core.simulator import SimDisaggBackend as JSim
from repro.core.simulator import simulate_disaggregated as jx_simulate
from repro.core.workload import Request as JRequest
from repro.core.workload import WORKLOADS as JWORKLOADS
from repro.core.workload import derive_slos as jx_derive_slos
from repro.core.workload import sample_requests as jx_sample
from repro.models.api import build_model as jx_build
from repro.serving.cluster import DisaggCluster as JDisagg
from repro.serving import router as jrouter
from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.core.goodput import max_goodput
from repro_torch.core.h100 import H100, fit_chip
from repro_torch.core.latency_model import (EngineCharge, LatencyModel,
                                            Parallelism)
from repro_torch.core.replan import Replanner
from repro_torch.core.simulator import (InstanceConfig, SimDisaggBackend,
                                        simulate_disaggregated)
from repro_torch.core.workload import WORKLOADS, Request, sample_requests
from repro_torch.launch.serve import live_trace, plan, serve_live
from repro_torch.serving import router
from repro_torch.serving.cluster import DisaggCluster
from repro_torch.weights import from_jax

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["core/simulator.py", "core/goodput.py", "core/placement.py",
          "core/replan.py", "serving/router.py"] + [
    f"configs/{m}.py" for m in (
        "yi_6b", "gemma3_1b", "mamba2_2p7b", "chatglm3_6b", "internvl2_76b",
        "mixtral_8x22b", "moonshot_v1_16b_a3b", "phi3_medium_14b",
        "seamless_m4t_large_v2", "zamba2_7b")]
SMOKE = "yi-6b-smoke"
CFG, JCFG = get_config(SMOKE), jx_get_config(SMOKE)
# the H100 Chip as the JAX package builds it, field by field
JH100 = jhw.Chip(**dataclasses.asdict(H100))
CHIPS = {"v5e": (hw.V5E, jhw.V5E), "h100": (H100, JH100)}
# the H100 charge with a fixed 8 ms a step. The fitted H100 has none (the
# replayed decode step's fixed part sits in its `hbm_eff`, at yi-6b's
# width), so the smoke model's steps would take microseconds there and no
# two requests of a trace 0.05 s apart would meet at a replica
H100_STEP = dataclasses.replace(H100, step_overhead=8e-3)
PAR, JPAR = Parallelism(), JPar()


@pytest.fixture(scope="module")
def jparams():
    return jx_build(JCFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def v5e_plan():
    """The JAX launcher's plan through the port's `plan`, at one node of
    two chips: (spec, placement)."""
    _, spec, placement = plan(get_config("yi-6b"), "sharegpt", 8.0, "low",
                              1, 2, 200, chip=hw.V5E)
    return spec, placement


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_jax_source(rel):
    port = (ROOT / "src" / "repro_torch" / rel).read_text().splitlines(True)
    assert port[0] == f"# Copied unchanged from src/repro/{rel}.\n"
    assert "".join(port[1:]) == (ROOT / "src" / "repro" / rel).read_text()


def test_port_configs_mirror_jax():
    from repro.configs import yi_6b as jx_yi
    from repro_torch.configs import yi_6b
    assert dataclasses.asdict(yi_6b.CONFIG) == dataclasses.asdict(jx_yi.CONFIG)
    assert dataclasses.asdict(yi_6b.SMOKE) == dataclasses.asdict(jx_yi.SMOKE)


def _times(reqs):
    return {r.rid: (r.ttft, r.tpot, r.finish) for r in reqs}


@pytest.mark.parametrize("chip", sorted(CHIPS))
def test_simulate_disaggregated_matches_jax(chip):
    tchip, jchip = CHIPS[chip]
    lm, jlm = LatencyModel(get_config("yi-6b"), tchip), \
        JLM(jx_get_config("yi-6b"), jchip)
    got, gx = simulate_disaggregated(
        sample_requests(WORKLOADS["sharegpt"], 8.0, 120, seed=3), lm,
        InstanceConfig(PAR, 2), InstanceConfig(PAR, 1), transfer_bw=25e9)
    want, wx = jx_simulate(
        jx_sample(JWORKLOADS["sharegpt"], 8.0, 120, seed=3), jlm,
        JInst(JPAR, 2), JInst(JPAR, 1), transfer_bw=25e9)
    assert _times(got) == _times(want)
    assert gx["kv_total"] == wx["kv_total"]
    assert all(r.finish > r.first_token > 0 for r in got)


def _jx_search(chip, **kw):
    """Alg. 2 as the JAX launcher runs it (yi-6b, sharegpt, rate 8)."""
    jlm = JLM(jx_get_config("yi-6b"), chip)
    spec = jx_derive_slos(JWORKLOADS["sharegpt"], jlm)
    return jx_algo2(jlm, spec, rate=8.0, chip=chip, **kw)


def _summary(p):
    return {k: v for k, v in p.summary().items() if k != "search_s"}


def test_max_goodput_matches_jax():
    cfg, jcfg = get_config("yi-6b"), jx_get_config("yi-6b")
    lm, jlm = LatencyModel(cfg, H100), JLM(jcfg, JH100)
    spec = WORKLOADS["humaneval"]

    def run(reqs):
        return simulate_disaggregated(reqs, lm, InstanceConfig(PAR, 1),
                                      InstanceConfig(PAR, 1),
                                      transfer_bw=H100.ici_bw)

    def jrun(reqs):
        return jx_simulate(reqs, jlm, JInst(JPAR, 1), JInst(JPAR, 1),
                           transfer_bw=JH100.ici_bw)
    got = max_goodput(run, spec, 2, n_requests=100, iters=6)
    want = jx_max_goodput(jrun, JWORKLOADS["humaneval"], 2, n_requests=100,
                          iters=6)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rate > 0


def test_serve_live_matches_jax_launcher(params, jparams, v5e_plan):
    """`serve_live` on the CPU against the body of the JAX launcher's
    `--live` run (its V5E plan, its cluster, its trace), same params."""
    spec, placement = v5e_plan
    res, cluster = serve_live(CFG, placement, spec, params=params,
                              device="cpu")
    jp = _jx_search(jhw.V5E, n_node=1, m_per_node=2, n_requests=200)
    assert _summary(placement) == _summary(jp)
    jspec = jx_derive_slos(JWORKLOADS["sharegpt"],
                           JLM(jx_get_config("yi-6b"), jhw.V5E))
    jc = JDisagg(JCFG, jparams, n_prefill=min(jp.n_prefill, 2),
                 n_decode=min(jp.n_decode, 2), max_batch=4, max_len=96,
                 lm_tokens=64)
    jres = jc.run([JRequest(r.rid, r.arrive, min(r.in_len, 48),
                            min(r.out_len, 8))
                   for r in jx_sample(jspec, 20.0, 12, seed=0)])
    assert len(res) == len(jres) == 12
    assert len(cluster.prefill) == len(jc.prefill) == min(jp.n_prefill, 2)
    assert len(cluster.decode) == len(jc.decode) == min(jp.n_decode, 2)
    for rid in jres:
        assert res[rid].tokens == jres[rid].tokens, rid
    assert cluster.tx.total_bytes == jc.tx.total_bytes > 0


def _spaced(trace, gap):
    """The same requests, each arriving `gap` seconds after the one
    before: no migration reaches a decode instance mid-step."""
    return [dataclasses.replace(r, arrive=gap * (i + 1))
            for i, r in enumerate(trace)]


@pytest.mark.parametrize("chunk_tokens", [None, 32])
@pytest.mark.parametrize("spaced", [False, True])
def test_charged_live_matches_jax_and_sim(params, jparams, v5e_plan,
                                          chunk_tokens, spaced):
    """The launcher's cluster under `EngineCharge(LatencyModel(cfg, H100))`
    against the JAX live cluster under the same charge: per-request token
    times equal to the float, the same tokens and dispatch decisions.

    On the launcher's trace (rate 20) the live cluster and the simulator
    differ in the JAX package itself: a live decode instance pulls a
    migrant's KV when it next polls, after its running step, and the
    simulator pulls it at dispatch. With the requests `_spaced`, every
    migration reaches an idle decode instance, and the port's live
    cluster equals the port's `SimDisaggBackend` too, as
    `tests/test_role_unified.py` holds in JAX. Prompts of up to 48
    tokens against `lm_tokens=1`: the sim batches one prompt a prefill,
    as a live prefill engine does."""
    spec, placement = v5e_plan
    lm = LatencyModel(CFG, H100)
    trace = live_trace(spec, 12, 20.0, 48, 8)
    if spaced:
        trace = _spaced(trace, 1.0)
    cluster = DisaggCluster(CFG, params, n_prefill=min(placement.n_prefill, 2),
                            n_decode=min(placement.n_decode, 2), max_batch=4,
                            max_len=96, lm_tokens=1, chunk_tokens=chunk_tokens,
                            charge=EngineCharge(lm, PAR), device="cpu")
    jc = JDisagg(JCFG, jparams, n_prefill=len(cluster.prefill),
                 n_decode=len(cluster.decode), max_batch=4, max_len=96,
                 lm_tokens=1, chunk_tokens=chunk_tokens,
                 charge=JCharge(JLM(JCFG, JH100), JPAR))
    _submit_drain(cluster, trace)
    _submit_drain(jc, [JRequest(r.rid, r.arrive, r.in_len, r.out_len)
                       for r in trace])
    assert _token_times(cluster) == _token_times(jc)
    assert len(cluster.results) == len(jc.results) == 12
    for rid, r in cluster.results.items():
        assert r.tokens == jc.results[rid].tokens, rid
    assert cluster.dispatcher.decisions == jc.dispatcher.decisions
    assert cluster.tx.total_bytes == jc.tx.total_bytes > 0
    if chunk_tokens:
        assert sum(p.engine.chunk_dispatches for p in cluster.inst
                   if p.role == "prefill") > 0
    if spaced:
        sim = SimDisaggBackend(
            lm, InstanceConfig(PAR, len(cluster.prefill)),
            InstanceConfig(PAR, len(cluster.decode)),
            transfer_bw=cluster.tx.bandwidth, lm_tokens=1,
            chunk_tokens=chunk_tokens, max_decode_batch=4)
        _submit_drain(sim, trace)
        assert _token_times(cluster) == _token_times(sim)
        assert cluster.dispatcher.decisions == sim.disp.decisions


def _submit_drain(backend, reqs):
    for r in reqs:
        backend.submit(dataclasses.replace(r))
    backend.drain()


def _token_times(backend):
    return {rid: [e.t for e in st.events]
            for rid, st in backend.states.items()}


def _fleet_trace(cls, vocab, n=8):
    """Prompts of 20..70 tokens, the first five sharing a 24-token system
    head (a page and a half), arriving 0.05 s apart: `chip_smoke.py`'s
    serve trace at the smoke scale."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, vocab, 24).tolist()
    out = []
    for i, L in enumerate([70, 40, 20, 55, 45, 30, 64, 26][:n]):
        body = rng.integers(1, vocab, L).tolist()
        toks = (system + body)[:L] if i < 5 else body
        out.append(cls(i, 0.05 * i, L, 4 + i % 5, tokens=tuple(toks)))
    return out


def _fleet(mod, backends, trace):
    fr = mod.FleetRouter(backends, policy="prefix_affinity")
    for r in trace:
        fr.submit(r)
    return fr, fr.drain()


FLEET_KW = dict(n_prefill=1, n_decode=1, max_batch=4, max_len=96,
                lm_tokens=1, chunk_tokens=32, prefix_cache=True)


def test_fleet_router_matches_jax_and_sim(params, jparams):
    """Two port clusters behind `FleetRouter(policy="prefix_affinity")`
    under the H100 charge with 8 ms a step (`H100_STEP`): the same
    `decisions` as the JAX fleet and as a fleet of two port
    `SimDisaggBackend`s; the JAX fleet's tokens and times, and the sim
    fleet's TTFTs (later decode steps meet the
    busy-instance difference of `test_charged_live_matches_jax_and_sim`,
    which leaves the routing untouched here)."""
    lm = LatencyModel(CFG, H100_STEP)
    jchip = jhw.Chip(**dataclasses.asdict(H100_STEP))
    live = [DisaggCluster(CFG, params, device="cpu", seed=i,
                          charge=EngineCharge(lm, PAR), **FLEET_KW)
            for i in range(2)]
    jlive = [JDisagg(JCFG, jparams, seed=i,
                     charge=JCharge(JLM(JCFG, jchip), JPAR), **FLEET_KW)
             for i in range(2)]
    sims = [SimDisaggBackend(lm, InstanceConfig(PAR, 1),
                             InstanceConfig(PAR, 1),
                             transfer_bw=live[0].tx.bandwidth, lm_tokens=1,
                             chunk_tokens=32, prefix_cache=True,
                             max_decode_batch=4)
            for _ in range(2)]
    fr, res = _fleet(router, live, _fleet_trace(Request, CFG.vocab_size))
    jfr, jres = _fleet(jrouter, jlive, _fleet_trace(JRequest,
                                                    JCFG.vocab_size))
    sfr, sres = _fleet(router, sims, _fleet_trace(Request, CFG.vocab_size))
    assert fr.decisions and fr.decisions == jfr.decisions == sfr.decisions
    assert any(hit > 0 for kind, _, _, hit in fr.decisions if kind == "route")
    assert sorted(res) == sorted(jres) == sorted(sres) == list(range(8))
    for rid in res:
        assert res[rid].tokens == jres[rid].tokens, rid
        assert res[rid].ttft == jres[rid].ttft == sres[rid].ttft, rid
        assert res[rid].finish == jres[rid].finish, rid
    assert {d[2] for d in fr.decisions if d[0] == "route"} == {0, 1}
    assert sum(c.prefill[0].prefix_hit_tokens for c in live) > 0


def _replan_run(mod, sim_cls, inst_cls, lm, par, replanner_cls, req_cls):
    """`tests/test_router.py::test_elastic_replan_grows_fleet_on_drift` at
    its size: a steady phase, then rate x4 with 8x prompts; the Replanner
    fires and `elastic_callback` grows the fleet to the plan's 3."""
    def one():
        return sim_cls(lm, inst_cls(par, 1), inst_cls(par, 1),
                       lm_tokens=2048, max_decode_batch=32,
                       prefix_cache=True)
    fired = []
    fr = mod.FleetRouter(
        [one()], policy="least_loaded",
        replanner=replanner_cls(lambda spec, rate: mod.FleetPlan(3, rate, 1.0),
                                slo_ttft=0.4, slo_tpot=0.1, check_every=16),
        on_replan=lambda rt, p: (fired.append(p),
                                 mod.elastic_callback(lambda i: one())(rt, p)))
    rid = 0
    for _ in range(32):
        fr.submit(req_cls(rid, rid * 0.1, 32, 4))
        rid += 1
    fr.drain()
    size_steady = fr.fleet_size
    t = rid * 0.1
    for i in range(32):
        fr.submit(req_cls(rid, t + i * 0.025, 256, 4))
        rid += 1
    res = fr.drain()
    return fr, fired, size_steady, res


def test_replanner_grows_fleet_as_jax():
    got = _replan_run(router, SimDisaggBackend, InstanceConfig,
                      LatencyModel(get_config("yi-6b"), hw.V5E), PAR,
                      Replanner, Request)
    want = _replan_run(jrouter, JSim, JInst,
                       JLM(jx_get_config("yi-6b"), jhw.V5E), JPAR,
                       JReplanner, JRequest)
    fr, fired, steady, res = got
    jfr, jfired, jsteady, jres = want
    assert steady == jsteady == 1
    assert fired and [dataclasses.asdict(p) for p in fired] == \
        [dataclasses.asdict(p) for p in jfired]
    assert fr.fleet_size == jfr.fleet_size == 3
    assert fr.decisions == jfr.decisions
    assert len(res) == len(jres) == 64
    for rid in res:
        assert (res[rid].ttft, res[rid].finish) == \
            (jres[rid].ttft, jres[rid].finish), rid


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-1b"])
def test_fit_chip_recovers_known_efficiencies(arch):
    """Step times made by a known Chip through the latency model's own
    forms (compute-bound prefill, memory-bound decode at the fit's
    contexts of 1k-8k tokens a sequence) give that Chip's fields back."""
    cfg = get_config(arch)
    true = dataclasses.replace(H100, mm_eff=0.3, attn_eff=0.27,
                               hbm_eff=0.85, step_overhead=3e-3)
    lm = LatencyModel(cfg, true)
    prefill = [(L, lm.prefill_time([L], PAR)) for L in (256, 512, 1024, 1536)]
    decode = [(8, 8.0 * c, lm.decode_time(8, 8.0 * c, PAR))
              for c in (1024, 2048, 4096, 8192)]
    got = fit_chip(cfg, prefill, decode, base=H100)
    for f in ("mm_eff", "attn_eff", "hbm_eff", "step_overhead"):
        assert getattr(got, f) == pytest.approx(getattr(true, f), rel=1e-9), f
    assert (got.name, got.peak_flops_bf16, got.hbm_bw) == \
        (H100.name, H100.peak_flops_bf16, H100.hbm_bw)


def test_fit_chip_keeps_the_overhead_at_0_where_the_intercept_falls_below():
    """Decode steps that read the weights at 0.8 of the bandwidth and the
    KV at 0.2 (two kernels; the form has one rate): the unconstrained
    intercept lies below 0, so the overhead stays at 0, the one rate lands
    between the two, and the prefill stage fits with no overhead."""
    cfg = get_config("yi-6b")
    true = dataclasses.replace(H100, mm_eff=0.45, attn_eff=0.3,
                               hbm_eff=0.5, step_overhead=0.0)
    lm, bw = LatencyModel(cfg, true), H100.hbm_bw
    decode = [(b, b * c, lm.active_param_bytes(b) / (0.8 * bw)
               + lm.kv_read_bytes(b * c) / (0.2 * bw))
              for b in (8, 32, 64) for c in (1024, 4096)]
    prefill = [(L, lm.prefill_time([L], PAR)) for L in (4096, 6144, 8192)]
    got = fit_chip(cfg, prefill, decode, base=H100)
    assert got.step_overhead == 0.0
    assert 0.2 < got.hbm_eff < 0.8
    for f in ("mm_eff", "attn_eff"):
        assert getattr(got, f) == pytest.approx(getattr(true, f), rel=1e-9), f
