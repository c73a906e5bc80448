"""The harness end to end on the CPU at a tiny size (the port's plain
versions stand in for the kernels): a cell made only of added files runs
and comes out correct; the float8 control and each fault the cell can
have, planted under the timed path, come out not correct."""
from __future__ import annotations

import time

import pytest
import torch

from bench import check, serve, tinycell
from bench import run as bench_run
from bench.cell import load_cell

ARGS = ["--workload", "tiny.mix", "--seed", "2147483659"]


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny cell's steps are timed: one thread a test keeps them short
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, trace=0, traffic=None, seconds="1.0"):
    bench, root = tinycell.make(tmp_path, traffic)
    return bench_run.main(ARGS + ["--seconds", seconds, "--trace",
                                  str(trace)], device="cpu", bench=bench,
                          root=root)


def test_new_cell_runs_from_added_files(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ttft_p90_s", "tpot_p90_s",
                                   "tokens_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "check"
    assert out["device"]["count"] == 1
    assert 0 < out["device"]["kv_pages_peak"] < out["device"]["kv_pages"]


def test_traced_run_reports_the_span_metrics(tmp_path):
    # the profiler's start costs most of a second on the CPU
    out = _run(tmp_path, trace=1, seconds="3.0")
    assert out["correct"], out["check"]
    m = out["metrics"]
    for name in ("prefill_step_ms", "decode_step_ms", "mfu.prefill",
                 "mfu.decode", "decode_batch_mean.peak"):
        assert m[name]["value"] > 0, name
    # no device here: the trace's readers find nothing and say nothing
    assert "flash_prefill_roofline" not in m
    assert "device_idle_share" not in m
    assert out["device"]["window_s"] > 0


def test_the_float8_control_fails_the_limit(tmp_path):
    bench, root = tinycell.make(tmp_path)
    cell = load_cell("tiny.mix", bench, root)
    run = serve.serve(cell, 7, 1.0, False, "cpu", time.perf_counter())
    reqs = [r for r in run.window if r.finished]
    assert sum(len(r.served) for r in reqs) >= 80
    g = check.gaps(run, reqs, control=True)
    limit = run.cell.traffic["check"]["widest_gap"]
    assert g["program"] <= limit < g["control"], g


def _alter_every_second_token(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.Engine.decode_step

    def step(self, seqs):
        dt = orig(self, seqs)
        for s in seqs:
            if s.produced == 2:
                s.tokens[-1] = (s.tokens[-1] + 1) % self.cfg.vocab_size
        return dt
    monkeypatch.setattr(engine.Engine, "decode_step", step)


def _migration_leaves_pages_unchanged(monkeypatch):
    from repro_torch.serving import engine
    monkeypatch.setattr(engine.Engine, "_write_pages",
                        lambda self, segs, ids: None)


def _decode_leaves_cache_unchanged(monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.decode_step_paged

    def step(params, cache, tokens, cfg, plain=False):
        saved = {k: {p: v[p].clone() for p in ("k", "v")}
                 for k, v in cache.items() if k.startswith("seg")}
        pos = cache["pos"].clone()
        logits, cache = orig(params, cache, tokens, cfg, plain=plain)
        for k, v in saved.items():
            for p in ("k", "v"):
                cache[k][p].copy_(v[p])
        cache["pos"].copy_(pos)
        return logits, cache
    monkeypatch.setattr(transformer, "decode_step_paged", step)


def _half_the_batch_left_out(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.Engine.decode_step

    def step(self, seqs):
        keep = seqs[:(len(seqs) + 1) // 2]
        dt = orig(self, keep)
        for s in seqs[len(keep):]:
            s.append_token(s.tokens[-1])    # not computed: repeated
        return dt
    monkeypatch.setattr(engine.Engine, "decode_step", step)


@pytest.mark.parametrize("fault", [
    _alter_every_second_token, _migration_leaves_pages_unchanged,
    _decode_leaves_cache_unchanged, _half_the_batch_left_out])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, monkeypatch,
                                                     fault):
    fault(monkeypatch)
    # a higher rate keeps the decode batch at two or more
    out = _run(tmp_path, traffic=tinycell.traffic(rate_factor=1.0))
    assert not out["correct"], out["check"]


def test_without_a_card_the_command_exits_2_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        bench_run.main(["--workload", "yi-6b.summarize", "--seed", "1",
                        "--seconds", "1", "--trace", "0"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""
