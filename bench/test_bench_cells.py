"""BENCHMARK.json and the files it names: every cell's configuration,
traffic and metrics are found by name; the file keeps to the contract's
shapes; the configurations build the port's models; the weights take the
port's layout; the plain reference agrees with the port's CPU path; and
nothing `bench/run.py` runs loads JAX or the JAX package."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from bench import tinycell
from bench.cell import BENCH, ROOT, load_cell, load_module
from bench.model import family

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files_by_name(name):
    cell = load_cell(name)
    assert cell.chips == 1
    assert {m.name for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)
    t = cell.traffic
    assert t["limits"]["ttft_s"] > 0 and t["limits"]["tpot_s"] > 0
    assert t["check"]["widest_gap"] > 0
    assert t["cluster"]["decode_num_pages"] > t["cluster"]["max_len"] // 16


def test_the_file_keeps_the_contracts_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (names, CELLS, [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    # a per-layer metric's cells report the end-to-end metric it moves
    by = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = by[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved), m["name"]


def test_a_model_family_comes_as_files_alone(tmp_path):
    # a family named by the config is found as configs/<family>_model.py
    # under the cell's folder, beside the config and its reference
    bench, root = tinycell.make(tmp_path)
    src = (BENCH / "configs" / "dense_model.py").read_text()
    (root / "configs" / "tinyfam_model.py").write_text(
        src + "\nMARK = 'tinyfam'\n")
    cfg = dict(tinycell.CONFIG, family="tinyfam")
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    cell = load_cell("tiny.mix", bench, root)
    assert cell.model.MARK == "tinyfam"
    params = cell.model.draw_weights(cfg, 5, "cpu")
    assert params["embed"].shape == (cfg["vocab_size"], cfg["hidden_size"])
    assert cell.model.model_config(cfg).family == "dense"


def test_yi_6b_file_builds_the_ports_yi_6b():
    from repro_torch.configs.archs import YI_6B
    cfg = json.loads((BENCH / "configs" / "yi-6b.json").read_text())
    mine = family(cfg).model_config(cfg)
    for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "d_ff", "vocab_size", "head_dim", "rope_theta", "norm_eps",
              "sliding_window", "tie_embeddings"):
        assert getattr(mine, f) == getattr(YI_6B, f), f


def test_weights_take_the_ports_layout():
    from repro_torch.models.api import build_model
    M = family(tinycell.CONFIG)
    params = M.draw_weights(tinycell.CONFIG, 1, "cpu")
    shapes, _ = build_model(M.model_config(tinycell.CONFIG)).param_axes()

    def flat(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{pre}{k}.").items()}
        return {pre[:-1]: tuple(t.shape)}
    assert flat(params) == flat(shapes)
    assert all(p.dtype == torch.bfloat16
               for p in flat_tensors(params))


def flat_tensors(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in flat_tensors(v)]
    return [t]


def test_reference_agrees_with_the_ports_cpu_path():
    from repro_torch.models.api import build_model
    cfg = dict(tinycell.CONFIG, torch_dtype="float32", rope_theta=5e5)
    M = family(cfg)
    params = M.draw_weights(cfg, 11, "cpu")
    model = build_model(M.model_config(cfg))
    toks = torch.randint(1, cfg["vocab_size"], (1, 37),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port, _ = model.forward(params, {"tokens": toks})
        ref = load_module(BENCH / "configs" / "dense.py").logits(
            params, cfg, toks[0], 0)
    torch.testing.assert_close(ref, port[0].float(), rtol=1e-4, atol=1e-4)


def test_nothing_the_command_runs_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[0:0] = [%r, %r]\n"
        "from bench import run, serve, check, devtrace, calibrate\n"
        "from bench.cell import load_cell\n"
        "for c in %r: load_cell(c)\n"
        "import repro_torch.serving.cluster, repro_torch.core.telemetry\n"
        "import repro_torch.serving.engine, repro_torch.models.api\n"
        "print(' '.join(run.forbidden_modules()))\n"
    ) % (str(ROOT), str(ROOT / "src"), CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('r', %r)\n"
        "m = importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(m)\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & "
        "{'repro_torch', 'repro', 'jax', 'bench'}))\n"
    ) % str(BENCH / "configs" / "dense.py")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
