"""A cell small enough for the CPU tests, made of files in a folder of
its own: the way a later change adds a cell (a config, a traffic mix and
an entry; the metric readers and the reference are the benchmark's)."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from .cell import BENCH, ROOT

CONFIG = {
    "name": "tiny", "source": "the CPU tests", "family": "dense",
    "reference": "dense", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "num_hidden_layers": 2, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "vocab_size": 256, "sliding_window": None,
}

TRAFFIC = {
    "prompt": {"mu": 3.7, "sigma": 0.5, "clip": [16, 96]},
    "output": {"mu": 2.0, "sigma": 0.5, "clip": [2, 16]},
    "pool": 512, "pool_seed": 0, "knee_rps": 120.0, "rate_factor": 0.5,
    "ramp_s": 0.05, "drain_cap_s": 120.0, "drain_wall_s": 120.0,
    "cluster": {"n_prefill": 1, "n_decode": 1, "max_batch": 8,
                "max_len": 128, "page_size": 16, "decode_num_pages": 80,
                "transfer_bandwidth": 450e9, "blob_reserve": 2},
    "slo_rule": "longbench", "limits": {"ttft_s": 1.0, "tpot_s": 1.0},
    # the program read at most 0.031 and the float8 control at least
    # 0.0615 over 20 seeds on the CPU (all of a 1 s window's requests)
    "check": {"sample_tokens": 40, "widest_gap": 0.045},
    "profile": {"delay_s": 0.05, "seconds": 0.1},
    "warmup_prompts": [16, 32, 64, 96],
}


def make(tmp: Path, traffic=None, name: str = "tiny.mix"):
    """Write the tiny cell's files under `tmp` and return (bench, root):
    a BENCHMARK.json-like dict that holds the repo's metrics and one more
    entry, and the folder to find the files in."""
    root = Path(tmp)
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "traffic").mkdir(parents=True, exist_ok=True)
    for f in ("dense.py", "dense_model.py"):
        shutil.copy(BENCH / "configs" / f, root / "configs")
    if not (root / "metrics").exists():
        shutil.copytree(BENCH / "metrics", root / "metrics")
    (root / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "tiny.json").write_text(
        json.dumps(traffic or TRAFFIC))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "the CPU tests"})
    # every metric of the repo's cells is reported in the new cell too
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench, root


def traffic(**changes):
    t = copy.deepcopy(TRAFFIC)
    for k, v in changes.items():
        t[k] = v
    return t
