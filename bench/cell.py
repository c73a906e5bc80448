"""Find a cell's files by name.

A cell of `BENCHMARK.json` names a configuration and a traffic mix; its
metrics are the entries of `end_to_end` and `per_layer` whose
`workloads` list the cell (or that list none). Each is a file under the
benchmark's folder:

  configs/<config>.json    the model's published config, as it is run
  configs/<reference>.py   the plain reference its `reference` key names
  configs/<family>_model.py  the port's model of its `family` key
                           (`model.py`): sizes, `ModelConfig`, weights
  traffic/<traffic>.json   the mix, the cluster's settings and the limits
  metrics/<metric>.py      a reader: `read(run) -> float | None`

Nothing here lists a configuration, a mix or a metric by name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    reference: ModuleType
    model: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_module(path: Path) -> ModuleType:
    """Import a file by path (metric names carry dots, so they are no
    module names)."""
    spec = importlib.util.spec_from_file_location(
        "bench_file_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(entries, cell: str, root: Path) -> List[Metric]:
    out = []
    for m in entries:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append(Metric(m["name"], m["unit"],
                          load_module(root / "metrics" / f"{m['name']}.py")))
    return out


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              root: Path = BENCH) -> Cell:
    """The cell `name` of `bench` (default: `BENCHMARK.json` at the repo
    root), with its files read from `root`."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    config = json.loads((root / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    reference = load_module(root / "configs" / f"{config['reference']}.py")
    from bench.model import family
    return Cell(name, int(w["chips"]), config, traffic, reference,
                family(config, root),
                _metrics(bench["end_to_end"], name, root),
                _metrics(bench["per_layer"], name, root))
