"""Open-loop arrivals and request sizes, from a traffic file and a seed.

The schedule (the gaps between arrivals and each request's prompt and
output lengths) is drawn once from the file's `pool_seed` by a frozen
copy of the repo's lognormal sampler (`repro_torch/core/workload.py::
sample_requests`): `pool` requests, repeated if a run needs more, with
exponential gaps (Poisson arrivals) at the stated rate. It is the same
for every seed; `--seed` draws the prompts' token ids (and the weights,
`configs/<family>_model.py`). Runs on two seeds therefore do the same
work, and differ as two runs of one seed do: with the seed ordering the
sizes, the order alone moved a cell's TTFT tail by a quarter (PERF.md).
So every run sees one realisation of the arrivals, and a cell's tails
are that realisation's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

# the z-score of the 90th percentile of a normal
Z90 = 1.2815515655446004


@dataclasses.dataclass
class Arrival:
    rid: int
    t: float            # virtual seconds after the first arrival
    in_len: int
    out_len: int


def sample_block(spec: Dict, n: int, seed: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gaps (unit mean), prompt and output lengths of `n` requests: the
    draws of `core/workload.py::sample_requests`, in its order, with the
    rate left out of the gaps."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0, size=n)
    p, o = spec["prompt"], spec["output"]
    in_lens = np.clip(rng.lognormal(p["mu"], p["sigma"], n).astype(int),
                      *p["clip"])
    out_lens = np.clip(rng.lognormal(o["mu"], o["sigma"], n).astype(int),
                       *o["clip"])
    return gaps, in_lens, out_lens


def rate_of(spec: Dict) -> float:
    """The offered rate (requests per virtual second)."""
    return float(spec["knee_rps"]) * float(spec["rate_factor"])


def arrivals(spec: Dict, rate: float = None) -> Iterator[Arrival]:
    """The endless open-loop schedule at `rate` (default the file's)."""
    rate = rate_of(spec) if rate is None else rate
    n = int(spec["pool"])
    gaps, ins, outs = sample_block(spec, n, int(spec["pool_seed"]))
    t, rid = 0.0, 0
    while True:
        for j in range(n):
            t += gaps[j] / rate
            yield Arrival(rid, t, int(ins[j]), int(outs[j]))
            rid += 1


def prompt_tokens(seed: int, rid: int, n: int, vocab: int) -> List[int]:
    """The prompt of request `rid` under `seed`: ids in [1, vocab)."""
    rng = np.random.default_rng([seed, rid, 1])
    return rng.integers(1, vocab, size=n).tolist()


def quantile_len(part: Dict, z: float) -> int:
    """A length's lognormal quantile at z-score `z`, clipped."""
    lo, hi = part["clip"]
    x = np.exp(part["mu"] + z * part["sigma"])
    return int(round(min(max(x, lo), hi)))
