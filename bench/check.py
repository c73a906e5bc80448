"""Whether what the timed path served is right.

Once the window has closed and the program's state is freed, a sample
of the window's finished requests, drawn from the seed with the longest
request in it, goes through the configuration's plain reference (float32,
TF32 off): each prompt with its served tokens, once. The number compared
is the widest gap by which a served token's reference logit lies below
the reference's best at its position: the tokens are greedy, so a right
program serves the reference's first choice or a near tie. That covers
each layer a request crosses: the prefill (its first token), the KV's
migration into the decode engine's pages and every decode step after it.

The control puts the reference, with its matrices rounded to float8, in
the program's place and reads the same gap for the token it puts first.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sample(run, min_tokens: int, min_requests: int = 3) -> List:
    """The longest finished window request (prompt plus output), then
    others in an order drawn from the seed, until `min_tokens` served
    tokens and `min_requests` requests are in."""
    done = [r for r in run.window if r.finished]
    if not done:
        return []
    done.sort(key=lambda r: r.rid)
    longest = max(done, key=lambda r: (r.in_len + r.out_len, r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([run.seed, 2]).permutation(len(rest))
    out, n = [longest], len(longest.served)
    for i in order:
        if n >= min_tokens and len(out) >= min_requests:
            break
        out.append(rest[i])
        n += len(rest[i].served)
    return out


def _sequence(r, device) -> torch.Tensor:
    return torch.as_tensor(r.prompt + r.served[:-1], dtype=torch.long,
                           device=device)


def widest_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """max over positions of (best reference logit - the token's)."""
    best = ref.max(dim=-1).values
    got = ref.gather(-1, tokens[:, None].to(ref.device))[:, 0]
    return float((best - got).max())


def gaps(run, reqs, control: bool = False) -> Dict[str, float]:
    """{"program": widest gap of the served tokens} and, with `control`,
    {"control": widest gap of the float8 reference's first choices}."""
    ref_mod = run.cell.reference
    cfg = run.cell.config
    out = {"program": 0.0}
    if control:
        out["control"] = 0.0
    with torch.no_grad():
        for r in reqs:
            toks = _sequence(r, run.device)
            first = r.in_len - 1
            ref = ref_mod.logits(run.params, cfg, toks, first)
            served = torch.as_tensor(r.served, dtype=torch.long)
            out["program"] = max(out["program"], widest_gap(ref, served))
            if control:
                low = ref_mod.logits(run.params, cfg, toks, first,
                                     weight=ref_mod.fp8_weight)
                out["control"] = max(out["control"],
                                     widest_gap(ref, low.argmax(-1)))
                del low
            del ref
    return out


def check(run) -> Dict[str, Dict[str, float]]:
    """Each number compared, with its limit: a run is correct when every
    value is at most its limit."""
    c = run.cell.traffic["check"]
    want = int(c["sample_tokens"])
    reqs = sample(run, want)
    served = sum(len(r.served) for r in reqs)
    return {
        # with nothing to sample, `sample_short_by` fails the run
        "widest_gap": {"value": gaps(run, reqs)["program"] if reqs
                       else 0.0, "limit": float(c["widest_gap"])},
        "wrong_length": {"value": sum(
            1 for r in run.window
            if r.finished and len(r.served) != r.out_len), "limit": 0},
        "sample_short_by": {"value": max(want - served, 0), "limit": 0},
    }


def passed(numbers: Dict[str, Dict[str, float]]) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())


def describe(numbers: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in numbers.items()]
