"""The traffic generator: one schedule for every seed, the seed drawing
the prompts; the rate and the lognormal shapes the files state."""
from __future__ import annotations

import itertools
import json

import numpy as np
import pytest

from bench import traffic as tr
from bench.cell import BENCH

FILES = sorted((BENCH / "traffic").glob("*.json"))


def _take(spec, n, rate=2.0):
    return list(itertools.islice(tr.arrivals(spec, rate), n))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_every_seed_gets_one_schedule_and_its_own_prompts(path):
    spec = json.loads(path.read_text())
    a, b = _take(spec, 300), _take(spec, 300)
    assert [(x.t, x.in_len, x.out_len) for x in a] == \
        [(x.t, x.in_len, x.out_len) for x in b]
    big = 2 ** 31 + 7
    assert tr.prompt_tokens(big, 3, 50, 1000) == \
        tr.prompt_tokens(big, 3, 50, 1000)
    assert tr.prompt_tokens(big, 3, 50, 1000) != \
        tr.prompt_tokens(big + 1, 3, 50, 1000)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_each_block_arrives_at_the_stated_rate(path):
    # a block is one pass over the pool, which the schedule repeats: on
    # average it arrives at the stated rate, its gaps the pool's plain
    # exponential draws over the rate (Poisson), none rescaled, so
    # stretches within it arrive faster or slower
    spec = json.loads(path.read_text())
    n = spec["pool"]
    a = _take(spec, n, rate=4.0)
    gaps, _, _ = tr.sample_block(spec, n, spec["pool_seed"])
    t = np.array([x.t for x in a])
    assert np.diff(t) == pytest.approx(gaps[1:] / 4.0)
    assert t[-1] / n == pytest.approx(1 / 4.0, rel=0.05)
    per_64 = np.diff(t[63::64])
    assert per_64.std() / per_64.mean() > 0.05
    # past the pool the schedule repeats, later in time
    b = _take(spec, n + 2)
    assert (b[n].in_len, b[n].out_len) == (b[0].in_len, b[0].out_len)
    assert b[n].t > b[n - 1].t


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_lengths_follow_the_file(path):
    spec = json.loads(path.read_text())
    gaps, ins, outs = tr.sample_block(spec, 40000, 3)
    for part, xs in (("prompt", ins), ("output", outs)):
        lo, hi = spec[part]["clip"]
        assert xs.min() >= lo and xs.max() <= hi
        # the median of a clipped lognormal is exp(mu) while the clip is
        # outside it; the draws truncate to whole tokens
        assert np.median(xs) == pytest.approx(np.exp(spec[part]["mu"]),
                                              rel=0.03)
    assert gaps.mean() == pytest.approx(1.0, rel=0.03)


def test_quantile_len():
    part = {"mu": np.log(2000), "sigma": 0.5, "clip": [512, 3584]}
    assert tr.quantile_len(part, 0.0) == 2000
    assert tr.quantile_len(part, tr.Z90) == 3584      # clipped
    assert tr.quantile_len(part, -10) == 512
