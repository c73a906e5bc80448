# Copied unchanged from src/repro/training/data.py.
"""Deterministic synthetic token pipeline (no datasets ship offline).

Produces next-token-prediction batches with document boundaries, sharded
by host and seeded per step, so restarts resume the exact stream
(fault-tolerant data order)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 1234
    mean_doc_len: int = 512


class SyntheticTokens:
    """Markov-ish synthetic stream: documents of geometric length, token
    correlations so the loss signal is learnable (not pure noise)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_id))
        b = cfg.batch // self.num_hosts
        base = rng.integers(0, cfg.vocab_size, size=(b, cfg.seq_len + 1),
                            dtype=np.int64)
        # correlate: with p=0.5 a token repeats (t-1) + 1 mod V (learnable)
        rep = rng.random((b, cfg.seq_len)) < 0.5
        nxt = (base[:, :-1] + 1) % cfg.vocab_size
        base[:, 1:][rep] = nxt[rep]
        # document boundaries
        eod = rng.random((b, cfg.seq_len + 1)) < 1.0 / cfg.mean_doc_len
        base[eod] = 0
        return {"tokens": base[:, :-1].astype(np.int32),
                "targets": base[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
