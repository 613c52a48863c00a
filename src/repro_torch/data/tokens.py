"""Synthetic LM token pipeline (shard-aware, resumable).

A copy of ``repro/data/tokens.py`` (host numpy, no JAX), so a config gives
the port the reference's batches, token for token.  Deterministic Zipfian
token streams with enough structure to train on (a planted bigram
transition matrix makes the loss genuinely decrease), so the trainer
exercises real learning dynamics without external datasets.  State is
checkpointable for exactly-once resume, and shards partition the stream for
data parallelism, the same contract as :mod:`repro_torch.data.raven`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenConfig:
    vocab: int
    seq_len: int
    batch_size: int
    seed: int = 0
    num_shards: int = 1
    shard_index: int = 0


class TokenDataset:
    def __init__(self, cfg: TokenConfig):
        self.cfg = cfg
        self._step = 0
        rng = np.random.default_rng(cfg.seed)
        # planted structure: each token prefers a small successor set
        self._succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, 4))
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])

    def next_batch(self) -> dict:
        """``{"tokens": [batch_size, seq_len] int32}``: batch ``g = step x
        num_shards + shard_index`` of the global stream, drawn from its own
        generator (seed ``seed x 7777777 + g``)."""
        cfg = self.cfg
        g = (self._step * cfg.num_shards + cfg.shard_index)
        rng = np.random.default_rng(cfg.seed * 7_777_777 + g)
        self._step += 1
        B, S = cfg.batch_size, cfg.seq_len
        toks = np.empty((B, S), dtype=np.int32)
        toks[:, 0] = rng.choice(cfg.vocab, size=B, p=self._unigram)
        for t in range(1, S):
            follow = rng.random(B) < 0.8
            succ_pick = self._succ[toks[:, t - 1], rng.integers(0, 4, B)]
            rand_pick = rng.choice(cfg.vocab, size=B, p=self._unigram)
            toks[:, t] = np.where(follow, succ_pick, rand_pick)
        return {"tokens": toks}

    def __iter__(self):
        while True:
            yield self.next_batch()
