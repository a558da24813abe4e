"""Deterministic synthetic corpora (a copy of ``repro.data.synthetic``).

Training runs use a mixture of Markov processes with learnable signal
rather than uniform noise. The generator is numpy's, seeded as in the JAX
package, so the same seed gives the same batches in both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # markov order of the generating process
    n_modes: int = 8        # distinct "documents" styles
    temperature: float = 0.7


class MarkovCorpus:
    """Fixed random Markov chain over the vocab; same seed -> same stream."""

    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = min(cfg.vocab, 512)  # transition table stays small
        self.v = v
        self.trans = rng.gumbel(size=(cfg.n_modes, v, 16)).astype(np.float32)
        self.nxt = rng.randint(0, v, size=(cfg.n_modes, v, 16))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(cfg.seed * 100003 + step)
        B, S = cfg.global_batch, cfg.seq_len
        modes = rng.randint(0, cfg.n_modes, size=B)
        toks = np.zeros((B, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.v, size=B)
        g = rng.gumbel(size=(B, S, 16)).astype(np.float32)
        for t in range(S):
            logits = self.trans[modes, toks[:, t]] / cfg.temperature
            choice = np.argmax(logits + g[:, t], axis=-1)
            toks[:, t + 1] = self.nxt[modes, toks[:, t], choice]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(cfg: SyntheticConfig, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    corpus = MarkovCorpus(cfg)
    step = start_step
    while True:
        yield corpus.batch(step)
        step += 1
