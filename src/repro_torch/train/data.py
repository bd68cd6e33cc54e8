"""Deterministic tokenized data pipeline with host-side prefetch
(``src/repro/train/data.py``).

A seeded synthetic corpus (Zipfian unigrams, half of the documents planted
with repeated n-grams so the LM loss actually decreases) packed into
fixed-length sequences, iterated in order and prefetched one step ahead on
a background thread so host data work overlaps device compute.  The corpus
is numpy and pure in (seed, step): both packages give byte-equal batches,
and restoring a checkpoint's step resumes the exact batch sequence.

Batches stay host arrays; the trainer moves them to its device.  The
reference's ``shard_batch`` (placing a batch onto a mesh) waits for the
mesh and sharding modules (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataConfig", "SyntheticCorpus", "make_batch_iter", "Prefetcher"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram_repeat: int = 8        # learnable structure: repeated n-grams


class SyntheticCorpus:
    """Deterministic batch factory: batch(step) is pure in (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 32) ^ step)
        b, s = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(b, s + 1), p=self._probs).astype(np.int32)
        # plant learnable n-gram repeats (period-k structure)
        k = cfg.ngram_repeat
        if k and s + 1 >= 2 * k:
            n_rep = -(-(s + 1) // k)  # ceil: planted covers the full length
            seeds = toks[:, :k]
            planted = np.tile(seeds, (1, n_rep))[:, : s + 1]
            mask = rng.random((b, 1)) < 0.5  # half the docs are periodic
            toks = np.where(mask, planted, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """One-step-ahead background prefetch (host data work overlaps compute)."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()

        def work():
            try:
                for item in it:
                    self._q.put(item)
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_batch_iter(
    cfg: DataConfig,
    start_step: int = 0,
    num_steps: Optional[int] = None,
    prefetch: bool = True,
) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """(step, host batch) pairs from ``start_step`` on (the reference's
    ``mesh``/``batch_spec`` arguments wait for ``shard_batch``)."""
    corpus = SyntheticCorpus(cfg)

    def gen():
        step = start_step
        while num_steps is None or step < start_step + num_steps:
            yield step, corpus.batch(step)
            step += 1

    return Prefetcher(gen()) if prefetch else gen()
