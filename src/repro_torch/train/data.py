"""Deterministic tokenized data pipeline with host-side prefetch
(``src/repro/train/data.py``).

A seeded synthetic corpus (Zipfian unigrams, half of the documents planted
with repeated n-grams so the LM loss actually decreases) packed into
fixed-length sequences, iterated in order and prefetched one step ahead on
a background thread so host data work overlaps device compute.  The corpus
is numpy and pure in (seed, step): both packages give byte-equal batches,
and restoring a checkpoint's step resumes the exact batch sequence.

Batches stay host arrays, and the trainer moves them to its device, unless
``make_batch_iter`` is given a mesh and a batch spec: ``shard_batch`` then
places each batch on the mesh as ``DTensor``s sharded over the batch axes,
every rank cutting its own shard from the host batch it made (no
communication), as the reference's ``make_array_from_callback`` does.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticCorpus", "make_batch_iter", "Prefetcher",
           "shard_batch"]


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


def shard_batch(batch: Dict[str, np.ndarray], mesh, batch_spec) -> Dict[str, Any]:
    """Place a host batch onto the mesh, sharded over the batch axes: each
    leaf a ``DTensor`` of the whole batch's shape whose local shard is this
    rank's slice, on the mesh's device."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import placements

    pl = placements(batch_spec, mesh)
    coord = mesh.get_coordinate()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    out = {}
    for k, v in batch.items():
        full = torch.as_tensor(v)
        local = full
        for m, p in enumerate(pl):
            if p.is_shard():
                n, size = mesh.size(m), local.shape[p.dim]
                if size % n:
                    raise ValueError(f"{k}: dimension {p.dim} of size {size} "
                                     f"does not split over {n} ranks")
                local = local.narrow(p.dim, coord[m] * (size // n), size // n)
        out[k] = DTensor.from_local(local.to(dev), mesh, pl, run_check=False,
                                    shape=full.shape, stride=full.stride())
    return out


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
    mesh=None,
    batch_spec=None,
    prefetch: bool = True,
) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """(step, batch) pairs from ``start_step`` on: host arrays, or placed on
    ``mesh`` by ``shard_batch`` when given ``mesh`` and ``batch_spec``."""
    corpus = SyntheticCorpus(cfg)

    def gen():
        step = start_step
        while num_steps is None or step < start_step + num_steps:
            b = corpus.batch(step)
            if mesh is not None and batch_spec is not None:
                b = shard_batch(b, mesh, batch_spec)
            yield step, b
            step += 1

    return Prefetcher(gen()) if prefetch else gen()
