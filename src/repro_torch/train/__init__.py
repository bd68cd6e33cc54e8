"""repro_torch.train -- checkpointing, the data pipeline, AdamW and the
training step, with the reference's exports (``src/repro/train``).

Only the checkpoint module is imported with the package: a workflow task's
first ``restore`` imports it inside the stall watchdog's window, and the
rest (the models behind the trainer) loads on first use of its names.
"""

import importlib

from .checkpoint import (AsyncCheckpointer, load_pytree, load_pytree_flat,
                         restore_latest, save_pytree)

_LAZY = {
    "DataConfig": "data", "Prefetcher": "data", "SyntheticCorpus": "data",
    "make_batch_iter": "data", "shard_batch": "data",
    "AdamWConfig": "optim", "adamw_init": "optim", "adamw_update": "optim",
    "cosine_lr": "optim",
    "TrainState": "trainer", "init_state": "trainer",
    "make_train_step": "trainer", "state_specs": "trainer",
    "place_state": "trainer",
}

__all__ = ["AsyncCheckpointer", "load_pytree", "load_pytree_flat",
           "restore_latest", "save_pytree", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
