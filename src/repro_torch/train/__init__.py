"""repro_torch.train -- checkpointing (the trainer, optimizer and data
pipeline are not ported yet: ROADMAP Queue 1 item 11)."""

from .checkpoint import (AsyncCheckpointer, load_pytree, load_pytree_flat,
                         restore_latest, save_pytree)

__all__ = ["AsyncCheckpointer", "load_pytree", "load_pytree_flat",
           "restore_latest", "save_pytree"]
