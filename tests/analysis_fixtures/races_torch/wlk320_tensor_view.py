# expect: code=WLK320
"""Seeded race: two datasets adopt one buffer in place (``copy=False``),
one the whole buffer and one a view of part of it, and nothing orders a
write through the first against a read through the second.

The writer's dataset skips the copy-on-write step, so ``write_slab`` lands
in the adopted buffer itself; the reader's ``read_direct`` reads the view.
The race detector keys both accesses by the buffer's allocation, so the
two must map to one key whatever the payload:

* ``payload="numpy"`` -- an ndarray and a basic-slice view (``.base``
  chain);
* ``payload="tensor"`` -- a ``torch.Tensor`` and a view of it (one
  storage).  A key taken from the tensor object instead of its storage
  gives the view a key of its own, and the race goes unseen."""

import numpy as np
import torch

from repro_torch.core.datamodel import Dataset, File

CODE = "WLK320"
BUDGET = 16
PAYLOADS = ("numpy", "tensor")


class _NoCowDataset(Dataset):
    """BUG: writes land in the adopted buffer, with no private copy."""

    def _ensure_writable(self) -> None:
        pass


def build(payload: str = "tensor", device="cpu"):
    if payload == "numpy":
        buf = np.zeros(16, dtype=np.float32)
        block = np.ones(4, dtype=np.float32)
    elif payload == "tensor":
        buf = torch.zeros(16, dtype=torch.float32, device=device)
        block = torch.ones(4, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown payload {payload!r}; known: {PAYLOADS}")
    whole = _NoCowDataset("data", (16,), "float32", data=buf, copy=False)
    part = File("out.h5").create_dataset("/data", data=buf[4:8], copy=False)

    def writer():
        whole.write_slab((4,), block)

    def reader():
        float(part.read_direct().sum())

    return [("writer", writer), ("reader", reader)]
