"""Kernels of the port's hot paths.

* ``pack`` -- the transport's block gather into contiguous send buffers,
  hand-written CUDA (``csrc/pack.cu``) built at first use.
* ``adamw`` -- the training step's AdamW as three multi-tensor kernels
  (``csrc/adamw.cu``); ``train.optim.adamw_update`` runs them for
  parameters on the card and its plain loop on the CPU.

``ref.py`` holds the plain PyTorch versions; ``ops.py`` the public
wrappers, which run the kernel on a CUDA tensor and the plain version on a
CPU tensor.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
