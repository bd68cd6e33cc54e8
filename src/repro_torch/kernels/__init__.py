"""Kernels of the port's hot paths.

* ``pack`` -- the transport's block gather into contiguous send buffers,
  hand-written CUDA (``csrc/pack.cu``) built at first use.

``ref.py`` holds the plain PyTorch versions; ``ops.py`` the public
wrappers, which run the kernel on a CUDA tensor and the plain version on a
CPU tensor.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
