"""repro_torch -- the Wilkins in situ workflow runtime in PyTorch.

A port of ``repro`` (JAX) that runs on an NVIDIA GPU: the same workflow
graph, transport, M->N redistribution and fault tolerance, with
device-resident buffers held as ``torch.Tensor``s and the pack kernels
written in CUDA (``kernels/csrc``).  Entry points run on ``cuda:0`` unless
the caller passes ``devices=[torch.device("cpu")]``.
"""
