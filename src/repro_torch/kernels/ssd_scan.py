"""CUDA SSD intra-chunk step (K4): binding and launch wrapper.

``csrc/ssd_scan.cu`` replaces the Pallas ``ssd_intra_chunk`` of the JAX
package (see the source's header for what it computes, its bound and its
design).  ``kernels.build`` compiles it for ``sm_90a`` at first use;
``ssd_intra_chunk`` here checks a call, allocates both outputs and launches
on PyTorch's current stream.  ``kernels.ops.ssd_chunked_kernel`` pads the
sequence to whole chunks and runs the inter-chunk recurrence around it.
"""

from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

from . import build as _build

__all__ = ["NAME", "check_args", "ssd_intra_chunk"]

NAME = "ssd_intra_chunk"
_lib: Any = None


def _library() -> Any:
    global _lib
    if _lib is None:
        lib = _build.load("ssd_scan")
        lib.wlk_ssd_intra_chunk.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])
        lib.wlk_ssd_intra_chunk.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_args(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor) -> None:
    """Raise on a call the kernel does not serve: x (B,NC,q,H,P), dA
    (B,NC,q,H), Bm/Cm (B,NC,q,G,N) on one device, H a multiple of G, P and N
    in [1, 128], no input that requires a gradient (``ops.ssd_chunked_kernel``
    detaches them for the kernel)."""
    for name, t, nd in (("x", x, 5), ("dA", dA, 4), ("Bm", Bm, 5), ("Cm", Cm, 5)):
        if not isinstance(t, torch.Tensor) or t.dim() != nd:
            raise ValueError(f"ssd_intra_chunk: {name} must be a {nd}-D tensor")
    _build.refuse_grad(NAME, (x, dA, Bm, Cm))
    b, nc, q, h, p = x.shape
    if tuple(dA.shape) != (b, nc, q, h):
        raise ValueError(f"ssd_intra_chunk: dA {tuple(dA.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if Bm.shape != Cm.shape or tuple(Bm.shape[:3]) != (b, nc, q):
        raise ValueError(f"ssd_intra_chunk: Bm {tuple(Bm.shape)} / Cm "
                         f"{tuple(Cm.shape)} do not match x {tuple(x.shape)}")
    g, n = Bm.shape[3], Bm.shape[4]
    if g < 1 or h % g:
        raise ValueError(f"ssd_intra_chunk: {h} heads are not a multiple of "
                         f"{g} groups")
    if not (1 <= p <= 128 and 1 <= n <= 128):
        raise ValueError(f"ssd_intra_chunk: head dim {p} and state {n} must "
                         f"lie in [1, 128]")
    if not (x.device == dA.device == Bm.device == Cm.device):
        raise ValueError("ssd_intra_chunk: inputs lie on different devices")


def ssd_intra_chunk(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card for arguments ``check_args`` accepted: (y_diag
    (B,NC,q,H,P), states (B,NC,H,N,P)), both float32."""
    if not x.is_cuda:
        raise ValueError(f"ssd_intra_chunk launches on CUDA tensors only, "
                         f"got {x.device}")
    _build.refuse_grad(NAME, (x, dA, Bm, Cm))
    x, dA, Bm, Cm = (t.float().contiguous() for t in (x, dA, Bm, Cm))
    b, nc, q, h, p = x.shape
    g, n = Bm.shape[3], Bm.shape[4]
    y = torch.empty((b, nc, q, h, p), dtype=torch.float32, device=x.device)
    st = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, st.zero_()
    fn = _library().wlk_ssd_intra_chunk
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), st.data_ptr(), b, nc, q, h, p, g, n, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: "
                           f"cudaError_t {err}")
    _build.count(NAME)
    return y, st
