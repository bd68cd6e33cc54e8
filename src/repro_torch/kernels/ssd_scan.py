"""CUDA SSD intra-chunk step (K4): binding and launch wrapper.

``csrc/ssd_scan.cu`` replaces the Pallas ``ssd_intra_chunk`` of the JAX
package (see the source's header for what it computes, its bound and its
design: tensor cores in 3xTF32, fed by TMA).  ``kernels.build`` compiles it
for ``sm_90a`` at first use; ``ssd_intra_chunk`` here checks a call,
allocates both outputs and launches on PyTorch's current stream.
``kernel_layout`` gives the kernel what TMA reads: P and N padded with zeros
to multiples of 4 and pointers on the 16-byte grid, copying only a tensor
that is not so already.  ``work_list`` states the kernel's blocks in the
order it launches them.  ``kernels.ops.ssd_chunked_kernel`` pads the
sequence to whole chunks and runs the inter-chunk recurrence around it.
"""

from __future__ import annotations

import ctypes
from typing import Any, List, Tuple

import torch

from . import build as _build

__all__ = ["NAME", "TILE", "HEADS", "check_args", "work_list", "kernel_layout",
           "ssd_intra_chunk"]

NAME = "ssd_intra_chunk"
TILE = 64    # rows i of a y tile, rows n of a state tile, rows j of a step
HEADS = 8    # heads of a block's subset at P <= 64; 4 above
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


def work_list(bnc: int, groups: int, heads: int, q: int, n: int, p: int
              ) -> List[Tuple[str, int, int, int, int]]:
    """The kernel's blocks in launch order, ``(kind, tile, bc, g, sub)``:
    ``kind`` "y" (rows i ``64 tile ..``, j tiles 0 .. ``tile``) or "state"
    (rows n ``64 tile ..``, every j tile), for chunk ``bc`` of the B x NC,
    group ``g`` and head subset ``sub`` (heads ``g R + sub HS ..`` of the
    group's ``R``, ``HS`` = ``HEADS``, half that when ``p > 64``).  Heaviest
    first: the last y tile, the state tiles, then the other y tiles from
    the last to the first; within a kind the subset fastest, then the group,
    then ``bc`` (the kernel decodes ``blockIdx.x`` so)."""
    hs = HEADS if p <= 64 else HEADS // 2
    nsub = -(-(heads // groups) // hs)
    ni, nn = -(-q // TILE), -(-n // TILE)
    ranks = ([("y", ni - 1)] + [("state", t) for t in range(nn)]
             + [("y", t) for t in range(ni - 2, -1, -1)])
    return [(kind, tile, bc, g, sub) for kind, tile in ranks
            for bc in range(bnc) for g in range(groups) for sub in range(nsub)]


def kernel_layout(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernel's operands: float32 and C-contiguous, x's P and Bm's/Cm's N
    padded with zeros to multiples of 4 (TMA reads rows whose stride is a
    multiple of 16 bytes) and x, Bm and Cm on the 16-byte grid.  A tensor
    that is all of this already is passed as it is; the outputs of padded
    operands are sliced back by ``ssd_intra_chunk``."""
    def ready(t, pad, aligned=True):
        t = t.float()
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        t = t.contiguous()
        return t.clone() if aligned and t.data_ptr() % 16 else t

    pad_p, pad_n = -x.shape[-1] % 4, -Bm.shape[-1] % 4
    return (ready(x, pad_p), ready(dA, 0, aligned=False), ready(Bm, pad_n),
            ready(Cm, pad_n))


def ssd_intra_chunk(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card for arguments ``check_args`` accepted: (y_diag
    (B,NC,q,H,P), states (B,NC,H,N,P)), both float32."""
    if not x.is_cuda:
        raise ValueError(f"ssd_intra_chunk launches on CUDA tensors only, "
                         f"got {x.device}")
    _build.refuse_grad(NAME, (x, dA, Bm, Cm))
    b, nc, q, h, p = x.shape
    g, n = Bm.shape[3], Bm.shape[4]
    x, dA, Bm, Cm = kernel_layout(x, dA, Bm, Cm)
    pk, nk = x.shape[-1], Bm.shape[-1]
    y = torch.empty((b, nc, q, h, pk), dtype=torch.float32, device=x.device)
    st = torch.empty((b, nc, h, nk, pk), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y[..., :p], st[..., :n, :p].zero_()
    fn = _library().wlk_ssd_intra_chunk
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), st.data_ptr(), b, nc, q, h, pk, g, nk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: "
                           f"cudaError_t {err}")
    _build.count(NAME)
    if (pk, nk) != (p, n):
        y, st = y[..., :p].contiguous(), st[..., :n, :p].contiguous()
    return y, st
