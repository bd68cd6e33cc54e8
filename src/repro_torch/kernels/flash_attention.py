"""CUDA flash-attention forward (K3): binding and launch wrapper.

``csrc/flash_attention.cu`` replaces the Pallas ``flash_attention_bhsd``
of the JAX package (see the source's header for what it computes, its
bound and its design).  ``kernels.build`` compiles it for ``sm_90a`` at
first use; ``flash_attention`` here checks a call, allocates the output and
launches on PyTorch's current stream.  The kernel reads BSHD strides
directly, so no transpose or padded copy is made; a bfloat16 tensor whose
pointer or strides are not whole 16-byte chunks (the tensor-core kernel
copies 16 bytes at a time) is first made contiguous.  ``kernels.ops`` holds
the public wrapper that dispatches on the tensor's device.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from . import build as _build

__all__ = ["NAME", "check_args", "flash_attention"]

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Any = None


def _library() -> Any:
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.wlk_flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
        lib.wlk_flash_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int) -> None:
    """Raise on a call the kernel does not serve: q (B, Sq, H, D) and k/v
    (B, Sk, KV, D) of one dtype (float32 or bfloat16) on one device, H a
    multiple of KV, D a multiple of 16 up to 128, no input that requires a
    gradient (``ops.flash_attention`` detaches them for the kernel)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-D tensor "
                             f"(B, S, heads, D)")
    _build.refuse_grad(NAME, (q, k, v))
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head dim")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a multiple "
                         f"of {k.shape[2]} kv heads")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"flash_attention: head dim {d} is not a multiple of "
                         f"16 in [16, 128]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; float32 or bfloat16, all the same")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v lie on different devices")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel reads it in place: unit stride along D,
    and for bfloat16 (16-byte copies) a 16-byte-aligned pointer and (B, S,
    H) strides of whole 16-byte chunks.  Otherwise a new contiguous copy."""
    ok = t.stride(-1) == 1
    if t.dtype == torch.bfloat16:
        size = t.element_size()
        ok = ok and t.data_ptr() % 16 == 0 and all(
            s * size % 16 == 0 for s in t.stride()[:3])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int) -> torch.Tensor:
    """K3 on the card for arguments ``check_args`` accepted: (B, Sq, H, D)
    out in q's dtype, a new contiguous tensor."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention launches on CUDA tensors only, "
                         f"got {q.device}")
    _build.refuse_grad(NAME, (q, k, v))
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    fn = _library().wlk_flash_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, h, kv, sq, sk, d, _DTYPES[q.dtype], int(causal),
                 int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    _build.count(NAME)
    return out
