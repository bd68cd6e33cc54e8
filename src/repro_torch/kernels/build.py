"""Builds the port's CUDA sources and counts their kernels' launches.

Every kernel lives in ``csrc/<name>.cu`` behind a plain C interface.
``build(name)`` runs ``nvcc`` for ``sm_90a`` on it at first use into
``build/repro_torch/lib<name>-<hash>.so`` under the checkout, where the
hash covers the source, the shared headers ``csrc/*.cuh`` and the ``nvcc``
flags, so an edit to any of them builds a new library and a stale one is
never reused.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.  Nothing is built at
import, so the CPU tests import every module without ``nvcc``.

``count(name)`` is called by a launcher right after its kernel was queued,
and nowhere else; ``launch_counts()`` reads every kernel's count, so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

from ..analysis.lockcheck import make_lock

__all__ = ["NVCC_FLAGS", "source_path", "library_path", "build", "build_all",
           "load", "count", "launch_counts", "reset_launch_counts",
           "refuse_grad"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_build_lock = make_lock("leaf:kernel_build")
_count_lock = make_lock("leaf:kernel_launches")
_launches: Dict[str, int] = {}
_loaded: Dict[Path, Any] = {}


def count(name: str) -> None:
    """One more launch of kernel ``name``."""
    with _count_lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts(names: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """Launches since the last reset, for ``names`` (default: every kernel
    that has launched)."""
    with _count_lock:
        if names is None:
            return dict(_launches)
        return {n: _launches.get(n, 0) for n in names}


def reset_launch_counts(names: Optional[Iterable[str]] = None) -> None:
    with _count_lock:
        for n in (list(_launches) if names is None else names):
            _launches[n] = 0


def refuse_grad(name: str, tensors: Iterable[Any]) -> None:
    """Raise when an input of raw kernel ``name`` requires a gradient: a
    kernel has no backward, ``kernels.ops`` differentiates it."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad; the raw kernel has no backward "
            f"-- kernels.ops differentiates it (its backward recomputes in "
            f"plain torch)")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Where the build of ``csrc/<name>.cu`` with ``flags`` lives: named by
    a hash of the source, every header ``csrc/*.cuh`` and the flags."""
    key = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update("\0".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build_all(names: Sequence[str], flags: Sequence[str] = NVCC_FLAGS
              ) -> List[Path]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` per source, all started together.  Raises on any failure."""
    with _build_lock:
        libs = [library_path(n, flags) for n in names]
        procs = []
        for name, lib in zip(names, libs):
            if lib.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *flags, "-o", str(tmp), str(source_path(name))]
            procs.append((cmd, tmp, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for cmd, tmp, lib, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
        return libs


def build(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; its path."""
    return build_all([name], flags)[0]


def load(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Any:
    """The ``ctypes`` library of ``csrc/<name>.cu``, built at first use."""
    path = build(name, flags)
    with _build_lock:
        if path not in _loaded:
            _loaded[path] = ctypes.CDLL(str(path))
        return _loaded[path]
