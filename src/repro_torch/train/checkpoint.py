"""Fault-tolerant checkpointing: atomic directories, async save, auto-resume.

Layout::

    <dir>/step_000100.ckpt      # one container file (npz + json tree spec)
    <dir>/step_000100.ckpt.tmp  # in-flight write (never read)
    <dir>/LATEST                # atomic pointer, written last

The container is the JAX package's, so either package restores the other's
checkpoints: an 8-byte little-endian header length, a JSON meta with
``keys`` (flatten-with-path strings), ``treedef`` and ``time``, then
``np.savez`` arrays ``a0, a1, ...`` in leaf order.

* **Keys and leaf order** follow ``jax.tree_util``: dicts flatten in sorted
  key order (``"['acc']"``), named tuples by field (``".opt"``, the tree
  structure ``CustomNode(namedtuple[OptState], [...])``), lists and tuples
  by position (``"[0]"``), ``None`` is an empty subtree, anything else is a
  leaf; path parts are joined by ``/`` (a ``TrainState``'s step is
  ``".opt/.step"``).  ``load_pytree`` matches leaves by position and the
  rescale surgery parses the keys, so a differing order would restore the
  wrong leaves without an error.
* **Tensors.**  ``AsyncCheckpointer.save`` snapshots every tensor leaf into
  a private host copy before it returns (a CPU tensor's ``.numpy()`` shares
  memory, and task code may write the tensor in place right after);
  numpy leaves are taken as they are, as the JAX package takes them.  A
  bfloat16 leaf is stored as its int16 bit pattern, and the meta's extra
  ``dtypes`` key (``{"a3": "bfloat16"}``, ignored by the JAX package)
  marks it, so the port reads it back bit for bit; it reads the JAX
  package's bfloat16 leaves (stored as ``|V2``) the same way.
* **Restore follows ``like``.**  A leaf whose ``like`` is a tensor comes
  back as a tensor of that dtype on that tensor's device; any other
  ``like`` leaf gives a numpy array, as in the JAX package.
* **Atomicity**: the container is written to ``.tmp`` then ``os.replace``d;
  ``LATEST`` is updated only after the data file is durable, so a crash at
  any point leaves a consistent store.
* **Async**: ``AsyncCheckpointer.save`` blocks only for the host snapshot and
  hands serialization to a background thread; a failed write is parked and
  raised on the caller's next ``save``/``wait``.
* **Retention**: keep the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.lockcheck import make_lock
from ..convert import dtype_name, numpy_from_tensor

__all__ = ["save_pytree", "load_pytree", "load_pytree_flat",
           "AsyncCheckpointer", "restore_latest"]

_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# pytrees of dicts, lists and tuples, flattened as jax.tree_util does
# ---------------------------------------------------------------------------
def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of a container, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for part, child in kids:
        out.extend(_flatten_with_paths(child, prefix + (part,)))
    return out


def _treedef_str(tree: Any) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for the same tree."""
    def walk(node: Any) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            inner = ", ".join(walk(c) for c in node)
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        if isinstance(node, list):
            return "[" + ", ".join(walk(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_tree_map(fn, c) for c in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, c) for c in tree)
    return fn(tree)


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)
    return _tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------
def _host_leaf(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf's host array, and its dtype name where numpy lacks it."""
    if isinstance(leaf, torch.Tensor):
        name = dtype_name(leaf)
        return numpy_from_tensor(leaf), (name if name == _BF16 else None)
    return np.asarray(leaf), None


def save_pytree(tree: Any, path: str) -> str:
    """Serialize a pytree to one container file, atomically."""
    leaves = _flatten_with_paths(tree)
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for i, (_, leaf) in enumerate(leaves):
        arrays[f"a{i}"], name = _host_leaf(leaf)
        if name is not None:
            dtypes[f"a{i}"] = name
    meta: Dict[str, Any] = {
        "keys": [k for k, _ in leaves],
        "treedef": _treedef_str(tree),
        "time": time.time(),
    }
    if dtypes:
        meta["dtypes"] = dtypes
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        header = json.dumps(meta).encode()
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _read(path: str) -> Tuple[List[str], List[np.ndarray], List[bool]]:
    """(keys, arrays, which arrays are bfloat16 bit patterns).  The JAX
    package writes an ``ml_dtypes`` bfloat16 leaf as the 2-byte void dtype
    ``|V2``; the port writes int16 and marks it in ``dtypes``."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode())
        npz = np.load(f)
        arrays = [npz[f"a{i}"] for i in range(len(meta["keys"]))]
    dtypes = meta.get("dtypes", {})
    bf16 = []
    for i, a in enumerate(arrays):
        void2 = a.dtype.kind == "V" and a.dtype.itemsize == 2
        if void2:
            arrays[i] = a.view(np.int16)
        bf16.append(void2 or dtypes.get(f"a{i}") == _BF16)
    return meta["keys"], arrays, bf16


def _as_bf16(arr: np.ndarray) -> torch.Tensor:
    """A CPU bfloat16 tensor from its stored int16 bit pattern."""
    return torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)


def load_pytree(path: str, like: Any) -> Any:
    """Load a container into the structure of ``like`` (order-checked).

    A tensor leaf of ``like`` gives a tensor of its dtype on its device;
    any other leaf gives a numpy array cast to its dtype."""
    _, arrays, marks = _read(path)
    ref_leaves = [leaf for _, leaf in _flatten_with_paths(like)]
    if len(ref_leaves) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, expected {len(ref_leaves)}")
    leaves = []
    for ref, arr, bf16 in zip(ref_leaves, arrays, marks):
        if tuple(ref.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch {ref.shape} vs {arr.shape}")
        if isinstance(ref, torch.Tensor):
            t = _as_bf16(arr) if bf16 else torch.from_numpy(arr)
            leaves.append(t.to(device=ref.device, dtype=ref.dtype))
        else:
            leaves.append(arr if bf16 else arr.astype(ref.dtype))
    return _unflatten(like, leaves)


def load_pytree_flat(path: str) -> Dict[str, Any]:
    """Load a container WITHOUT a reference structure: {path-key: array}.

    The elastic-rescale path re-cuts a dead task's checkpoint into a
    different number of shards; at that point nobody holds a ``like``
    structure of the old size, so the order-checked :func:`load_pytree` is
    unusable.  Keys are the flatten-with-path strings written at save time
    (a flat dict state ``{"acc": ...}`` yields the key ``"['acc']"``).  A
    leaf marked bfloat16 comes back as a CPU bfloat16 tensor (numpy has no
    such dtype), every other leaf as a numpy array.
    """
    keys, arrays, marks = _read(path)
    return {k: (_as_bf16(a) if bf16 else a)
            for k, a, bf16 in zip(keys, arrays, marks)}


def _ckpt_name(step: int) -> str:
    return f"step_{step:08d}.ckpt"


def _snapshot(leaf: Any) -> Any:
    """A tensor leaf as a private CPU tensor (one copy from any device); a
    numpy leaf as it is, as the JAX package takes it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    return np.asarray(leaf)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with retention + LATEST pointer."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = make_lock("leaf:ckpt")
        self._inflight: Optional[threading.Thread] = None
        # a failed background write (disk full, permission flip) is parked
        # here and re-raised at the next save()/wait(), i.e. on the caller's
        # thread, where the recovery supervisor can see it.
        self._error: Optional[BaseException] = None
        self.saved_steps: List[int] = []

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, block: bool = False) -> None:
        host_state = _tree_map(_snapshot, state)  # D2H snapshot (blocking)
        self.wait()  # at most one in-flight write (raises a parked error)

        def work():
            try:
                path = os.path.join(self.dir, _ckpt_name(step))
                save_pytree(host_state, path)
                with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                    f.write(str(step))
                os.replace(os.path.join(self.dir, "LATEST.tmp"),
                           os.path.join(self.dir, "LATEST"))
                with self._lock:
                    self.saved_steps.append(step)
                    self._gc()
            except BaseException as e:  # surfaced on the caller's next call
                with self._lock:
                    self._error = e

        t = threading.Thread(target=work, daemon=True)
        with self._lock:
            self._inflight = t
        t.start()
        if block:
            self.wait()

    def wait(self) -> None:
        """Join the in-flight write; re-raise any background write error on
        THIS thread (a checkpoint that did not land must not ack)."""
        with self._lock:
            t, self._inflight = self._inflight, None
        if t is not None:
            t.join()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self) -> None:
        for s in sorted(self.saved_steps)[: -self.keep]:
            p = os.path.join(self.dir, _ckpt_name(s))
            if os.path.exists(p):
                os.remove(p)
            self.saved_steps.remove(s)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: int, like: Any) -> Any:
        return load_pytree(os.path.join(self.dir, _ckpt_name(step)), like)


def restore_latest(directory: str, like: Any) -> Optional[Tuple[int, Any]]:
    ck = AsyncCheckpointer(directory)
    step = ck.latest_step()
    if step is None:
        return None
    return step, ck.restore(step, like)
