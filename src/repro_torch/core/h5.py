"""User-facing HDF5-style API -- identical standalone and inside a workflow.

This is the paper's ease-of-adoption contract: task codes perform ordinary
(HDF5-style) I/O through this module and run *unmodified* both as standalone
programs and inside a Wilkins workflow.  Standalone, ``File(..., "w")`` writes
a real container file to disk at close and ``File(..., "r")`` reads one back.
In a workflow, the ambient VOL object (installed by the driver, analogous to
enabling the LowFive plugin through environment variables) intercepts the same
calls and routes the data through memory channels with flow control.

    from repro_torch.core import h5

    def producer():                      # user task code -- no workflow API
        for t in range(10):
            with h5.File("outfile.h5", "w") as f:
                f.create_dataset("/group1/grid", data=grid)
                f.create_dataset("/group1/particles", data=parts)

    def consumer():
        while True:
            f = h5.File("outfile.h5", "r")
            if f is None:                # producer says all-done
                break
            grid = f["/group1/grid"][:]
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np

from . import datamodel
from .vol import current_vol

__all__ = ["File", "set_standalone_dir"]

_standalone_dir = os.environ.get("WILKINS_STANDALONE_DIR", ".")


def set_standalone_dir(path: str) -> None:
    global _standalone_dir
    _standalone_dir = path


class _H5File:
    """Proxy over ``datamodel.File`` firing VOL execution points."""

    def __init__(self, inner: datamodel.File, mode: str, vol=None):
        self._inner = inner
        self._mode = mode
        self._vol = vol
        self._closed = False

    # -- writes ---------------------------------------------------------
    def create_dataset(self, path: str, shape=None, dtype=None, data=None,
                       ownership: Optional[datamodel.BlockOwnership] = None,
                       copy: bool = True):
        """Write a dataset.  ``copy=True`` snapshots ``data`` into the file
        (a host array, h5py semantics); ``copy=False`` adopts a tensor
        where it lives, so consumers receive it device-resident -- the
        producer must not write it in place afterwards (the data model
        raises if it does)."""
        ds = self._inner.create_dataset(path, shape=shape, dtype=dtype,
                                        data=data, copy=copy)
        if ownership is not None:
            ds.ownership = ownership
        if self._vol is not None:
            self._vol.on_dataset_write(ds)
        return ds

    def require_group(self, path: str):
        return self._inner.require_group(path)

    # -- reads ----------------------------------------------------------
    def __getitem__(self, path: str):
        if self._vol is not None:
            self._vol.on_dataset_open(path)
        return self._inner[path]

    def __contains__(self, path: str) -> bool:
        return path in self._inner

    def get(self, path: str):
        return self._inner.get(path)

    def visit_datasets(self):
        return self._inner.visit_datasets()

    @property
    def attrs(self):
        return self._inner.attrs

    @property
    def filename(self) -> str:
        return self._inner.filename

    def total_bytes(self) -> int:
        return self._inner.total_bytes()

    @property
    def inner(self) -> datamodel.File:
        return self._inner

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._mode == "w":
            if self._vol is not None:
                self._vol.on_file_close(self._inner)
            else:
                self._inner.save(_standalone_dir)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def File(filename: str, mode: str = "r") -> Optional[_H5File]:
    """Open a file for writing ("w") or reading ("r").

    Reading inside a workflow blocks until the next version of the file
    arrives over a matched channel and returns ``None`` when all matched
    producers are done (the paper's query protocol).
    """
    vol = current_vol()
    if mode == "w":
        inner = datamodel.File(filename)
        if vol is not None:
            vol.on_file_create(inner)
        return _H5File(inner, "w", vol)
    if mode == "r":
        if vol is not None and vol.incoming:
            inner = vol.on_file_open(filename)
            if inner is None:
                # Either all-done, or this filename is not intercepted.
                if any(c.matches_file(filename) for c in vol.incoming):
                    return None
            else:
                return _H5File(inner, "r", vol)
        # standalone fallback: load from disk
        path = os.path.join(_standalone_dir, os.path.basename(filename))
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return _H5File(datamodel.File.load(path), "r", vol)
    raise ValueError(f"mode must be 'r' or 'w', got {mode!r}")
