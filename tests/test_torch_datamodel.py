"""The port's HDF5-style data model beside the JAX package's: the twin of
``tests/test_datamodel.py`` (tree ops, hyperslabs, container I/O, glob
match).  Data enters as tensors made from seeded numpy arrays; with the
default ``copy=True`` a dataset snapshots a tensor into a host array, as
the reference snapshots a numpy array, so both packages hold the same
bytes and count the same copies.  Each reference case has a twin of the
same name."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypcompat import given, settings, st  # noqa: E402
from repro.core import datamodel as jdm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import datamodel as tdm  # noqa: E402
from repro_torch.core.datamodel import (File, Group,  # noqa: E402
                                        match_file, match_path)

CPU = torch.device("cpu")


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), CPU)


def test_tree_and_paths():
    f = File("a.h5")
    ds = f.create_dataset("/g1/g2/data", data=_t(np.ones((4, 5))))
    assert ds.path == "/g1/g2/data"
    assert f["/g1/g2/data"] is ds
    assert "/g1/g2" in f and "/g1/zzz" not in f
    assert isinstance(f["/g1"], Group)
    with pytest.raises(KeyError):
        f["/nope"]
    assert isinstance(ds.read_direct(), np.ndarray)   # snapshot on the host
    jds = jdm.File("a.h5").create_dataset("/g1/g2/data", data=np.ones((4, 5)))
    assert ds.read_direct().tobytes() == jds.read_direct().tobytes()


def test_hyperslab_read_write():
    out = {}
    for name, dm, block in (
            ("port", tdm, _t(np.arange(6, dtype=np.float32).reshape(2, 3))),
            ("jax", jdm, np.arange(6, dtype=np.float32).reshape(2, 3))):
        f = dm.File("a.h5")
        ds = f.create_dataset("/d", shape=(8, 8), dtype=np.float32)
        ds.write_slab((2, 4), block)
        np.testing.assert_array_equal(
            ds.select((2, 4), (2, 3)),
            np.arange(6, dtype=np.float32).reshape(2, 3))
        assert ds.nbytes == 8 * 8 * 4
        out[name] = np.asarray(ds.read_direct()).tobytes()
    assert out["port"] == out["jax"]


def _container(dm, data):
    f = dm.File("snap.h5")
    d1 = f.create_dataset("/grid", data=data(np.arange(100, dtype=np.uint64)))
    d1.attrs["timestep"] = 3
    own = dm.BlockOwnership()
    own.add(0, (0,), (50,))
    own.add(1, (50,), (50,))
    d1.ownership = own
    f.create_dataset("/p/pos", data=data(np.ones((10, 3), np.float32)))
    return f


def test_container_roundtrip(tmp_path):
    # torch has no uint64 arithmetic but carries the type; the snapshot
    # keeps numpy's bytes either way
    f = _container(tdm, lambda a: _t(a) if a.dtype != np.uint64 else a)
    path = f.save(str(tmp_path / "port"))
    g = File.load(path)
    np.testing.assert_array_equal(g["/grid"][:], np.arange(100, dtype=np.uint64))
    assert g["/grid"].attrs["timestep"] == 3
    assert g["/grid"].ownership.blocks[1] == ((50,), (50,))
    assert g.total_bytes() == f.total_bytes()
    # the reference writes the same container, byte for byte, and each
    # package reads the other's
    jpath = _container(jdm, lambda a: a).save(str(tmp_path / "jax"))
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    jg = jdm.File.load(path)
    np.testing.assert_array_equal(jg["/p/pos"][:], g["/p/pos"][:])
    assert File.load(jpath)["/grid"].ownership.blocks == g["/grid"].ownership.blocks


def test_copy_meta_only():
    f = File("x.h5")
    f.create_dataset("/a/b", data=_t(np.ones((4,))))
    m = f.copy_meta_only()
    assert m["/a/b"].shape == (4,)
    assert not np.shares_memory(m["/a/b"].read_direct(), f["/a/b"].read_direct())
    # an adopted tensor's meta copy is a fresh host buffer too
    t = _t(np.ones((4,)))
    f2 = File("y.h5")
    f2.create_dataset("/a/b", data=t, copy=False)
    m2 = f2.copy_meta_only()
    assert isinstance(m2["/a/b"].read_direct(), np.ndarray)
    assert convert.dtype_name(m2["/a/b"].dtype) == "float64"


@pytest.mark.parametrize("pattern,path,want", [
    ("/group1/grid", "/group1/grid", True),
    ("/group1/*", "/group1/grid", True),
    ("/particles/*", "/particles/pos/value", True),
    ("/group1/grid", "/group1/particles", False),
    ("/group1", "/group1/grid", True),
    ("*", "/anything", True),
])
def test_match_path(pattern, path, want):
    assert match_path(pattern, path) is want
    assert jdm.match_path(pattern, path) is want


@pytest.mark.parametrize("pattern,name,want", [
    ("outfile.h5", "outfile.h5", True),
    ("*.h5", "outfile.h5", True),
    ("plt*.h5", "plt00010.h5", True),
    ("plt*.h5", "out.h5", False),
])
def test_match_file(pattern, name, want):
    assert match_file(pattern, name) is want
    assert jdm.match_file(pattern, name) is want


@settings(max_examples=50, deadline=None)
@given(st.lists(st.sampled_from(["a", "b", "c", "dd"]), min_size=1, max_size=4))
def test_match_path_reflexive(parts):
    p = "/" + "/".join(parts)
    assert match_path(p, p)


@pytest.mark.slow
def test_share_race_view_vs_cow_write():
    """Racing ``view()`` against a CoW write never tears the (share,
    buffer) pair, on the port's data model, with a tensor snapshot as the
    source."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for trial in range(60):
            f = File("race.h5")
            src = f.create_dataset("/g", data=_t(np.zeros(32)))
            views = []
            gate = threading.Barrier(3)

            def viewer():
                gate.wait()
                for _ in range(150):
                    views.append(src.view())

            def writer():
                gate.wait()
                for i in range(150):
                    src[0] = float(i + 1)

            ts = [threading.Thread(target=viewer), threading.Thread(target=writer)]
            for t in ts:
                t.start()
            gate.wait()
            for t in ts:
                t.join()
            snap = np.array(src.read_direct())
            for v in views:
                v[0] = -1.0
            np.testing.assert_array_equal(np.asarray(src.read_direct()), snap)
            for v in views:
                assert not np.shares_memory(v.read_direct(), src.read_direct())
    finally:
        sys.setswitchinterval(old)
