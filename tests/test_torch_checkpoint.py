"""The port's checkpoint container against the JAX package's
(``repro.train.checkpoint``): each package restores the other's files with
the same keys, leaf order and bytes; tensors are snapshotted before the
write; bfloat16 round-trips bit for bit; ``like`` decides what comes back;
and a background write error reaches the caller (mirrors
``tests/test_recovery.py::test_async_checkpointer_surfaces_background_write_errors``).
"""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jck  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import recovery as trec  # noqa: E402
from repro_torch.core import rescale as trescale  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402

CPU = torch.device("cpu")


def _state(seed=3):
    """A nested dict/list/tuple state of float32, int64 and float64 numpy
    leaves and Python scalars, with an empty subtree and unsorted keys."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "opt": [rng.standard_normal(5), (np.arange(6, dtype=np.int64), None,
                                         2.5)],
        "b": {"z": 7, "a": (np.float32(1.25),), "empty": []},
        "step": np.array(11, np.int64),
    }


def _meta(path):
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(hlen).decode())


def _bytes(flat):
    return {k: (np.asarray(v).dtype.str, np.asarray(v).shape,
                np.asarray(v).tobytes()) for k, v in flat.items()}


def test_keys_order_treedef_and_bytes_equal_the_references(tmp_path):
    state = _state()
    jck.save_pytree(state, str(tmp_path / "jax.ckpt"))
    tck.save_pytree(state, str(tmp_path / "port.ckpt"))
    jm, tm = _meta(tmp_path / "jax.ckpt"), _meta(tmp_path / "port.ckpt")
    assert tm["keys"] == jm["keys"]
    assert tm["keys"] == ["['b']/['a']/[0]", "['b']/['z']", "['opt']/[0]",
                          "['opt']/[1]/[0]", "['opt']/[1]/[2]", "['step']",
                          "['w']"]
    assert tm["treedef"] == jm["treedef"] == str(
        jax.tree_util.tree_structure(state))
    assert set(tm) == set(jm) == {"keys", "treedef", "time"}
    # every array, in order, with the same dtype, shape and bytes
    for path in ("jax.ckpt", "port.ckpt"):
        got = tck.load_pytree_flat(str(tmp_path / path))
        want = jck.load_pytree_flat(str(tmp_path / path))
        assert list(got) == list(want) == jm["keys"]
        assert _bytes(got) == _bytes(want)
    assert _bytes(tck.load_pytree_flat(str(tmp_path / "port.ckpt"))) == \
        _bytes(jck.load_pytree_flat(str(tmp_path / "jax.ckpt")))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_containers_load_in_the_other_package(tmp_path, writer):
    """numpy ``like`` gives numpy in either package; a tensor ``like``
    gives tensors of its dtype in the port."""
    state = _state(5)
    path = str(tmp_path / "x.ckpt")
    (jck if writer == "jax" else tck).save_pytree(state, path)
    like = jax.tree.map(np.asarray, _state(9))  # the JAX package needs arrays
    jout = jck.load_pytree(path, like)
    tout = tck.load_pytree(path, like)
    jl, jdef = jax.tree_util.tree_flatten(jout)
    tl, tdef = jax.tree_util.tree_flatten(tout)
    assert str(tdef) == str(jdef)
    for a, b in zip(tl, jl):
        assert isinstance(a, np.ndarray)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    tlike = {"w": torch.zeros((3, 4)), "step": torch.zeros((), dtype=torch.int32),
             "opt": [torch.zeros(5, dtype=torch.float64),
                     (torch.zeros(6, dtype=torch.int64), None,
                      np.zeros((), np.float64))],
             "b": {"z": np.zeros((), np.int64), "a": (torch.zeros(()),),
                   "empty": []}}
    got = tck.load_pytree(path, tlike)
    assert got["w"].dtype == torch.float32 and got["step"].dtype == torch.int32
    assert int(got["step"]) == 11
    np.testing.assert_array_equal(got["w"].numpy(), state["w"])
    np.testing.assert_array_equal(got["opt"][0].numpy(), state["opt"][0])
    assert got["opt"][1][1] is None and got["b"]["empty"] == []


def test_port_tensors_load_in_the_reference(tmp_path):
    """A tensor state written by the port restores in the JAX package."""
    g = torch.Generator().manual_seed(2)
    state = {"acc": torch.randn(4, 6, generator=g, dtype=torch.float64),
             "n": torch.tensor(3), "ids": [torch.arange(5, dtype=torch.int32)]}
    path = str(tmp_path / "t.ckpt")
    tck.save_pytree(state, path)
    like = {"acc": np.zeros((4, 6)), "n": np.zeros((), np.int64),
            "ids": [np.zeros(5, np.int32)]}
    out = jck.load_pytree(path, like)
    assert out["acc"].tobytes() == state["acc"].numpy().tobytes()
    assert int(out["n"]) == 3
    assert out["ids"][0].tolist() == [0, 1, 2, 3, 4]
    assert list(jck.load_pytree_flat(path)) == ["['acc']", "['ids']/[0]",
                                                "['n']"]


def test_like_mismatches_raise(tmp_path):
    path = tck.save_pytree({"a": np.zeros(2), "b": np.zeros(3)},
                           str(tmp_path / "m.ckpt"))
    for bad_like, match in (({"a": np.zeros(3)}, "leaves"),
                            ({"a": np.zeros(2), "b": np.zeros(4)}, "shape")):
        with pytest.raises(ValueError, match=match):
            tck.load_pytree(path, bad_like)


def test_tensor_leaves_are_snapshotted_before_save_returns(tmp_path,
                                                           monkeypatch):
    """Task code may write its state in place right after ``checkpoint``
    returns; the write in flight must still hold the values at the call.
    The background write is held until the task has mutated everything."""
    release = threading.Event()
    real = tck.save_pytree

    def held_save(tree, path):
        assert release.wait(10)
        return real(tree, path)

    monkeypatch.setattr(tck, "save_pytree", held_save)
    ck = tck.AsyncCheckpointer(str(tmp_path / "ck"))
    acc = torch.arange(8, dtype=torch.float32)
    view = acc[2:6]                       # a view shares the storage too
    ids = np.arange(4, dtype=np.int64)
    ck.save(0, {"acc": acc, "view": view, "ids": ids})
    acc.mul_(-1.0)
    view.add_(100.0)
    release.set()
    ck.wait()
    out = ck.restore(0, {"acc": torch.zeros(8), "view": torch.zeros(4),
                         "ids": np.zeros(4, np.int64)})
    assert out["acc"].tolist() == list(range(8))
    assert out["view"].tolist() == [2.0, 3.0, 4.0, 5.0]
    assert out["ids"].tolist() == [0, 1, 2, 3]


def test_bfloat16_round_trips_bit_exactly(tmp_path):
    g = torch.Generator().manual_seed(4)
    w = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    w[0, 0] = float("inf")
    w[0, 1] = float("-0.0")
    bits = w.view(torch.int16).clone()
    path = str(tmp_path / "bf.ckpt")
    tck.save_pytree({"w": w, "x": torch.ones(2)}, path)
    assert _meta(path)["dtypes"] == {"a0": "bfloat16"}
    out = tck.load_pytree(path, {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                                 "x": torch.zeros(2)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), bits)
    flat = tck.load_pytree_flat(path)
    assert flat["['w']"].dtype == torch.bfloat16
    assert torch.equal(flat["['w']"].view(torch.int16), bits)
    # a numpy like gets the bit pattern, as the data model carries it
    assert (tck.load_pytree(path, {"w": np.zeros((5, 7), np.int16),
                                   "x": np.zeros(2, np.float32)})["w"]
            == bits.numpy()).all()


def test_reference_bfloat16_leaves_load_bit_exactly_in_the_port(tmp_path):
    """The JAX package writes an ml_dtypes bfloat16 leaf as ``|V2``; the
    port reads it back as the same bits."""
    x = jnp.arange(6, dtype=jnp.bfloat16) * 1.5 - 2.0
    path = str(tmp_path / "j.ckpt")
    jck.save_pytree({"w": x}, path)
    out = tck.load_pytree(path, {"w": torch.zeros(6, dtype=torch.bfloat16)})
    assert out["w"].view(torch.int16).numpy().tobytes() == \
        np.asarray(x).tobytes()


def test_reference_cannot_read_bfloat16_leaves(tmp_path):
    """Pins ROADMAP Queue 3: the JAX package's ``load_pytree`` cannot cast
    its own ``|V2`` bfloat16 leaf back, and casts the port's int16 pattern
    by value."""
    x = jnp.arange(4, dtype=jnp.bfloat16) * 1.5
    path = str(tmp_path / "j.ckpt")
    jck.save_pytree({"w": x}, path)
    with pytest.raises(ValueError, match="cast"):
        jck.load_pytree(path, {"w": x})
    tpath = str(tmp_path / "t.ckpt")
    tck.save_pytree({"w": convert.tensor_from_numpy(np.asarray(x), CPU)}, tpath)
    got = jck.load_pytree(tpath, {"w": x})["w"]
    bits = np.asarray(x).view(np.int16)
    assert np.array_equal(got, bits.astype(np.asarray(x).dtype))
    assert not np.array_equal(np.asarray(got).view(np.int16), bits)


def test_latest_pointer_and_retention(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path / "ck"), keep=2)
    assert ck.latest_step() is None
    assert tck.restore_latest(str(tmp_path / "ck"), {"x": np.zeros(2)}) is None
    for s in range(4):
        ck.save(s, {"x": torch.full((2,), float(s))}, block=(s % 2 == 1))
    ck.wait()
    files = sorted(os.listdir(tmp_path / "ck"))
    assert files == ["LATEST", "step_00000002.ckpt", "step_00000003.ckpt"]
    step, state = tck.restore_latest(str(tmp_path / "ck"),
                                     {"x": torch.zeros(2)})
    assert step == 3 and state["x"].tolist() == [3.0, 3.0]
    # the JAX package's checkpointer reads the same directory
    jstep, jstate = jck.restore_latest(str(tmp_path / "ck"),
                                       {"x": np.zeros(2, np.float32)})
    assert jstep == 3 and jstate["x"].tolist() == [3.0, 3.0]


def test_async_checkpointer_surfaces_background_write_errors(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path / "ok"))
    ck.dir = str(tmp_path / "missing" / "deeper")  # writes now fail
    ck.save(0, {"x": torch.arange(3)})
    with pytest.raises(FileNotFoundError):
        ck.wait()
    ck.dir = str(tmp_path / "ok")
    ck.save(1, {"x": torch.arange(3)}, block=True)
    assert ck.latest_step() == 1
    ck.dir = str(tmp_path / "missing" / "deeper")
    with pytest.raises(FileNotFoundError):
        ck.save(2, {"x": torch.arange(3)}, block=True)
    # a parked error is raised by the next save, not only by wait
    ck.save(3, {"x": torch.arange(3)})
    ck._inflight.join()
    with pytest.raises(FileNotFoundError):
        ck.save(4, {"x": torch.arange(3)})


# ---------------------------------------------------------------------------
# the rescale re-cut of on-disk shards, in both packages
# ---------------------------------------------------------------------------
class _Driver:
    def __init__(self, root, ctxs):
        self._ck_root = root
        self._recovery_ctx = ctxs


class _Op:
    task, old_nslots, new_nslots = "c", 2, 3


def _recut(tmp_path, rec, rescale, shards, replica):
    ctxs = {}
    for i, shard in enumerate(shards):
        rc = rec.RecoveryContext("c", i, str(tmp_path / f"c_{i}"))
        for step in range(2):
            rc.checkpoint({"acc": shard, "n": replica}, step=step,
                          sharded_axes={"acc": 0})
        ctxs[("c", i)] = rc
    return rescale._recut_checkpoints(_Driver(str(tmp_path), ctxs), _Op, 1)


def test_recut_of_shards_matches_the_reference(tmp_path):
    from repro.core import recovery as jrec
    from repro.core import rescale as jrescale

    g = np.random.default_rng(8).standard_normal((7, 3)).astype(np.float32)
    n = np.array(5, np.int64)
    jC, jfl, jdirs = _recut(tmp_path / "jax", jrec, jrescale,
                            [g[:4], g[4:]], n)
    tC, tfl, tdirs = _recut(tmp_path / "port", trec, trescale,
                            [convert.tensor_from_numpy(g[:4], CPU),
                             convert.tensor_from_numpy(g[4:], CPU)],
                            torch.tensor(5))
    assert (tC, tfl) == (jC, jfl) == (1, {})
    for jd, td in zip(jdirs, tdirs):
        name = f"step_{jC:08d}.ckpt"
        assert _bytes(tck.load_pytree_flat(os.path.join(td, name))) == \
            _bytes(jck.load_pytree_flat(os.path.join(jd, name)))


def test_recut_keeps_bfloat16_shards_bit_exact(tmp_path):
    g = torch.randn(7, 3, generator=torch.Generator().manual_seed(6)) \
        .to(torch.bfloat16)
    C, _, dirs = _recut(tmp_path, trec, trescale, [g[:4], g[4:]],
                        torch.tensor(5))
    parts = []
    for d, rows in zip(dirs, (3, 2, 2)):
        step, state = tck.restore_latest(
            d, {"acc": torch.zeros(rows, 3, dtype=torch.bfloat16),
                "n": torch.zeros((), dtype=torch.int64)})
        assert step == C and int(state["n"]) == 5
        parts.append(state["acc"])
    assert torch.equal(torch.cat(parts).view(torch.int16), g.view(torch.int16))
