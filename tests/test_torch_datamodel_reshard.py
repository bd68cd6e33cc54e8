"""The port's data model and ``TaskComm.reshard`` beside the JAX package's:
CoW views over tensors, the in-place-write guard, the dtype helper, the
reshard dispatch and its counters, and the spill container both packages
read.  Each test names the reference test it mirrors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import comm as jcomm  # noqa: E402
from repro.core import datamodel as jdm  # noqa: E402
from repro.core import redistribute as jred  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import datamodel as tdm  # noqa: E402
from repro_torch.core import recovery as trec  # noqa: E402
from repro_torch.core import redistribute as tred  # noqa: E402
from repro_torch.core.channel import Channel  # noqa: E402

CPU = torch.device("cpu")


def _bits(a):
    if isinstance(a, torch.Tensor):
        return convert.numpy_from_tensor(a)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------- CoW views
def test_tensor_views_and_slabs_share_one_buffer_like_jax():
    """Mirrors test_transport_fastpath.py::test_view_shares_memory_until_write
    on device buffers: views and slabs alias the adopted buffer and count
    on one share; nothing is copied."""
    g = np.arange(32.0).reshape(8, 4)
    counts = {}
    for name, dm, data in (("port", tdm, convert.tensor_from_numpy(g, CPU)),
                           ("jax", jdm, jnp.asarray(g))):
        dm.reset_transport_stats()
        f = dm.File("o.h5")
        ds = f.create_dataset("/g", data=data, copy=False)
        v = ds.view()
        s = ds.slab_view((2, 0), (4, 4))
        counts[name] = (ds.share_count, v.share_count, s.share_count,
                        dm.transport_stats().snapshot()["copies"],
                        dm.transport_stats().snapshot()["views"])
        np.testing.assert_array_equal(_bits(s.read_direct()), g[2:6])
    assert counts["port"] == counts["jax"] == (3, 3, 3, 0, 2)
    t = convert.tensor_from_numpy(g, CPU)
    ds = tdm.File("o.h5").create_dataset("/g", data=t, copy=False)
    assert ds.read_direct() is t
    assert ds.slab_view((2, 0), (4, 4)).read_direct().data_ptr() == t[2].data_ptr()


def test_tensor_cow_write_materializes_host_copy():
    """Mirrors test_nd_reshard.py::test_device_dataset_cow_write_materializes_host_copy."""
    src = torch.arange(8.0)
    ds = tdm.File("o.h5").create_dataset("/g", data=src, copy=False)
    assert tdm.is_device_array(ds.read_direct())
    tdm.reset_transport_stats()
    ds[0] = -1.0
    got = ds.read_direct()
    assert isinstance(got, np.ndarray) and got[0] == -1.0
    assert float(src[0]) == 0.0
    assert tdm.transport_stats().snapshot()["cow_copies"] == 1
    # the reference does the same with a jax.Array
    jds = jdm.File("o.h5").create_dataset("/g", data=jnp.arange(8.0), copy=False)
    jds[0] = -1.0
    np.testing.assert_array_equal(jds.read_direct(), got)


def test_copy_true_snapshots_a_tensor_to_host():
    """Mirrors test_transport_fastpath.py::test_create_dataset_snapshots_caller_array."""
    t = torch.arange(6, dtype=torch.int32)
    tdm.reset_transport_stats()
    ds = tdm.File("o.h5").create_dataset("/g", data=t)
    got = ds.read_direct()
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    t.add_(1)  # the snapshot is the caller's value at creation
    np.testing.assert_array_equal(got, np.arange(6))
    assert tdm.transport_stats().snapshot()["copies"] == 1


def test_in_place_write_after_adoption_raises_everywhere():
    """torch lets a producer write a served tensor in place, which jax
    cannot: reads, views, slabs and serves of the stale dataset raise."""
    t = torch.zeros((8, 4))
    f = tdm.File("o.h5")
    ds = f.create_dataset("/g", data=t, copy=False)
    v = ds.view()
    t.mul_(2)
    for op in (ds.read_direct, v.read_direct, ds.view,
               lambda: ds.slab_view((0, 0), (4, 4)), lambda: v[0]):
        with pytest.raises(RuntimeError, match="modified in place"):
            op()
    ch = Channel("c", ("p", 0), ("c", 0), "o.h5", ["/g"])
    with pytest.raises(RuntimeError, match="modified in place"):
        ch.filter_file(f)
    # a write through a view of the tensor (shared counter) is caught too
    t2 = torch.zeros((8, 4))
    ds2 = tdm.File("o.h5").create_dataset("/g", data=t2, copy=False)
    t2[:, 1].fill_(1.0)
    with pytest.raises(RuntimeError, match="modified in place"):
        ds2.read_direct()


def test_inference_tensor_is_refused_at_adoption():
    with torch.inference_mode():
        t = torch.zeros(4)
    with pytest.raises(ValueError, match="version counter"):
        tdm.File("o.h5").create_dataset("/g", data=t, copy=False)


# -------------------------------------------------------------- dtype helper
def test_dtype_helper_names_and_bfloat16():
    assert convert.dtype_name(torch.float32) == convert.dtype_name(np.float32) \
        == "float32"
    assert convert.dtype_name(torch.bfloat16) == "bfloat16"
    assert convert.dtype_name(np.dtype(ml_dtypes.bfloat16)) == "bfloat16"
    assert convert.as_dtype(torch.float64) == np.dtype(np.float64)
    assert convert.as_dtype(torch.bfloat16) is torch.bfloat16
    assert convert.host_dtype(torch.bfloat16) == np.dtype(np.int16)
    with pytest.raises(TypeError):
        np.dtype(torch.float32)  # why the helper exists
    # bf16 crosses both ways through its 16-bit pattern, bit for bit
    a = np.asarray(jnp.linspace(-3, 3, 11, dtype=jnp.bfloat16))
    t = convert.tensor_from_numpy(a, CPU)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.numpy_from_tensor(t), a.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    ds = tdm.File("o.h5").create_dataset("/b", data=t, copy=False)
    assert ds.dtype is torch.bfloat16 and ds.nbytes == 22
    host = convert.host_copy(t)
    assert host.dtype == np.int16 and not np.shares_memory(host, a)


# ------------------------------------------------------- TaskComm.reshard
def _spec(axis=0, nslots=1, slot=0, nranks=2):
    return tred.RedistSpec(axis=axis, nslots=nslots, slot=slot, nranks=nranks)


def test_reshard_4to2_axis1_pack_path_matches_jax():
    """Mirrors test_reshard.py::test_reshard_4to2_axis1_device_pack_path."""
    g = np.arange(16 * 52, dtype=np.float32).reshape(16, 52)
    src = jred.even_blocks(g.shape, 4, axis=1)
    spec = _spec(axis=1, nslots=2, slot=0, nranks=1)
    got = tcomm.TaskComm().reshard(convert.tensor_from_numpy(g, CPU), spec,
                                   src=src, ranks="all", prefer="pack",
                                   tile_rows=4)
    ref = jcomm.TaskComm().reshard(jnp.asarray(g), jred.RedistSpec(1, 2, 0, 1),
                                   src=src, ranks="all", prefer="pack",
                                   tile_rows=4)
    assert all(isinstance(b, torch.Tensor) for b in got)
    assert all(isinstance(b, jax.Array) for b in ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_bits(a), np.asarray(b))
    dst, _ = spec.dst_boxes(g.shape)
    assert tred.plan_cache().get(src, dst, g.shape, torch.float32).pack_mode == "cols"


def test_reshard_rows_and_rank3_pack_path_matches_jax():
    """Mirrors test_reshard.py::test_reshard_device_rows_pack_path and
    test_nd_reshard.py::test_reshard_rank3_middle_axis_device_array."""
    for shape, axis, tile in (((37, 8), 0, 8), ((6, 40, 3), 1, 4)):
        g = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        spec = _spec(axis=axis, nslots=2, slot=1, nranks=2)
        got = tcomm.TaskComm().reshard(convert.tensor_from_numpy(g, CPU), spec,
                                       prefer="pack", tile_rows=tile)
        ref = jcomm.TaskComm().reshard(jnp.asarray(g),
                                       jred.RedistSpec(axis, 2, 1, 2),
                                       prefer="pack", tile_rows=tile)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_bits(a), np.asarray(b))


def test_reshard_slab_dataset_dispatches_to_pack_like_jax():
    """Mirrors test_nd_reshard.py::test_device_slab_dataset_dispatches_to_pack_kernels."""
    g = np.arange(32 * 5 * 2, dtype=np.float32).reshape(32, 5, 2)
    spec = _spec(nslots=2, slot=1, nranks=2)
    dst, slots = spec.dst_boxes(g.shape)
    starts, shape = slots[1]
    slab = g[starts[0]:starts[0] + shape[0]]
    blocks = {}
    for name, dm, cm, data in (
            ("port", tdm, tcomm, convert.tensor_from_numpy(slab, CPU)),
            ("jax", jdm, jcomm, jnp.asarray(slab))):
        ds = dm.File("o.h5").create_dataset("/g", data=data, copy=False)
        ds.attrs["redist_global_shape"] = list(g.shape)
        ds.attrs["redist_box_starts"] = list(starts)
        blocks[name] = cm.TaskComm().reshard(ds, spec, prefer="pack", tile_rows=4)
        with pytest.raises(ValueError, match="not covered by the received slab"):
            cm.TaskComm().reshard(ds, spec, ranks=[0], prefer="pack")
    for a, b in zip(blocks["port"], blocks["jax"]):
        np.testing.assert_array_equal(_bits(a), np.asarray(b))


def test_reshard_errors_match_jax():
    """Mirrors test_reshard.py:106-130: prefer="pack" on an unlowerable
    input, spec resolution and rank range errors."""
    for cm, rs in ((tcomm, tred.RedistSpec), (jcomm, jred.RedistSpec)):
        spec = rs(nranks=2)
        with pytest.raises(ValueError, match="pack-kernel path unavailable"):
            cm.TaskComm().reshard(np.zeros(8), spec, prefer="pack")
        with pytest.raises(ValueError, match="prefer must be"):
            cm.TaskComm().reshard(np.zeros(8), spec, prefer="gpu")
        c = cm.TaskComm()
        with pytest.raises(ValueError, match="no RedistSpec wired"):
            c.reshard(np.zeros(8))
        c2 = cm.TaskComm(redist_specs={"a.h5": rs(nranks=1), "b.h5": rs(nranks=2)})
        with pytest.raises(ValueError, match="distinct RedistSpecs"):
            c2.reshard(np.zeros(8))
        with pytest.raises(ValueError, match="no RedistSpec for port"):
            c2.reshard(np.zeros(8), port="c.h5")
        assert len(c2.reshard(np.zeros(8), port="b.h5", ranks="all")) == 2
        with pytest.raises(ValueError, match="out of range"):
            cm.TaskComm().reshard(np.zeros(8), spec, ranks=[5])
    # a 1-D tensor has no kernel lowering either
    with pytest.raises(ValueError, match="pack-kernel path unavailable"):
        tcomm.TaskComm().reshard(torch.zeros(8), _spec(), prefer="pack")


def test_reshard_auto_never_moves_a_device_tensor_to_the_host():
    """Under prefer="auto" a tensor off the CPU that the kernels cannot
    serve raises (a ``meta`` tensor stands in for a card here); a CPU
    tensor still takes the numpy executors."""
    spec = _spec(nranks=2)
    on_dev = torch.zeros(8, device="meta")        # 1-D: no kernel lowering
    tdm.reset_transport_stats()
    with pytest.raises(ValueError, match='pass prefer="numpy"'):
        tcomm.TaskComm().reshard(on_dev, spec, ranks="all")
    ds = tdm.File("o.h5").create_dataset("/m", data=on_dev, copy=False)
    with pytest.raises(ValueError, match='pass prefer="numpy"'):
        tcomm.TaskComm().reshard(ds, spec, ranks="all")
    s = tdm.transport_stats().snapshot()
    assert (s["reshard_pack"], s["reshard_numpy"]) == (0, 0)
    blocks = tcomm.TaskComm().reshard(torch.arange(8.0), spec, ranks="all")
    assert all(isinstance(b, np.ndarray) for b in blocks)
    assert tdm.transport_stats().snapshot()["reshard_numpy"] == 1


def test_reshard_counters_match_jax():
    """reshard_pack / reshard_numpy count the same dispatches in both
    packages; prefer="numpy" on a tensor returns host arrays."""
    g = np.arange(24 * 6, dtype=np.float32).reshape(24, 6)
    snaps, outs = {}, {}
    for name, dm, cm, rs, conv in (
            ("port", tdm, tcomm, tred.RedistSpec,
             lambda a: convert.tensor_from_numpy(a, CPU)),
            ("jax", jdm, jcomm, jred.RedistSpec, jnp.asarray)):
        dm.reset_transport_stats()
        spec = rs(axis=0, nslots=1, slot=0, nranks=3)
        c = cm.TaskComm()
        outs[name] = [c.reshard(conv(g), spec, ranks="all"),
                      c.reshard(conv(g), spec, ranks="all", prefer="numpy"),
                      c.reshard(g, spec, ranks="all"),
                      c.reshard(conv(g[:, 0]), spec, ranks="all")]
        s = dm.transport_stats().snapshot()
        snaps[name] = (s["reshard_pack"], s["reshard_numpy"])
    assert snaps["port"] == snaps["jax"] == (1, 3)
    assert all(isinstance(b, np.ndarray) for b in outs["port"][1])
    for p_call, j_call in zip(outs["port"], outs["jax"]):
        for a, b in zip(p_call, j_call):
            np.testing.assert_array_equal(_bits(a), np.asarray(b))


def test_taskcomm_device_and_mesh():
    """Mirrors test_nd_reshard.py::test_mesh_overcommit_raises_clear_error."""
    devs = [torch.device("cpu")] * 4
    c = tcomm.TaskComm(task="t", devices=devs)
    assert c.device == torch.device("cpu")
    m = c.mesh((2, 2))
    assert m.shape == (2, 2) and m.dtype == object
    assert all(d == torch.device("cpu") for d in m.flat)
    assert c.mesh().shape == (4,)
    with pytest.raises(ValueError, match="needs 8 devices"):
        c.mesh((2, 4))
    assert tcomm.TaskComm().device == torch.device("cuda", 0)


def test_reshard_blocks_takes_tensors():
    blocks = [torch.arange(0.0, 10.0), torch.arange(10.0, 16.0)]
    got = trec.reshard_blocks(blocks, 3)
    want = jred.redistribute_numpy(np.arange(16.0), [((0,), (10,)), ((10,), (6,))],
                                   jred.even_blocks((16,), 3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_restores_tensors_where_like_lives(tmp_path):
    ctx = trec.RecoveryContext("t", 0, str(tmp_path / "ck"), [], [])
    assert ctx.restore(like={"x": torch.zeros(3)}) is None
    assert ctx.checkpoint({"x": torch.arange(3.0), "n": np.int64(4)}) == 0
    step, state = trec.RecoveryContext("t", 0, str(tmp_path / "ck")).restore(
        like={"x": torch.zeros(3, dtype=torch.float64), "n": np.zeros((), np.int64)})
    assert step == 0 and state["x"].dtype == torch.float64
    assert state["x"].tolist() == [0.0, 1.0, 2.0] and int(state["n"]) == 4


# --------------------------------------------------------------- spill files
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spill_container_loads_in_the_other_package(tmp_path, writer):
    """A spill written by either package loads in the other byte for byte
    (mirrors test_transport_fastpath.py::test_spill_roundtrip_preserves_attrs_and_ownership)."""
    rng = np.random.default_rng(5)
    arrays = {"/grid": rng.normal(size=(6, 5)).astype(np.float32),  # jax: no x64
              "/p/ids": np.arange(7, dtype=np.int32),
              "/p/w": rng.integers(0, 255, size=(3,)).astype(np.uint8)}
    own = tdm.BlockOwnership()
    own.add(0, (0, 0), (3, 5))
    own.add(1, (3, 0), (3, 5))
    if writer == "port":
        f = convert.file_from_numpy(arrays, device=CPU, filename="s.h5",
                                    ownership={"/grid": own})
        f.attrs["step"] = 3
        f["/grid"].attrs["units"] = "g/cc"
        path = f.save(str(tmp_path))
        loaded = jdm.File.load(path)
    else:
        f = jdm.File("s.h5")
        for p, a in arrays.items():
            f.create_dataset(p, data=jnp.asarray(a), copy=False)
        f["/grid"].ownership = jdm.BlockOwnership(dict(own.blocks))
        f.attrs["step"] = 3
        f["/grid"].attrs["units"] = "g/cc"
        path = f.save(str(tmp_path))
        loaded = tdm.File.load(path)
    assert loaded.attrs["step"] == 3
    assert loaded["/grid"].attrs["units"] == "g/cc"
    assert loaded["/grid"].ownership.blocks == own.blocks
    for p, a in arrays.items():
        got = loaded[p].read_direct()
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)
    with open(path, "rb") as fh:
        data = fh.read()
    other = tmp_path / "again"
    (jdm if writer == "jax" else tdm).File.load(path).save(str(other))
    assert (other / "s.h5").read_bytes() == data
