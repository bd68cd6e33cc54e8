"""The port's ``TaskComm.reshard`` beside the JAX package's: the twin of
``tests/test_reshard.py`` (the one-call user face of the M->N
subsystem).

Each case feeds both packages the same seeded input -- a tensor on the
port's side where the reference takes a device array or a numpy array
that a task would hold -- and holds the port's blocks equal, byte for
byte, to the reference's and to ``redistribute_numpy``.  Every workflow
runs through both packages (``torch_twins``).  Each reference case has a
twin of the same name.  By design:

* a tensor is the port's device array, so where the reference hands
  ``TaskComm.reshard`` a numpy array the twin hands the port a tensor,
  which ``prefer="auto"`` sends to the pack executors (the reference
  sends numpy to the scatter executors; the blocks are equal);
* ``test_reshard_prefer_pack_raises_when_unlowerable`` feeds the port a
  1-D tensor, which has no pack lowering either.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import comm as jcomm  # noqa: E402
from repro.core import datamodel as jdm  # noqa: E402
from repro.core import redistribute as jred  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import WorkflowGraph  # noqa: E402
from repro_torch.core import datamodel as tdm  # noqa: E402
from repro_torch.core import redistribute as tred  # noqa: E402
from repro_torch.core.comm import TaskComm  # noqa: E402
from repro_torch.core.datamodel import BlockOwnership, File  # noqa: E402
from repro_torch.core.redistribute import (RedistSpec, even_blocks,  # noqa: E402
                                           plan_cache, redistribute_numpy,
                                           reset_plan_cache)
from repro_torch.core.vol import VOL  # noqa: E402
from torch_twins import CPU, assert_same, owned, run_both  # noqa: E402


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), CPU)


def _np(b):
    return convert.numpy_from_tensor(b) if isinstance(b, torch.Tensor) \
        else np.asarray(b)


def _spec(axis=0, nslots=1, slot=0, nranks=2):
    return RedistSpec(axis=axis, nslots=nslots, slot=slot, nranks=nranks)


def _jspec(axis=0, nslots=1, slot=0, nranks=2):
    return jred.RedistSpec(axis=axis, nslots=nslots, slot=slot, nranks=nranks)


def _ragged_blocks(n, nranks, rng, axis=0, shape=None):
    """The reference test module's helper, copied (a port test imports no
    reference test)."""
    shape = (n,) if shape is None else tuple(shape)
    cuts = sorted(rng.choice(n + 1, size=nranks - 1, replace=True).tolist())
    bounds = [0] + cuts + [n]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        starts = tuple(lo if a == axis else 0 for a in range(len(shape)))
        bshape = tuple(hi - lo if a == axis else s for a, s in enumerate(shape))
        out.append((starts, bshape))
    return out


def _same(port_blocks, ref_blocks, want=None):
    assert len(port_blocks) == len(ref_blocks)
    for i, (p, r) in enumerate(zip(port_blocks, ref_blocks)):
        np.testing.assert_array_equal(_np(p), np.asarray(r))
        if want is not None:
            np.testing.assert_array_equal(_np(p), want[i])


def test_reshard_matches_redistribute_numpy_1d():
    g = np.arange(97.0)
    spec = _spec(nranks=3)
    want = redistribute_numpy(g, [((0,), g.shape)], spec.dst_boxes(g.shape)[0])
    ref = jcomm.TaskComm().reshard(g, _jspec(nranks=3), ranks="all")
    # a 1-D plan has no pack lowering: a CPU tensor takes the host scatter
    # (on the card it would raise under prefer="auto")
    got = TaskComm().reshard(_t(g), spec, ranks="all")
    assert all(isinstance(b, np.ndarray) for b in got)
    _same(got, ref, want)


def test_reshard_matches_redistribute_numpy_2d_both_axes():
    g = np.arange(23 * 17, dtype=np.float32).reshape(23, 17)
    for axis in (0, 1):
        spec = _spec(axis=axis, nslots=2, slot=1, nranks=2)
        jspec = _jspec(axis=axis, nslots=2, slot=1, nranks=2)
        dst, _ = spec.dst_boxes(g.shape)
        want = redistribute_numpy(g, [((0, 0), g.shape)], dst)
        got = TaskComm().reshard(_t(g), spec, ranks="all")
        assert all(isinstance(b, torch.Tensor) for b in got)
        _same(got, jcomm.TaskComm().reshard(g, jspec, ranks="all"), want)
        mine = TaskComm().reshard(_t(g), spec)
        _same(mine, jcomm.TaskComm().reshard(g, jspec),
              [want[r] for r in spec.my_ranks()])


def test_reshard_ragged_src_decomposition():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(41, 6)).astype(np.float32)
    src = _ragged_blocks(41, 4, rng, shape=g.shape)
    spec = _spec(nslots=3, slot=2, nranks=2)
    dst, _ = spec.dst_boxes(g.shape)
    want = redistribute_numpy(g, src, dst)
    got = TaskComm().reshard(_t(g), spec, src=src, ranks="all")
    ref = jcomm.TaskComm().reshard(g, _jspec(nslots=3, slot=2, nranks=2),
                                   src=src, ranks="all")
    _same(got, ref, want)


def test_reshard_dataset_ownership_is_src_decomposition():
    g = np.arange(64.0)
    counts = []
    for dm, red, comm, spec, data in (
            (tdm, tred, TaskComm, _spec(nranks=2), _t(g)),
            (jdm, jred, jcomm.TaskComm, _jspec(nranks=2), g)):
        f = dm.File("o.h5")
        own = owned(dm, red, g.shape, 4)
        ds = f.create_dataset("/g", data=data)
        ds.ownership = own
        red.reset_plan_cache()
        got = comm().reshard(ds, spec, ranks="all")
        want = redistribute_numpy(g, [own.blocks[r] for r in range(4)],
                                  spec.dst_boxes(g.shape)[0])
        _same(got, want)
        counts.append(red.plan_cache().snapshot())
    assert counts[0] == counts[1]
    assert counts[0]["misses"] == 1


def test_reshard_4to2_axis1_device_pack_path():
    g = np.arange(16 * 52, dtype=np.float32).reshape(16, 52)
    src = even_blocks(g.shape, 4, axis=1)
    spec = RedistSpec(axis=1, nslots=2, slot=0, nranks=1)
    dst, _ = spec.dst_boxes(g.shape)
    want = redistribute_numpy(g, src, dst)
    got = TaskComm().reshard(_t(g), spec, src=src, ranks="all",
                             prefer="pack", tile_rows=4)
    ref = jcomm.TaskComm().reshard(
        jnp.asarray(g), jred.RedistSpec(axis=1, nslots=2, slot=0, nranks=1),
        src=src, ranks="all", prefer="pack", tile_rows=4)
    assert all(isinstance(b, torch.Tensor) for b in got)
    _same(got, ref, want)
    assert plan_cache().get(src, dst, g.shape, g.dtype).pack_mode == "cols"


def test_reshard_device_rows_pack_path():
    g = np.arange(37 * 8, dtype=np.float32).reshape(37, 8)
    spec = _spec(nslots=2, slot=1, nranks=2)
    dst, _ = spec.dst_boxes(g.shape)
    want = redistribute_numpy(g, [((0, 0), g.shape)], dst)
    got = TaskComm().reshard(_t(g), spec, prefer="pack")
    ref = jcomm.TaskComm().reshard(jnp.asarray(g),
                                   _jspec(nslots=2, slot=1, nranks=2),
                                   prefer="pack")
    _same(got, ref, [want[r] for r in spec.my_ranks()])


def test_reshard_prefer_pack_raises_when_unlowerable():
    spec = _spec(nranks=2)
    with pytest.raises(ValueError, match="pack-kernel path unavailable"):
        TaskComm().reshard(np.zeros(8), spec, prefer="pack")
    with pytest.raises(ValueError, match="pack-kernel path unavailable"):
        TaskComm().reshard(torch.zeros(8), spec, prefer="pack")
    with pytest.raises(ValueError, match="pack-kernel path unavailable"):
        jcomm.TaskComm().reshard(np.zeros(8), _jspec(nranks=2), prefer="pack")


def test_reshard_spec_resolution_errors():
    c = TaskComm()
    with pytest.raises(ValueError, match="no RedistSpec wired"):
        c.reshard(torch.zeros(8))
    c2 = TaskComm(redist_specs={"a.h5": _spec(nranks=1),
                                "b.h5": _spec(nranks=2)})
    with pytest.raises(ValueError, match="distinct RedistSpecs"):
        c2.reshard(torch.zeros(8))
    with pytest.raises(ValueError, match="no RedistSpec for port"):
        c2.reshard(torch.zeros(8), port="c.h5")
    assert len(c2.reshard(torch.zeros(8), port="b.h5", ranks="all")) == 2
    c3 = TaskComm(redist_specs={"a.h5": _spec(nranks=4)})
    assert len(c3.reshard(torch.zeros(8), ranks="all")) == 4


def test_reshard_rank_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        TaskComm().reshard(torch.zeros(8), _spec(nranks=2), ranks=[5])


CONSUMER_YAML = """
tasks:
  - func: producer
    taskCount: 4
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    taskCount: 2
    nprocs: 2
    inports:
      - filename: o.h5
        redistribute: 1
        dsets: [{name: /g, memory: 1}]
"""


def _consumer_slab(s, n):
    own = owned(s.dm, s.red, (n,), 4)
    g = np.arange(n, dtype=np.float64)

    def producer(comm):
        with s.h5.File("o.h5", "w") as f:
            f.attrs["producer"] = comm.instance
            f.create_dataset("/g", data=s.data(g), ownership=own)

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            blocks = comm.reshard(f["/g"])
            for i, b in enumerate(blocks):
                s.record(("consumer", comm.instance, int(f.attrs["producer"]), i), b)

    return s.wilkins(CONSUMER_YAML, {"producer": producer,
                                     "consumer": consumer}).run(timeout=60)


def test_reshard_in_workflow_consumer_slab():
    n = 64
    t, j = run_both(_consumer_slab, n)
    assert_same(t, j)
    g = np.arange(n, dtype=np.float64)
    for (_, inst, _, i), (dt, _, raw) in t.side.got.items():
        spec = RedistSpec(axis=0, nslots=2, slot=inst, nranks=2)
        dst, _ = spec.dst_boxes(g.shape)
        starts, shape = dst[spec.my_ranks()[i]]
        np.testing.assert_array_equal(np.frombuffer(raw, dt),
                                      g[starts[0]:starts[0] + shape[0]])
    assert sorted({k[1] for k in t.side.got}) == [0, 1]


def test_reshard_slab_rejects_foreign_ranks():
    for data in (np.arange(32.0), _t(np.arange(32.0))):
        f = File("o.h5")
        ds = f.create_dataset("/g", data=data, copy=False)
        ds.attrs["redist_global_shape"] = [64]
        ds.attrs["redist_box_starts"] = [32]
        spec = RedistSpec(axis=0, nslots=2, slot=1, nranks=2)
        blocks = TaskComm().reshard(ds, spec, prefer="numpy")
        np.testing.assert_array_equal(_np(blocks[0]), np.arange(0.0, 16.0))
        np.testing.assert_array_equal(_np(blocks[1]), np.arange(16.0, 32.0))
        with pytest.raises(ValueError, match="not covered by the received slab"):
            TaskComm().reshard(ds, spec, ranks=[0])


# ---------------------------------------------------------------------------
# YAML producer ownership
# ---------------------------------------------------------------------------
def _graph(yaml):
    return WorkflowGraph.from_yaml(yaml)


def test_yaml_ownership_parses():
    g = _graph("""
tasks:
  - func: p
    nprocs: 4
    outports:
      - filename: o.h5
        ownership: {axis: 1}
        dsets: [{name: /g, memory: 1}]
""")
    port = g.tasks["p"].outports[0]
    assert port.ownership and port.own_axis == 1 and port.own_nranks is None
    g2 = _graph("""
tasks:
  - func: p
    nprocs: 4
    outports:
      - filename: o.h5
        ownership: {nranks: 4}
""")
    assert g2.tasks["p"].outports[0].own_nranks == 4


@pytest.mark.parametrize("ownership, err", [
    ("{axis: -1}", "axis must be >= 0"),
    ("{nranks: 0}", "nranks must be >= 1"),
    ("{axis: 0, blocks: 3}", "unknown ownership keys"),
])
def test_yaml_ownership_bad_values(ownership, err):
    with pytest.raises(ValueError, match=err):
        _graph(f"""
tasks:
  - func: p
    outports:
      - filename: o.h5
        ownership: {ownership}
""")


def test_yaml_ownership_mismatched_nranks():
    with pytest.raises(ValueError, match="matches neither nprocs=4 nor nwriters=4"):
        _graph("""
tasks:
  - func: p
    nprocs: 4
    outports:
      - filename: o.h5
        ownership: {nranks: 3}
""")
    g = _graph("""
tasks:
  - func: p
    nprocs: 4
    nwriters: 2
    outports:
      - filename: o.h5
        ownership: {nranks: 2}
""")
    assert g.tasks["p"].outports[0].own_nranks == 2


def test_yaml_ownership_rejected_on_inports():
    with pytest.raises(ValueError, match="ownership is an outport declaration"):
        _graph("""
tasks:
  - func: c
    inports:
      - filename: o.h5
        ownership: 1
""")


def test_vol_stamps_ownership_at_close():
    vol = VOL("p", nprocs=4)
    vol.set_ownership("o.h5", axis=0, nranks=4)
    f = File("o.h5")
    f.create_dataset("/g", data=_t(np.arange(16.0)), copy=False)
    pre = BlockOwnership()
    pre.add(0, (0,), (16,))
    f.create_dataset("/h", data=_t(np.arange(16.0))).ownership = pre
    f.create_dataset("/s", data=np.float64(3.0), shape=(), dtype=np.float64)
    vol.on_file_close(f)
    assert f["/g"].ownership.blocks == {
        0: ((0,), (4,)), 1: ((4,), (4,)), 2: ((8,), (4,)), 3: ((12,), (4,))}
    assert f["/h"].ownership is pre
    assert f["/s"].ownership is None


def test_vol_ownership_axis_out_of_range_is_clear():
    vol = VOL("p", nprocs=2)
    vol.set_ownership("o.h5", axis=2, nranks=2)
    f = File("o.h5")
    f.create_dataset("/g", data=_t(np.arange(8.0)))
    with pytest.raises(ValueError, match="axis 2 out of range"):
        vol.on_file_close(f)


OWN_YAML = """
tasks:
  - func: producer
    nprocs: 4
    outports:
      - filename: o.h5
        ownership: 1
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    taskCount: 2
    nprocs: 1
    inports:
      - filename: o.h5
        redistribute: 1
        dsets: [{name: /g, memory: 1}]
"""


def _yaml_ownership(s, n):
    def producer():
        with s.h5.File("o.h5", "w") as f:
            f.create_dataset("/g", data=s.data(np.arange(n, dtype=np.float64)))

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            s.record(("consumer", comm.instance, 0, 0), f["/g"])

    return s.wilkins(OWN_YAML, {"producer": producer,
                                "consumer": consumer}).run(timeout=60)


def test_yaml_ownership_flows_into_plan_src():
    n = 64
    t, j = run_both(_yaml_ownership, n)
    assert_same(t, j)
    got = {k[1]: np.frombuffer(raw, dt) for k, (dt, _, raw) in t.side.got.items()}
    np.testing.assert_array_equal(got[0], np.arange(32.0))
    np.testing.assert_array_equal(got[1], np.arange(32.0, 64.0))
    src4 = even_blocks((n,), 4)
    dst, _ = RedistSpec(axis=0, nslots=2, slot=0, nranks=1).dst_boxes((n,))
    plan = plan_cache().get(src4, dst, (n,), np.float64)
    assert len(plan.src) == 4
    assert plan_cache().snapshot()["misses"] == 1


def test_yaml_prefetch_rejected_on_outports():
    with pytest.raises(ValueError, match="prefetch is an inport declaration"):
        _graph("""
tasks:
  - func: p
    outports:
      - filename: o.h5
        prefetch: 1
""")


PRODUCER_YAML = """
tasks:
  - func: producer
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    taskCount: 2
    nprocs: 2
    inports:
      - filename: o.h5
        redistribute: 1
        dsets: [{name: /g, memory: 1}]
"""


def _producer_spec(s, n):
    g = np.arange(n, dtype=np.float64)
    results = {}

    def producer(comm):
        with pytest.raises(ValueError, match="has no 'mine'"):
            comm.reshard(s.data(g))
        results["all"] = comm.reshard(s.data(g), ranks="all")
        with s.h5.File("o.h5", "w") as f:
            f.create_dataset("/g", data=s.data(g))

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            s.record(("consumer", comm.instance, 0, 0), f["/g"])

    s.wilkins(PRODUCER_YAML, {"producer": producer,
                              "consumer": consumer}).run(timeout=60)
    return results["all"]


def test_reshard_producer_wired_spec_requires_explicit_ranks():
    n = 32
    t, j = run_both(_producer_spec, n)
    assert_same(t, j, report=False)
    g = np.arange(n, dtype=np.float64)
    assert len(t.result) == len(j.result) == 4
    _same(t.result, j.result)
    np.testing.assert_array_equal(_np(t.result[0]), g[:8])
    np.testing.assert_array_equal(_np(t.result[3]), g[24:])


def test_reshard_counters_stay_exact_across_threads():
    """Not in the reference: the port's reshard dispatch counter stays exact
    when four threads reshard tensors at once, as a workflow's consumer
    instances do."""
    from repro_torch.core.datamodel import reset_transport_stats, transport_stats
    reset_plan_cache()
    reset_transport_stats()
    g = _t(np.arange(64 * 4, dtype=np.float32).reshape(64, 4))

    def work():
        for _ in range(10):
            TaskComm().reshard(g, _spec(nranks=2), ranks="all")

    ts = [threading.Thread(target=work) for _ in range(4)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    assert transport_stats().snapshot()["reshard_pack"] == 40
