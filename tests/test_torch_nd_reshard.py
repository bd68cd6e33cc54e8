"""N-D pack lowering, device-slab dispatch, per-edge prefetch depth and the
prefetch-pool lifecycle on the port beside the JAX package: the twin of
``tests/test_nd_reshard.py``.

The pack cases hand the port tensors and the reference ``jax.Array``s of
the same seeded data and hold the blocks equal to each other and to
``redistribute_numpy``; the workflow cases run through both packages
(``torch_twins``); the pool, channel-depth and parse cases check the
port's own machinery.  Each reference case has a twin of the same name.
By design:

* ``test_mesh_within_budget_still_builds``: the port's ``TaskComm.mesh``
  is a grid of ``torch.device``s (a numpy object array), not a
  ``jax.sharding.Mesh``; the twin asserts that grid.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import redistribute as jred  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Wilkins  # noqa: E402
from repro_torch.core import channel as channel_mod  # noqa: E402
from repro_torch.core import datamodel as tdm  # noqa: E402
from repro_torch.core import redistribute as tred  # noqa: E402
from repro_torch.core.channel import (DEFAULT_PREFETCH_DEPTH, Channel,  # noqa: E402
                                      FlowControl, PrefetchPool,
                                      configure_prefetch_pool,
                                      shutdown_prefetch_pool)
from repro_torch.core.comm import TaskComm  # noqa: E402
from repro_torch.core.datamodel import (File, is_device_array,  # noqa: E402
                                        reset_transport_stats, transport_stats)
from repro_torch.core.graph import WorkflowGraph  # noqa: E402
from repro_torch.core.redistribute import (CompiledPlan, RedistSpec,  # noqa: E402
                                           even_blocks, execute_pack_torch,
                                           execute_pack_torch_all, plan_cache,
                                           redistribute_numpy,
                                           reset_plan_cache)
from torch_twins import CPU, assert_same, owned, run_both  # noqa: E402


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), CPU)


def _np(b):
    return convert.numpy_from_tensor(b) if isinstance(b, torch.Tensor) \
        else np.asarray(b)


def _same(port_blocks, ref_blocks, want):
    assert len(port_blocks) == len(ref_blocks) == len(want)
    for p, r, w in zip(port_blocks, ref_blocks, want):
        assert isinstance(p, torch.Tensor)
        np.testing.assert_array_equal(_np(p), np.asarray(r))
        np.testing.assert_array_equal(_np(p), w)


# ---------------------------------------------------------------------------
# N-D pack lowering (flatten transform)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape, axis, m_src, m_dst, tile", [
    ((37, 5, 6), 0, 4, 3, 4),
    ((6, 40, 3), 1, 3, 2, 4),
    ((4, 6, 23), 2, 4, 5, 4),
    ((3, 4, 5, 23), 3, 4, 5, 4),
    ((23, 3, 4, 5), 0, 5, 2, 8),
    ((3, 17, 4, 5), 1, 2, 3, 4),
])
def test_nd_pack_matches_numpy_reference(shape, axis, m_src, m_dst, tile):
    rng = np.random.default_rng(sum(shape) * 31 + axis)
    g = rng.normal(size=shape).astype(np.float32)
    src = even_blocks(shape, m_src, axis=axis)
    dst = even_blocks(shape, m_dst, axis=axis)
    plan = CompiledPlan(src, dst, shape, g.dtype)
    jplan = jred.CompiledPlan(src, dst, shape, g.dtype)
    assert plan.pack_mode == jplan.pack_mode == ("rows" if axis == 0 else "cols")
    assert plan.pack_axis == jplan.pack_axis == axis
    want = redistribute_numpy(g, src, dst)
    got = execute_pack_torch_all(plan, _t(g), tile_rows=tile)
    _same(got, jred.execute_pack_jax_all(jplan, jnp.asarray(g), tile_rows=tile),
          want)
    one = execute_pack_torch(plan, m_dst - 1, _t(g), tile_rows=tile)
    np.testing.assert_array_equal(_np(one), want[-1])


def test_nd_cross_axis_exchange_lowers_via_dst_axis():
    g = np.arange(8 * 3 * 24, dtype=np.float32).reshape(8, 3, 24)
    src, dst = even_blocks(g.shape, 4, axis=0), even_blocks(g.shape, 3, axis=2)
    plan = CompiledPlan(src, dst, g.shape, g.dtype)
    assert plan.pack_mode == "cols" and plan.pack_axis == 2
    jplan = jred.CompiledPlan(src, dst, g.shape, g.dtype)
    _same(execute_pack_torch_all(plan, _t(g), tile_rows=4),
          jred.execute_pack_jax_all(jplan, jnp.asarray(g), tile_rows=4),
          plan.execute_global(g))


def test_nd_genuinely_cross_axis_falls_back_to_numpy():
    shape = (8, 8, 3)
    quads = [((0, 0, 0), (4, 4, 3)), ((0, 4, 0), (4, 4, 3)),
             ((4, 0, 0), (4, 4, 3)), ((4, 4, 0), (4, 4, 3))]
    plan = CompiledPlan([((0, 0, 0), shape)], quads, shape, np.float32)
    assert plan.pack_mode is None and plan.pack_axis is None
    with pytest.raises(ValueError, match="not pack-kernel lowerable"):
        execute_pack_torch(plan, 0, torch.zeros(shape))
    g = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = redistribute_numpy(g, [((0, 0, 0), shape)], quads)
    for w, a in zip(want, plan.execute_global(g)):
        np.testing.assert_array_equal(w, a)
    # a tensor reshard of it takes the host scatter only when asked
    spec_blocks = TaskComm().reshard(
        _t(g), RedistSpec(axis=0, nslots=1, slot=0, nranks=2), ranks="all",
        prefer="numpy")
    assert all(isinstance(b, np.ndarray) for b in spec_blocks)


def test_reshard_rank3_device_array_takes_pack_path():
    g = np.arange(24 * 5 * 6, dtype=np.float32).reshape(24, 5, 6)
    spec = RedistSpec(axis=0, nslots=2, slot=0, nranks=2)
    dst, _ = spec.dst_boxes(g.shape)
    want = redistribute_numpy(g, [((0, 0, 0), g.shape)], dst)
    reset_plan_cache()
    reset_transport_stats()
    got = TaskComm().reshard(_t(g), spec, ranks="all", prefer="pack",
                             tile_rows=4)
    from repro.core import comm as jcomm
    ref = jcomm.TaskComm().reshard(
        jnp.asarray(g), jred.RedistSpec(axis=0, nslots=2, slot=0, nranks=2),
        ranks="all", prefer="pack", tile_rows=4)
    _same(got, ref, want)
    plan = plan_cache().get([((0, 0, 0), g.shape)], dst, g.shape, g.dtype)
    assert plan.pack_mode == "rows"
    s = transport_stats().snapshot()
    assert s["reshard_pack"] == 1 and s["reshard_numpy"] == 0


def test_reshard_rank3_middle_axis_device_array():
    g = np.arange(6 * 40 * 3, dtype=np.float32).reshape(6, 40, 3)
    spec = RedistSpec(axis=1, nslots=2, slot=1, nranks=2)
    dst, _ = spec.dst_boxes(g.shape)
    want = redistribute_numpy(g, [((0, 0, 0), g.shape)], dst)
    got = TaskComm().reshard(_t(g), spec, prefer="pack", tile_rows=4)
    for r, a in zip(spec.my_ranks(), got):
        np.testing.assert_array_equal(want[r], _np(a))


# ---------------------------------------------------------------------------
# device-slab pack-path dispatch
# ---------------------------------------------------------------------------
def _slab_dataset(g, spec, slot, data_transform=lambda x: x):
    dst, slots = spec.dst_boxes(g.shape)
    starts, shape = slots[slot]
    slc = tuple(slice(s, s + n) for s, n in zip(starts, shape))
    f = File("o.h5")
    ds = f.create_dataset("/g", data=data_transform(np.ascontiguousarray(g[slc])),
                          copy=False)
    ds.attrs["redist_global_shape"] = list(g.shape)
    ds.attrs["redist_box_starts"] = list(starts)
    return ds, dst


def test_device_slab_dataset_dispatches_to_pack_kernels():
    g = np.arange(32 * 5 * 2, dtype=np.float32).reshape(32, 5, 2)
    spec = RedistSpec(axis=0, nslots=2, slot=1, nranks=2)
    ds, dst = _slab_dataset(g, spec, 1, _t)
    assert is_device_array(ds.read_direct())
    want = redistribute_numpy(g, [((0, 0, 0), g.shape)], dst)
    blocks = TaskComm().reshard(ds, spec, prefer="pack", tile_rows=4)
    assert all(isinstance(b, torch.Tensor) for b in blocks)
    for r, b in zip(spec.my_ranks(), blocks):
        np.testing.assert_array_equal(want[r], _np(b))
    with pytest.raises(ValueError, match="not covered by the received slab"):
        TaskComm().reshard(ds, spec, ranks=[0], prefer="pack")


def test_device_slab_2d_axis1_pack_dispatch():
    g = np.arange(8 * 48, dtype=np.float32).reshape(8, 48)
    spec = RedistSpec(axis=1, nslots=2, slot=0, nranks=2)
    ds, dst = _slab_dataset(g, spec, 0, _t)
    want = redistribute_numpy(g, [((0, 0), g.shape)], dst)
    blocks = TaskComm().reshard(ds, spec, prefer="pack", tile_rows=4)
    for r, b in zip(spec.my_ranks(), blocks):
        np.testing.assert_array_equal(want[r], _np(b))


def test_slab_covering_only_run_head_raises_not_corrupts():
    shape = (100, 8)
    dst = [((40, 0), (30, 8))]
    plan = CompiledPlan([((0, 0), shape)], dst, shape, np.float32)
    with pytest.raises(ValueError, match="does not cover this rank"):
        execute_pack_torch(plan, 0, torch.zeros((10, 8)), tile_rows=8,
                           slab_box=((40, 0), (10, 8)))


def test_host_slab_dataset_still_uses_numpy_scatter():
    g = np.arange(32 * 3, dtype=np.float64).reshape(32, 3)
    spec = RedistSpec(axis=0, nslots=2, slot=0, nranks=2)
    ds, dst = _slab_dataset(g, spec, 0, np.array)
    want = redistribute_numpy(g, [((0, 0), g.shape)], dst)
    blocks = TaskComm().reshard(ds, spec)
    assert all(isinstance(b, np.ndarray) for b in blocks)
    for r, b in zip(spec.my_ranks(), blocks):
        np.testing.assert_array_equal(want[r], b)


def test_device_dataset_cow_write_materializes_host_copy():
    f = File("o.h5")
    src = torch.arange(8.0)
    ds = f.create_dataset("/g", data=src, copy=False)
    assert is_device_array(ds.read_direct())
    ds[0] = -1.0
    got = ds.read_direct()
    assert isinstance(got, np.ndarray) and got[0] == -1.0
    assert float(src[0]) == 0.0


# ---------------------------------------------------------------------------
# io_freq validation at graph parse time
# ---------------------------------------------------------------------------
def test_io_freq_typo_rejected_at_parse_naming_task_and_port():
    yaml = """
tasks:
  - func: sim
    outports:
      - filename: o.h5
  - func: ana
    inports:
      - filename: o.h5
        io_freq: -2
"""
    with pytest.raises(ValueError, match=r"task 'ana' port 'o.h5'.*io_freq -2"):
        WorkflowGraph.from_yaml(yaml)


def test_io_freq_valid_values_still_parse():
    for freq in (0, 1, 2, 7, -1):
        g = WorkflowGraph.from_yaml(f"""
tasks:
  - func: ana
    inports:
      - filename: o.h5
        io_freq: {freq}
""")
        assert g.tasks["ana"].inports[0].io_freq == freq


def test_flow_control_decode_still_guards():
    with pytest.raises(ValueError, match="invalid io_freq -2"):
        FlowControl.from_io_freq(-2)


# ---------------------------------------------------------------------------
# prefetch executor lifecycle
# ---------------------------------------------------------------------------
def _mxn_yaml(extra=""):
    return f"""
tasks:
  - func: producer
    taskCount: 2
    outports:
      - filename: o.h5
        dsets: [{{name: /g, memory: 1}}]
  - func: consumer
    taskCount: 2
    nprocs: 1
    inports:
      - filename: o.h5
        redistribute: 1
        {extra}
        dsets: [{{name: /g, memory: 1}}]
"""


def _run_pool_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("wilkins-prefetch-run")]


def _wait_no_run_pool_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _run_pool_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _run_pool_threads()


def _mxn(s, n=64, steps=1, fail=False):
    own = owned(s.dm, s.red, (n,), 2)

    def producer(comm):
        for t in range(steps):
            with s.h5.File("o.h5", "w") as f:
                f.attrs["producer"] = comm.instance
                f.attrs["step"] = t
                f.create_dataset("/g", data=s.data(
                    np.arange(n, dtype=np.float64) + t), ownership=own)

    def consumer(comm):
        if fail:
            raise RuntimeError("consumer boom")
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            s.record(("consumer", comm.instance, int(f.attrs["producer"]),
                      int(f.attrs["step"])), f["/g"])

    w = s.wilkins(_mxn_yaml(), {"producer": producer, "consumer": consumer})
    if fail:
        with pytest.raises(RuntimeError, match="consumer boom") as ei:
            w.run(timeout=60)
        return w, ei.value.report
    return w, w.run(timeout=60)


def _mxn_both(**kw):
    if kw.get("fail"):
        shutdown_prefetch_pool()
    t, j = run_both(_mxn, **kw)
    (w, rep), (_, jrep) = t.result, j.result
    t.result, j.result = rep, jrep
    return w, t, j


def test_prefetch_pool_torn_down_after_successful_run():
    shutdown_prefetch_pool()
    w, t, j = _mxn_both()
    assert_same(t, j)
    assert all(c._prefetch_pool is None for c in w.channels)
    assert _wait_no_run_pool_threads()
    assert channel_mod._PREFETCH_POOL is None


def test_prefetch_pool_torn_down_on_error_path():
    w, t, j = _mxn_both(fail=True)
    assert all(c._prefetch_pool is None for c in w.channels)
    assert _wait_no_run_pool_threads()
    assert channel_mod._PREFETCH_POOL is None


def test_concurrent_runs_use_independent_pools():
    barrier = threading.Barrier(2, timeout=30)
    reports = {}
    lock = threading.Lock()

    def make_funcs():
        from repro_torch.core import h5

        def producer():
            with h5.File("o.h5", "w") as f:
                f.create_dataset("/g", data=_t(np.arange(64.0)),
                                 ownership=owned(tdm, tred, (64,), 2))

        def consumer():
            while True:
                if h5.File("o.h5", "r") is None:
                    break

        return {"producer": producer, "consumer": consumer}

    def run_one(tag):
        w = Wilkins(_mxn_yaml(), make_funcs(), devices=[CPU])
        barrier.wait()
        rep = w.run(timeout=60)
        with lock:
            reports[tag] = rep

    ts = [threading.Thread(target=run_one, args=(i,), daemon=True)
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
        assert not t.is_alive()
    assert len(reports) == 2
    for rep in reports.values():
        assert rep.total_served == 2
    assert _wait_no_run_pool_threads()


def test_prefetch_pool_workers_are_daemon_and_drain_on_shutdown():
    pool = PrefetchPool(max_workers=2, thread_name_prefix="t-pool")
    assert all(t.daemon for t in pool._threads)
    assert pool.submit(lambda: 41 + 1).result(timeout=5) == 42
    pool.shutdown()
    deadline = time.monotonic() + 5
    while pool.alive_workers() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.alive_workers() == 0
    with pytest.raises(RuntimeError, match="shut down"):
        pool.submit(lambda: None)


def test_prefetch_pool_shutdown_cancels_queued_preps():
    started = threading.Event()
    release = threading.Event()

    def blocker():
        started.set()
        release.wait(10)
        return "done"

    pool = PrefetchPool(max_workers=1)
    f1 = pool.submit(blocker)
    assert started.wait(5)
    f2 = pool.submit(lambda: "never runs")
    pool.shutdown()
    assert f2.cancelled()
    release.set()
    assert f1.result(timeout=5) == "done"


def test_configure_prefetch_pool_replaces_and_shuts_old():
    old = configure_prefetch_pool(1)
    new = configure_prefetch_pool(2)
    assert new is not old
    with pytest.raises(RuntimeError):
        old.submit(lambda: None)
    shutdown_prefetch_pool()
    assert channel_mod._PREFETCH_POOL is None


# ---------------------------------------------------------------------------
# per-edge prefetch depth
# ---------------------------------------------------------------------------
def test_prefetch_yaml_depth_parses_and_reaches_channel():
    noop = {"producer": lambda: None, "consumer": lambda: None}
    w = Wilkins(_mxn_yaml(extra="prefetch: 3"), noop, devices=[CPU])
    assert all(c.prefetch == 3 for c in w.channels)
    w2 = Wilkins(_mxn_yaml(), noop, devices=[CPU])
    assert all(c.prefetch == DEFAULT_PREFETCH_DEPTH for c in w2.channels)
    with pytest.raises(ValueError, match="prefetch depth must be >= 0"):
        WorkflowGraph.from_yaml(_mxn_yaml(extra="prefetch: -1"))


def _tensor_file():
    f = File("o.h5")
    f.create_dataset("/g", data=_t(np.arange(16.0)), copy=False)
    return f


@pytest.mark.slow
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_depth_bounds_inflight_preps_per_edge(depth):
    f = _tensor_file()
    ch = Channel("c", ("p", 0), ("c", 0), "o.h5", ["/g"], queue_depth=8,
                 redistribute=RedistSpec(axis=0, nslots=2, slot=0, nranks=1),
                 prefetch=depth)
    configure_prefetch_pool(8)
    lock = threading.Lock()
    state = {"cur": 0, "max": 0}
    orig = ch._prepare

    def slow_prepare(*a, **kw):
        with lock:
            state["cur"] += 1
            state["max"] = max(state["max"], state["cur"])
        try:
            time.sleep(0.05)
            return orig(*a, **kw)
        finally:
            with lock:
                state["cur"] -= 1

    ch._prepare = slow_prepare
    try:
        consumed = []

        def consume():
            while True:
                got = ch.get(timeout=20)
                if got is None:
                    return
                consumed.append(got)

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        for _ in range(8):
            assert ch.offer(f)
        ch.finish()
        t.join(30)
        assert not t.is_alive()
        assert len(consumed) == 8
        assert state["max"] <= depth
        # each delivery is the tensor's slab, still on its device
        assert all(isinstance(g["/g"].read_direct(), torch.Tensor)
                   for g in consumed)
    finally:
        shutdown_prefetch_pool()


@pytest.mark.slow
def test_prefetch_depth_is_per_edge_not_global():
    f = _tensor_file()
    spec = RedistSpec(axis=0, nslots=2, slot=0, nranks=1)
    chans = [Channel(f"c{i}", ("p", 0), ("c", i), "o.h5", ["/g"],
                     queue_depth=4, redistribute=spec, prefetch=1)
             for i in range(2)]
    configure_prefetch_pool(4)
    lock = threading.Lock()
    per_edge = {c.name: {"cur": 0, "max": 0} for c in chans}

    def wrap(ch):
        orig = ch._prepare

        def slow(*a, **kw):
            with lock:
                per_edge[ch.name]["cur"] += 1
                per_edge[ch.name]["max"] = max(per_edge[ch.name]["max"],
                                               per_edge[ch.name]["cur"])
            try:
                time.sleep(0.05)
                return orig(*a, **kw)
            finally:
                with lock:
                    per_edge[ch.name]["cur"] -= 1

        ch._prepare = slow

    for c in chans:
        wrap(c)
    try:
        threads = []

        def drain(ch):
            while ch.get(timeout=20) is not None:
                pass

        for c in chans:
            t = threading.Thread(target=drain, args=(c,), daemon=True)
            t.start()
            threads.append(t)

        def produce(ch):
            for _ in range(4):
                ch.offer(f)
            ch.finish()

        producers = [threading.Thread(target=produce, args=(c,), daemon=True)
                     for c in chans]
        for p in producers:
            p.start()
        for th in producers + threads:
            th.join(30)
            assert not th.is_alive()
        for c in chans:
            assert per_edge[c.name]["max"] <= 1
    finally:
        shutdown_prefetch_pool()


# ---------------------------------------------------------------------------
# restricted-world mesh validation
# ---------------------------------------------------------------------------
def test_mesh_overcommit_raises_clear_error():
    comm = TaskComm(task="sim", devices=[object(), object()])
    with pytest.raises(ValueError, match=r"task 'sim'.*mesh shape \(4,\) "
                                         r"needs 4 devices.*holds only 2"):
        comm.mesh(shape=(4,))
    with pytest.raises(ValueError, match="restricted device group"):
        comm.mesh(shape=(2, 2))


def test_mesh_within_budget_still_builds():
    """By design: a grid of ``torch.device``s, not a ``jax.sharding.Mesh``."""
    comm = TaskComm(task="sim", devices=[CPU])
    m = comm.mesh(shape=(1,))
    assert m.shape == (1,)
    assert m.ravel().tolist() == [CPU]


# ---------------------------------------------------------------------------
# WorkflowReport.summary counters
# ---------------------------------------------------------------------------
def test_summary_prints_prefetch_and_plan_cache_counters():
    n, steps = 128, 3
    w, t, j = _mxn_both(n=n, steps=steps)
    assert_same(t, j)
    rep = t.report
    s = rep.summary()
    assert "prefetch: hits=" in s and "blocked_s=" in s
    assert "plan_cache: size=" in s and "hit_rate=" in s
    assert "redist: planned=" in s
    assert rep.transport["prefetch_hits"] + rep.transport["prefetch_misses"] > 0
    assert rep.plan_cache["misses"] >= 1


def test_summary_counters_present_on_error_report():
    w, t, j = _mxn_both(fail=True)
    assert "plan_cache:" in t.report.summary()
    assert "plan_cache:" in j.report.summary()
