"""The port's M->N redistribution beside the JAX package's: the twin of
``tests/test_redistribute.py``.  The pack executors
(``execute_pack_torch[_all]``) are held against the JAX package's
(``execute_pack_jax[_all]``, Pallas in interpret mode) and the numpy
scatter oracle on the same seeded inputs, byte-exact throughout; the
planner, the host executors and the plan cache against the reference's;
and every redistributing workflow runs through both packages
(``torch_twins``: equal deliveries, totals, counters and plan-cache rate).
Each reference case has a twin of the same name, after the port's own
executor cases.  By design:

* ``test_reshard_jax_roundtrip`` round-trips through ``reshard_torch``;
* the host executors (``execute``, ``execute_global``,
  ``redistribute_numpy``) take numpy arrays in both packages, so their
  cases feed numpy; everything that reaches a pack executor or a
  workflow carries tensors.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hypcompat import given, settings, st  # noqa: E402
from repro.core import datamodel as jdm  # noqa: E402
from repro.core import redistribute as jred  # noqa: E402
from repro_torch.core import datamodel as tdm  # noqa: E402
from torch_twins import assert_same, owned, run_both  # noqa: E402
from repro_torch.convert import numpy_from_tensor, tensor_from_numpy  # noqa: E402
from repro_torch.core import redistribute as tred  # noqa: E402
from repro_torch.core.datamodel import (reset_transport_stats,  # noqa: E402
                                        transport_stats)

CPU = torch.device("cpu")


def _bits(a):
    if isinstance(a, torch.Tensor):
        return numpy_from_tensor(a)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(port_blocks, jax_blocks, want=None):
    assert len(port_blocks) == len(jax_blocks)
    for i, (p, j) in enumerate(zip(port_blocks, jax_blocks)):
        assert isinstance(p, torch.Tensor) and p.device == CPU
        assert tuple(p.shape) == tuple(j.shape)
        np.testing.assert_array_equal(_bits(p), _bits(j))
        if want is not None:
            np.testing.assert_array_equal(_bits(p), _bits(want[i]))


def _plans(src, dst, shape, dtype):
    return (tred.CompiledPlan(src, dst, shape, dtype),
            jred.CompiledPlan(src, dst, shape, dtype))


# (shape, src axis, dst axis, m_src, m_dst, tile): 2-D rows and cols with
# ragged tails, the 3-D/4-D flattened cases of the reference's N-D sweep,
# and the cross-axis exchanges that coalesce onto one kernel.
CASES = [
    ((64, 8), 0, 0, 4, 2, 8),
    ((40, 16), 0, 0, 3, 3, 8),
    ((37, 8), 0, 0, 2, 5, 4),      # ragged rows
    ((8, 64), 1, 1, 4, 2, 8),
    ((16, 40), 1, 1, 3, 3, 8),
    ((8, 37), 1, 1, 2, 5, 4),      # ragged cols
    ((37, 5, 6), 0, 0, 4, 3, 4),   # 3-D rows, ragged
    ((6, 40, 3), 1, 1, 3, 2, 4),   # 3-D middle axis, scale > 1
    ((4, 6, 23), 2, 2, 4, 5, 4),
    ((3, 4, 5, 23), 3, 3, 4, 5, 4),
    ((23, 3, 4, 5), 0, 0, 5, 2, 8),
    ((3, 17, 4, 5), 1, 1, 2, 3, 4),
    ((32, 12), 0, 1, 4, 3, 4),     # cross-axis 2-D
    ((8, 3, 24), 0, 2, 4, 3, 4),   # cross-axis 3-D
]


@pytest.mark.parametrize("shape, sax, dax, m_src, m_dst, tile", CASES)
def test_execute_pack_torch_all_matches_jax_and_numpy(shape, sax, dax, m_src,
                                                      m_dst, tile):
    rng = np.random.default_rng(abs(hash(shape)) % 2**31)
    g = rng.normal(size=shape).astype(np.float32)
    src = jred.even_blocks(shape, m_src, axis=sax)
    dst = jred.even_blocks(shape, m_dst, axis=dax)
    tplan, jplan = _plans(src, dst, shape, g.dtype)
    assert tplan.pack_mode == jplan.pack_mode is not None
    assert tplan.pack_axis == jplan.pack_axis
    want = jred.redistribute_numpy(g, src, dst)
    got = tred.execute_pack_torch_all(tplan, tensor_from_numpy(g, CPU),
                                      tile_rows=tile)
    ref = jred.execute_pack_jax_all(jplan, jnp.asarray(g), tile_rows=tile)
    _assert_same(got, ref, want)
    one = tred.execute_pack_torch(tplan, m_dst - 1, tensor_from_numpy(g, CPU),
                                  tile_rows=tile)
    np.testing.assert_array_equal(_bits(one), want[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_execute_pack_torch_dtypes_match_jax(dtype):
    g = np.asarray(jnp.arange(37 * 12).reshape(37, 12).astype(dtype))
    for axis in (0, 1):
        src = jred.even_blocks(g.shape, 3, axis=axis)
        dst = jred.even_blocks(g.shape, 4, axis=axis)
        tplan, jplan = _plans(src, dst, g.shape, g.dtype)
        got = tred.execute_pack_torch_all(tplan, tensor_from_numpy(g, CPU),
                                          tile_rows=4)
        ref = jred.execute_pack_jax_all(jplan, jnp.asarray(g), tile_rows=4)
        _assert_same(got, ref)
        assert got[0].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("shape, axis, slot, tile", [
    ((32, 5, 2), 0, 1, 4),
    ((8, 48), 1, 0, 4),
    ((6, 40, 3), 1, 1, 4),
    ((37, 6), 0, 1, 8),       # ragged slab extent
])
def test_slab_local_gathers_match_jax(shape, axis, slot, tile):
    g = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    spec = jred.RedistSpec(axis=axis, nslots=2, slot=slot, nranks=2)
    dst, slots = spec.dst_boxes(shape)
    starts, sshape = slots[slot]
    slab = g[tuple(slice(s, s + n) for s, n in zip(starts, sshape))]
    box = (tuple(starts), tuple(sshape))
    tplan, jplan = _plans([box], dst, shape, g.dtype)
    ranks = list(spec.my_ranks())
    got = tred.execute_pack_torch_all(tplan, tensor_from_numpy(slab, CPU),
                                      tile_rows=tile, slab_box=box, ranks=ranks)
    ref = jred.execute_pack_jax_all(jplan, jnp.asarray(slab), tile_rows=tile,
                                    slab_box=box, ranks=ranks)
    want = jred.redistribute_numpy(g, [((0,) * len(shape), shape)], dst)
    _assert_same(got, ref, [want[r] for r in ranks])


def test_strided_slab_view_is_copied_once_and_counted():
    """A slab view along axis 1 is a strided tensor: the executor makes it
    contiguous explicitly and records the copy."""
    g = np.arange(8 * 48, dtype=np.float32).reshape(8, 48)
    full = tensor_from_numpy(g, CPU)
    box = ((0, 24), (8, 24))
    slab = full[:, 24:48]
    assert not slab.is_contiguous()
    spec = jred.RedistSpec(axis=1, nslots=2, slot=1, nranks=2)
    dst, _ = spec.dst_boxes(g.shape)
    plan = tred.CompiledPlan([box], dst, g.shape, g.dtype)
    reset_transport_stats()
    got = tred.execute_pack_torch_all(plan, slab, tile_rows=4, slab_box=box,
                                      ranks=[2, 3])
    s = transport_stats().snapshot()
    assert s["copies"] == 1 and s["bytes_copied"] == slab.nbytes
    want = jred.redistribute_numpy(g, [((0, 0), g.shape)], dst)
    for r, b in zip([2, 3], got):
        np.testing.assert_array_equal(_bits(b), want[r])


def test_empty_tile_lists_give_zero_blocks_like_jax():
    g = np.arange(3 * 8, dtype=np.float32).reshape(3, 8)
    src = jred.even_blocks(g.shape, 1)
    dst = jred.even_blocks(g.shape, 5)     # ranks 3 and 4 own no rows
    tplan, jplan = _plans(src, dst, g.shape, g.dtype)
    assert tplan.pack_tiles(4, 8)[0].size == 0
    got = tred.execute_pack_torch_all(tplan, tensor_from_numpy(g, CPU))
    ref = jred.execute_pack_jax_all(jplan, jnp.asarray(g))
    _assert_same(got, ref)
    assert tuple(got[4].shape) == (0, 8)


def test_slab_covering_only_run_head_raises_in_both():
    shape = (100, 8)
    dst = [((40, 0), (30, 8))]
    box = ((40, 0), (10, 8))
    tplan, jplan = _plans([((0, 0), shape)], dst, shape, np.float32)
    with pytest.raises(ValueError, match="does not cover this rank"):
        tred.execute_pack_torch(tplan, 0, torch.zeros((10, 8)), tile_rows=8,
                                slab_box=box)
    with pytest.raises(ValueError, match="does not cover this rank"):
        jred.execute_pack_jax(jplan, 0, jnp.zeros((10, 8), jnp.float32),
                              tile_rows=8, slab_box=box)


def test_unlowerable_plan_rejected_like_jax():
    quads = [((0, 0), (8, 8)), ((0, 8), (8, 8)),
             ((8, 0), (8, 8)), ((8, 8), (8, 8))]
    tplan, jplan = _plans([((0, 0), (16, 16))], quads, (16, 16), np.float32)
    assert tplan.pack_mode is None and jplan.pack_mode is None
    with pytest.raises(ValueError, match="not pack-kernel lowerable"):
        tred.execute_pack_torch(tplan, 0, torch.zeros((16, 16)))


def test_port_plan_cache_counts_like_jax_and_stays_separate():
    tred.reset_plan_cache()
    jred.reset_plan_cache()
    shape = (16, 2)
    src = jred.even_blocks(shape, 4)
    dst = jred.even_blocks(shape, 2)
    seq = [(shape, np.float64), (shape, np.float64), (shape, np.float32),
           ((18, 2), np.float64), (shape, np.float64)]
    for sh, dt in seq:
        tred.plan_cache().get(jred.even_blocks(sh, 4), jred.even_blocks(sh, 2),
                              sh, dt)
    assert jred.plan_cache().snapshot()["misses"] == 0  # untouched
    for sh, dt in seq:
        jred.plan_cache().get(jred.even_blocks(sh, 4), jred.even_blocks(sh, 2),
                              sh, dt)
    assert tred.plan_cache().snapshot() == jred.plan_cache().snapshot()
    # a torch dtype and the numpy dtype of the same name share one plan
    p = tred.plan_cache().get(src, dst, shape, np.float32)
    assert tred.plan_cache().get(src, dst, shape, torch.float32) is p
    assert tred.plan_cache().get(src, dst, shape, torch.bfloat16) is not p


def test_reshard_torch_moves_to_device():
    t = torch.arange(4.0)
    assert tred.reshard_torch(t, CPU) is t


# ===========================================================================
# The rest of ``tests/test_redistribute.py``, case by case: the planner,
# the host executors, the plan cache, the pack executors and the
# redistributing channels, each beside the reference on the same inputs.
# ===========================================================================
def _ragged_blocks(n, nranks, rng, axis=0, shape=None):
    """Random ragged 1-D decomposition along ``axis`` (the reference test
    module's helper, copied: a port test imports no reference test)."""
    shape = (n,) if shape is None else tuple(shape)
    cuts = sorted(rng.choice(n + 1, size=nranks - 1, replace=True).tolist())
    bounds = [0] + cuts + [n]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        starts = tuple(lo if a == axis else 0 for a in range(len(shape)))
        bshape = tuple(hi - lo if a == axis else s for a, s in enumerate(shape))
        out.append((starts, bshape))
    return out


def _cover(plan_fn, shape, src, dst):
    hit = np.zeros(shape, dtype=int)
    for t in plan_fn(src, dst):
        hit[tuple(slice(s, s + k) for s, k in zip(t.global_starts, t.shape))] += 1
    return hit


def _tuples(transfers):
    return [(t.src_rank, t.dst_rank, tuple(t.global_starts), tuple(t.shape))
            for t in transfers]


def test_even_blocks_cover():
    blocks = tred.even_blocks((10, 4), 3)
    assert [b[1][0] for b in blocks] == [4, 3, 3]
    assert blocks[0][0] == (0, 0) and blocks[1][0] == (4, 0)
    assert blocks == jred.even_blocks((10, 4), 3)


def test_intersect():
    a = ((0, 0), (4, 4))
    b = ((2, 2), (4, 4))
    assert tred.intersect(a, b) == ((2, 2), (2, 2)) == jred.intersect(a, b)
    assert tred.intersect(((0, 0), (2, 2)), ((2, 2), (2, 2))) is None


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 64), cols=st.integers(1, 8), m_src=st.integers(1, 7),
       m_dst=st.integers(1, 7))
def test_plan_covers_every_dst_cell_once(n, cols, m_src, m_dst):
    src = tred.even_blocks((n, cols), m_src)
    dst = tred.even_blocks((n, cols), m_dst)
    assert (_cover(tred.plan_redistribution, (n, cols), src, dst) == 1).all()
    assert _tuples(tred.plan_redistribution(src, dst)) == \
        _tuples(jred.plan_redistribution(src, dst))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 48), cols=st.integers(1, 6), m_src=st.integers(1, 6),
       m_dst=st.integers(1, 6), seed=st.integers(0, 2**31 - 1))
def test_redistribute_preserves_bytes(n, cols, m_src, m_dst, seed):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 1000, size=(n, cols)).astype(np.int64)
    src = tred.even_blocks(arr.shape, m_src)
    dst = tred.even_blocks(arr.shape, m_dst)
    outs = tred.redistribute_numpy(arr, src, dst)
    for (starts, shape), out, ref in zip(dst, outs,
                                         jred.redistribute_numpy(arr, src, dst)):
        slc = tuple(slice(s, s + k) for s, k in zip(starts, shape))
        np.testing.assert_array_equal(out, arr[slc])
        np.testing.assert_array_equal(out, ref)


def _ownership(dm, shape, m):
    own = dm.BlockOwnership()
    for r, (starts, sh) in enumerate(jred.even_blocks(shape, m)):
        own.add(r, starts, sh)
    return own


def test_gather_to_writers_single():
    g = tred.gather_to_writers(_ownership(tdm, (32, 3), 8), 1)
    assert g.nranks() == 1
    assert g.blocks[0] == ((0, 0), (32, 3))
    assert g.blocks == jred.gather_to_writers(_ownership(jdm, (32, 3), 8), 1).blocks


def test_gather_to_writers_subset():
    g = tred.gather_to_writers(_ownership(tdm, (30,), 6), 2)
    assert g.nranks() == 2
    assert sum(sh[0] for _, sh in g.blocks.values()) == 30
    assert g.blocks == jred.gather_to_writers(_ownership(jdm, (30,), 6), 2).blocks


def test_reshard_jax_roundtrip():
    """By design: the port's twin of ``reshard_jax`` is ``reshard_torch``,
    which moves a tensor onto a device (a no-op where it already lies)."""
    x = np.arange(12.0).reshape(3, 4)
    t = tensor_from_numpy(x, CPU)
    out = tred.reshard_torch(t, CPU)
    assert out is t
    np.testing.assert_array_equal(_bits(out), x)
    np.testing.assert_array_equal(_bits(tred.reshard_torch(t, "cpu")), x)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 48), cols=st.integers(2, 12), m_src=st.integers(1, 5),
       m_dst=st.integers(1, 5))
def test_plan_covers_cross_axis(n, cols, m_src, m_dst):
    src = tred.even_blocks((n, cols), m_src, axis=0)
    dst = tred.even_blocks((n, cols), m_dst, axis=1)
    assert (_cover(tred.plan_redistribution, (n, cols), src, dst) == 1).all()


def test_plan_covers_cross_axis_seeded():
    rng = np.random.default_rng(7)
    for n, cols, m_src, m_dst, src_axis, dst_axis in [
        (17, 5, 3, 2, 0, 1), (32, 8, 4, 4, 1, 0), (9, 9, 2, 5, 1, 1)
    ]:
        src = _ragged_blocks([n, cols][src_axis], m_src, rng, axis=src_axis,
                             shape=(n, cols))
        dst = tred.even_blocks((n, cols), m_dst, axis=dst_axis)
        assert (_cover(tred.plan_redistribution, (n, cols), src, dst) == 1).all()
        assert _tuples(tred.plan_redistribution(src, dst)) == \
            _tuples(jred.plan_redistribution(src, dst))


def test_ragged_ownership_executors_byte_exact():
    rng = np.random.default_rng(42)
    for trial in range(25):
        n = int(rng.integers(1, 64))
        cols = int(rng.integers(1, 7))
        src = _ragged_blocks(n, int(rng.integers(1, 6)), rng, shape=(n, cols))
        dst = _ragged_blocks(n, int(rng.integers(1, 6)), rng, shape=(n, cols))
        g = rng.integers(0, 1000, size=(n, cols)).astype(np.int64)
        want = jred.redistribute_numpy(g, src, dst)
        plan = tred.CompiledPlan(src, dst, g.shape, g.dtype)
        got_global = plan.execute_global(g)
        src_blocks = [g[s[0]:s[0] + sh[0]] for (s, sh) in src]
        got_scatter = plan.execute(src_blocks)
        for w, a, b in zip(want, got_global, got_scatter):
            np.testing.assert_array_equal(w, a)
            np.testing.assert_array_equal(w, b)


def test_scatter_executor_writes_into_preallocated_blocks():
    g = np.arange(40.0).reshape(10, 4)
    src = tred.even_blocks(g.shape, 5)
    dst = tred.even_blocks(g.shape, 2)
    plan = tred.CompiledPlan(src, dst, g.shape, g.dtype)
    out = [np.full(sh, -1.0) for (_, sh) in dst]
    res = plan.execute_global(g, out=out)
    assert res[0] is out[0] and res[1] is out[1]
    np.testing.assert_array_equal(out[0], g[:5])
    np.testing.assert_array_equal(out[1], g[5:])


def test_coalescing_merges_contiguous_runs():
    T = tred.Transfer
    src = tred.even_blocks((8, 4), 4)
    dst = tred.even_blocks((8, 4), 2)
    plan = tred.CompiledPlan(src, dst, (8, 4), np.float32)
    assert [len(s) for s in plan.per_dst] == [2, 2]
    assert [len(s) for s in plan.per_dst_runs] == [1, 1]
    assert plan.per_dst_runs[0][0] == T(-1, 0, (0, 0), (4, 4))
    assert plan.per_dst_runs[1][0] == T(-1, 1, (4, 0), (4, 4))
    jplan = jred.CompiledPlan(src, dst, (8, 4), np.float32)
    assert [_tuples(r) for r in plan.per_dst_runs] == \
        [_tuples(r) for r in jplan.per_dst_runs]
    parts = [T(0, 0, (0, 0), (2, 4)), T(0, 0, (2, 0), (3, 4))]
    assert tred.coalesce_transfers(parts) == [T(0, 0, (0, 0), (5, 4))]
    apart = [T(0, 0, (0, 0), (2, 4)), T(0, 1, (2, 0), (3, 4))]
    assert len(tred.coalesce_transfers(apart, ignore_src=True)) == 2


def test_aligned_detector():
    src = tred.even_blocks((12, 3), 3)
    assert tred.CompiledPlan(src, src, (12, 3), np.int32).aligned
    assert tred.CompiledPlan(src, src, (12, 3), np.int32).identity
    off = tred.even_blocks((12, 3), 4)
    p = tred.CompiledPlan(src, off, (12, 3), np.int32)
    assert not p.aligned and not p.identity
    assert tred.CompiledPlan([((0, 0), (12, 3))], [((0, 0), (12, 3))],
                             (12, 3), np.int32).aligned


def test_plan_cache_hit_and_invalidation():
    c = tred.PlanCache(maxsize=8)
    src = tred.even_blocks((16, 2), 4)
    dst = tred.even_blocks((16, 2), 2)
    p1 = c.get(src, dst, (16, 2), np.float64)
    p2 = c.get(src, dst, (16, 2), np.float64)
    assert p1 is p2
    assert c.snapshot()["hits"] == 1 and c.snapshot()["misses"] == 1
    assert c.get(src, dst, (16, 2), np.float32) is not p1
    assert c.get(src, dst[::-1], (16, 2), np.float64) is not p1
    assert c.snapshot()["misses"] == 3
    # a tensor's dtype keys the same plan as numpy's dtype of that name
    assert c.get(src, dst, (16, 2), torch.float64) is p1


def test_plan_cache_lru_eviction():
    c = tred.PlanCache(maxsize=2)
    shapes = [(8, 1), (9, 1), (10, 1)]
    plans = [c.get(tred.even_blocks(s, 2), tred.even_blocks(s, 2), s, np.int8)
             for s in shapes]
    assert c.snapshot()["evictions"] == 1 and len(c) == 2
    again = c.get(tred.even_blocks((8, 1), 2), tred.even_blocks((8, 1), 2),
                  (8, 1), np.int8)
    assert again is not plans[0]
    assert c.get(tred.even_blocks((10, 1), 2), tred.even_blocks((10, 1), 2),
                 (10, 1), np.int8) is plans[2]


def test_redistribute_cached_matches_uncached():
    tred.reset_plan_cache()
    g = np.arange(60).reshape(12, 5)
    src = tred.even_blocks(g.shape, 3)
    dst = tred.even_blocks(g.shape, 4)
    for _ in range(3):
        outs = tred.redistribute_cached(g, src, dst)
        for w, a in zip(jred.redistribute_numpy(g, src, dst), outs):
            np.testing.assert_array_equal(w, a)
    snap = tred.plan_cache().snapshot()
    assert snap["hits"] == 2 and snap["misses"] == 1


def test_pack_executor_matches_numpy_scatter():
    rng = np.random.default_rng(3)
    for rows, cols, m_src, m_dst, tile_rows in [
        (64, 8, 4, 2, 8), (40, 16, 3, 3, 8), (37, 8, 2, 5, 4)
    ]:
        g = rng.normal(size=(rows, cols)).astype(np.float32)
        src = jred.even_blocks(g.shape, m_src)
        dst = jred.even_blocks(g.shape, m_dst)
        tplan, jplan = _plans(src, dst, g.shape, g.dtype)
        want = tplan.execute_global(g)
        gt, gj = tensor_from_numpy(g, CPU), jnp.asarray(g)
        for r in range(m_dst):
            got = tred.execute_pack_torch(tplan, r, gt, tile_rows=tile_rows)
            ref = jred.execute_pack_jax(jplan, r, gj, tile_rows=tile_rows)
            _assert_same([got], [ref], [want[r]])


def test_pack_tiles_cached_on_plan():
    plan = tred.CompiledPlan(tred.even_blocks((32, 8), 2),
                             tred.even_blocks((32, 8), 4), (32, 8), np.float32)
    t1, s1 = plan.pack_tiles(1, 8)
    t2, s2 = plan.pack_tiles(1, 8)
    assert t1 is t2 and s1 is s2
    jt, js = jred.CompiledPlan(jred.even_blocks((32, 8), 2),
                               jred.even_blocks((32, 8), 4), (32, 8),
                               np.float32).pack_tiles(1, 8)
    np.testing.assert_array_equal(t1, jt)
    assert s1 == js


# ---------------------------------------------------------------------------
# channel integration: slab shipping, aligned views, spill roundtrip
# ---------------------------------------------------------------------------
def _mxn_yaml(n_prod, n_cons, cons_ranks, extra=""):
    return f"""
tasks:
  - func: producer
    taskCount: {n_prod}
    outports:
      - filename: o.h5
        dsets: [{{name: /g, memory: 1}}]
  - func: consumer
    taskCount: {n_cons}
    nprocs: {cons_ranks}
    inports:
      - filename: o.h5
        redistribute: 1
        {extra}
        dsets: [{{name: /g, memory: 1}}]
"""


def _mxn(s, yaml, n, steps, m_own, extra=None, sleep=0.0, run_kw=None,
         dtype=np.float64, shape=None):
    """Producers write ``arange(n) + t`` (or ``shape``) owned by ``m_own``
    ranks; consumers record each slab with its box and ownership."""
    shape = (n,) if shape is None else shape
    own = owned(s.dm, s.red, shape, m_own) if m_own else None
    meta = {}

    def producer(comm):
        for t in range(steps):
            with s.h5.File("o.h5", "w") as f:
                f.attrs["producer"] = comm.instance
                f.attrs["step"] = t
                data = s.data(np.arange(int(np.prod(shape)), dtype=dtype)
                              .reshape(shape) + t)
                f.create_dataset("/g", data=data, ownership=own)

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            time.sleep(sleep)
            d = f["/g"]
            key = ("consumer", comm.instance, int(f.attrs["producer"]),
                   int(f.attrs["step"]))
            s.record(key, d)
            with s.lock:
                meta[key] = (tuple(d.attrs.get("redist_box_starts", ())),
                             tuple(d.shape),
                             dict(d.ownership.blocks) if d.ownership else None)

    w = s.wilkins(yaml, {"producer": producer, "consumer": consumer},
                  **(extra or {}))
    return w.run(timeout=60, **(run_kw or {})), meta


def _mxn_both(*args, **kw):
    t, j = run_both(_mxn, *args, **kw)
    (rep, meta), (jrep, jmeta) = t.result, j.result
    t.result, j.result = rep, jrep
    assert meta == jmeta
    assert_same(t, j)
    return t, j, meta


def test_mxn_channel_ships_only_owned_slabs():
    n, steps = 512, 3
    t, j, meta = _mxn_both(_mxn_yaml(4, 2, 2), n, steps, 4)
    rep = t.report
    assert rep.total_served == 4 * steps
    assert rep.total_bytes_moved == 4 * steps * (n // 2) * 8
    s = t.stats
    assert s["redist_baseline_bytes"] == 2 * s["redist_shipped_bytes"]
    assert t.plans["size"] == 1                 # one plan for the edge
    for key, (starts, shape, _) in meta.items():
        assert shape == (n // 2,)
        dt, _, raw = t.side.got[key]
        np.testing.assert_array_equal(
            np.frombuffer(raw, dt), np.arange(starts[0], starts[0] + n // 2) + key[3])


def test_mxn_consumer_gets_per_rank_ownership():
    t, j, meta = _mxn_both(_mxn_yaml(1, 1, 2), 64, 1, 4)
    assert [m[2] for m in meta.values()] == [{0: ((0,), (32,)), 1: ((32,), (32,))}]


def test_aligned_decomposition_ships_views_zero_copy():
    n = 256
    t, j, meta = _mxn_both(_mxn_yaml(1, 1, 2), n, 1, 2)
    assert [m[1] for m in meta.values()] == [(n,)]   # a view, not a slab
    s = t.stats
    assert s["redist_aligned"] == 1 and s["redist_slabs"] == 0
    assert s["redist_shipped_bytes"] == s["redist_baseline_bytes"] == n * 8
    assert s["bytes_copied"] == n * 8     # only the create_dataset snapshot


FILE_YAML = """
tasks:
  - func: producer
    taskCount: 2
    outports:
      - filename: o.h5
        dsets: [{name: /g, file: 1, memory: 0}]
  - func: consumer
    taskCount: 2
    nprocs: 1
    inports:
      - filename: o.h5
        redistribute: 1
        dsets: [{name: /g, file: 1, memory: 0}]
"""


def test_redistribute_through_file_transport(tmp_path):
    t, j, meta = _mxn_both(FILE_YAML, 128, 1, 2,
                           extra={"spill_dir": str(tmp_path)})
    assert sorted(m[0][0] for m in meta.values()) == [0, 64]
    for key, ((s0,), _, blocks) in meta.items():
        dt, _, raw = t.side.got[key]
        np.testing.assert_array_equal(np.frombuffer(raw, dt), np.arange(s0, s0 + 64))
        assert blocks == {0: ((s0,), (64,))}


def _slab_channel(ch_mod, red, **kw):
    return ch_mod.Channel("c", ("p", 0), ("c", 0), "o.h5", ["/g"],
                          redistribute=red.RedistSpec(axis=0, nslots=2, slot=1,
                                                      nranks=1), **kw)


def test_redist_slab_is_cow_protected():
    from repro_torch.core import channel as tch
    f = tdm.File("o.h5")
    src = f.create_dataset("/g", data=tensor_from_numpy(np.arange(16.0), CPU))
    out = _slab_channel(tch, tred).filter_file(f)
    slab = out["/g"]
    assert slab.shape == (8,)
    assert np.shares_memory(slab.read_direct(), src.read_direct())
    slab[0] = -1.0
    assert slab[0] == -1.0 and src[8] == 8.0
    assert not np.shares_memory(slab.read_direct(), src.read_direct())
    # an adopted tensor ships as a slab view of itself, written through CoW
    t = tensor_from_numpy(np.arange(16.0), CPU)
    f2 = tdm.File("o.h5")
    f2.create_dataset("/g", data=t, copy=False)
    slab2 = _slab_channel(tch, tred).filter_file(f2)["/g"]
    assert slab2.read_direct().data_ptr() == t[8:].data_ptr()
    slab2[0] = -1.0
    assert float(t[8]) == 8.0


def test_legacy_mode_honors_redistribute_contract():
    from repro.core import channel as jch
    from repro_torch.core import channel as tch
    copied = {}
    for name, ch_mod, dm, red, data in (
            ("port", tch, tdm, tred, tensor_from_numpy(np.arange(16.0), CPU)),
            ("jax", jch, jdm, jred, np.arange(16.0))):
        f = dm.File("o.h5")
        src = f.create_dataset("/g", data=data)
        ch = _slab_channel(ch_mod, red, zero_copy=False)
        dm.reset_transport_stats()
        slab = ch.filter_file(f)["/g"]
        assert slab.shape == (8,)
        assert tuple(slab.attrs["redist_box_starts"]) == (8,)
        assert slab.ownership.blocks == {0: ((8,), (8,))}
        assert not np.shares_memory(slab.read_direct(), src.read_direct())
        np.testing.assert_array_equal(slab[:], np.arange(8.0, 16.0))
        copied[name] = dm.transport_stats().snapshot()["bytes_copied"]
    assert copied["port"] == copied["jax"] == 8 * 8


def test_pack_all_pads_once_and_matches_per_rank():
    g = np.arange(37 * 8, dtype=np.float32).reshape(37, 8)
    tplan, jplan = _plans(jred.even_blocks(g.shape, 3),
                          jred.even_blocks(g.shape, 4), g.shape, g.dtype)
    want = tplan.execute_global(g)
    got = tred.execute_pack_torch_all(tplan, tensor_from_numpy(g, CPU),
                                      tile_rows=8)
    ref = jred.execute_pack_jax_all(jplan, jnp.asarray(g), tile_rows=8)
    assert len(got) == 4
    _assert_same(got, ref, want)


AXIS_YAML = """
tasks:
  - func: producer
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    nprocs: 4
    nwriters: 2
    inports:
      - filename: o.h5
        redistribute: {axis: 1}
        dsets: [{name: /g, memory: 1}]
"""


def test_redist_axis_and_subset_writers():
    t, j, meta = _mxn_both(AXIS_YAML, 0, 1, 0, shape=(4, 32))
    assert [m[2] for m in meta.values()] == \
        [{0: ((0, 0), (4, 16)), 1: ((0, 16), (4, 16))}]


# ---------------------------------------------------------------------------
# column-tile pack lowering
# ---------------------------------------------------------------------------
def test_pack_mode_detection():
    def both(src, dst, shape):
        tp, jp = _plans(src, dst, shape, np.float32)
        assert tp.pack_mode == jp.pack_mode
        return tp.pack_mode

    eb = tred.even_blocks
    assert both(eb((32, 8), 4), eb((32, 8), 2), (32, 8)) == "rows"
    assert both(eb((32, 8), 4, axis=1), eb((32, 8), 2, axis=1), (32, 8)) == "cols"
    assert both(eb((32, 8), 4, axis=0), eb((32, 8), 2, axis=1), (32, 8)) == "cols"
    quads = [((0, 0), (8, 8)), ((0, 8), (8, 8)),
             ((8, 0), (8, 8)), ((8, 8), (8, 8))]
    assert both([((0, 0), (16, 16))], quads, (16, 16)) is None
    assert both(eb((32,), 4), eb((32,), 2), (32,)) is None


def test_pack_executor_cols_matches_numpy_scatter():
    rng = np.random.default_rng(11)
    for rows, cols, m_src, m_dst, tile in [
        (8, 64, 4, 2, 8), (16, 40, 3, 3, 8), (8, 37, 2, 5, 4)
    ]:
        g = rng.normal(size=(rows, cols)).astype(np.float32)
        src = jred.even_blocks(g.shape, m_src, axis=1)
        dst = jred.even_blocks(g.shape, m_dst, axis=1)
        tplan, jplan = _plans(src, dst, g.shape, g.dtype)
        assert tplan.pack_mode == "cols"
        want = tplan.execute_global(g)
        gt = tensor_from_numpy(g, CPU)
        for r in range(m_dst):
            _assert_same([tred.execute_pack_torch(tplan, r, gt, tile_rows=tile)],
                         [jred.execute_pack_jax(jplan, r, jnp.asarray(g),
                                                tile_rows=tile)], [want[r]])
        _assert_same(tred.execute_pack_torch_all(tplan, gt, tile_rows=tile),
                     jred.execute_pack_jax_all(jplan, jnp.asarray(g),
                                               tile_rows=tile), want)


def test_pack_executor_rejects_unlowerable_plans():
    quads = [((0, 0), (8, 8)), ((0, 8), (8, 8)),
             ((8, 0), (8, 8)), ((8, 8), (8, 8))]
    tplan, jplan = _plans([((0, 0), (16, 16))], quads, (16, 16), np.float32)
    with pytest.raises(ValueError, match="not pack-kernel lowerable"):
        tred.execute_pack_torch(tplan, 0, torch.zeros((16, 16)))
    with pytest.raises(ValueError, match="not pack-kernel lowerable"):
        jred.execute_pack_jax(jplan, 0, jnp.zeros((16, 16), jnp.float32))


def test_pack_executor_cross_axis_exchange():
    g = np.arange(32 * 12, dtype=np.float32).reshape(32, 12)
    tplan, jplan = _plans(jred.even_blocks(g.shape, 4, axis=0),
                          jred.even_blocks(g.shape, 3, axis=1), g.shape, g.dtype)
    want = tplan.execute_global(g)
    _assert_same(tred.execute_pack_torch_all(tplan, tensor_from_numpy(g, CPU),
                                             tile_rows=4),
                 jred.execute_pack_jax_all(jplan, jnp.asarray(g), tile_rows=4),
                 want)


def test_execute_ranks_restriction_matches_full():
    g = np.arange(80.0).reshape(16, 5)
    src = tred.even_blocks(g.shape, 4)
    dst = tred.even_blocks(g.shape, 3)
    plan = tred.CompiledPlan(src, dst, g.shape, g.dtype)
    full = plan.execute_global(g)
    sub = plan.execute_global(g, ranks=[2, 0])
    np.testing.assert_array_equal(sub[0], full[2])
    np.testing.assert_array_equal(sub[1], full[0])
    src_blocks = [g[s[0]:s[0] + sh[0]] for (s, sh) in src]
    np.testing.assert_array_equal(plan.execute(src_blocks, ranks=[1])[0], full[1])
    gt = tensor_from_numpy(g.astype(np.float32), CPU)
    tplan = tred.CompiledPlan(src, dst, g.shape, np.float32)
    sub_t = tred.execute_pack_torch_all(tplan, gt, ranks=[2, 0])
    np.testing.assert_array_equal(_bits(sub_t[0]), full[2].astype(np.float32))


# ---------------------------------------------------------------------------
# async slab prefetch
# ---------------------------------------------------------------------------
def test_prefetch_default_and_yaml_knob():
    from repro_torch.core import Wilkins
    from repro_torch.core.channel import Channel

    noop = {"producer": lambda: None, "consumer": lambda: None}
    w = Wilkins(_mxn_yaml(2, 2, 1), noop, devices=[CPU])
    assert all(c.prefetch for c in w.channels)
    w2 = Wilkins(_mxn_yaml(2, 2, 1, extra="prefetch: 0"), noop, devices=[CPU])
    assert not any(c.prefetch for c in w2.channels)
    assert not Channel("p", ("p", 0), ("c", 0), "o.h5", ["/g"]).prefetch


@pytest.mark.slow
def test_prefetch_channel_serves_futures_byte_exact():
    n, steps = 256, 4
    t, j, meta = _mxn_both(_mxn_yaml(4, 2, 2), n, steps, 4, sleep=0.01)
    s = t.stats
    assert t.report.total_served == 4 * steps
    assert s["prefetch_hits"] + s["prefetch_misses"] == 4 * steps
    assert s["prefetch_prepared_s"] > 0.0
    assert t.report.total_bytes_moved == 4 * steps * (n // 2) * 8
    assert all(m[1] == (n // 2,) for m in meta.values())


def test_prefetch_disabled_records_nothing():
    t, j, meta = _mxn_both(_mxn_yaml(2, 2, 1, extra="prefetch: 0"), 64, 1, 2)
    s = t.stats
    assert s["prefetch_hits"] == s["prefetch_misses"] == 0
    assert s["prefetch_prepared_s"] == 0.0
    assert t.report.total_bytes_moved > 0


@pytest.mark.slow
def test_prefetch_through_file_transport(tmp_path):
    t, j, meta = _mxn_both(FILE_YAML, 128, 1, 2,
                           extra={"spill_dir": str(tmp_path)})
    assert len(t.side.got) == 2
    assert sorted(float(np.frombuffer(raw, dt)[0])
                  for dt, _, raw in t.side.got.values()) == [0.0, 64.0]
    assert t.stats["prefetch_hits"] + t.stats["prefetch_misses"] == 2


def _failing_prep_channel(slot, exc):
    from repro_torch.core.channel import Channel
    f = tdm.File("o.h5")
    f.create_dataset("/g", data=tensor_from_numpy(np.arange(8.0), CPU))
    ch = Channel("c", ("p", 0), ("c", 0), "o.h5", ["/g"],
                 redistribute=tred.RedistSpec(axis=0, nslots=2, slot=slot,
                                              nranks=1))
    ch.filter_file = lambda _f: (_ for _ in ()).throw(exc)
    return ch, f


def test_prefetch_prepare_error_reaches_consumer():
    ch, f = _failing_prep_channel(1, RuntimeError("prep boom"))
    assert ch.offer(f)
    with pytest.raises(RuntimeError, match="prep boom"):
        ch.get(timeout=5)


def test_prefetch_prepare_error_unblocks_producer():
    ch, f = _failing_prep_channel(0, OSError("disk full"))
    assert ch.offer(f)
    with pytest.raises(OSError, match="disk full"):
        ch.get(timeout=5)
    assert ch.offer(f) is False
    assert ch.get(timeout=5) is None
