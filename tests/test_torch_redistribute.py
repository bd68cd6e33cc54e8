"""The port's pack executors (``execute_pack_torch[_all]``) against the JAX
package's (``execute_pack_jax[_all]``, Pallas in interpret mode) and the
numpy scatter oracle, on the same seeded inputs.  Byte-exact throughout."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import redistribute as jred  # noqa: E402
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
