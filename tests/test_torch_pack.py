"""The port's pack kernels (K1 ``pack_blocks``, K2 ``pack_cols``) against
the JAX package's Pallas kernels, run as its own tests run them on the CPU
(interpret mode through ``repro.kernels.ops``).  Every comparison is
byte-exact: both sides copy bytes, so any difference is a fault."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hypcompat import given, settings, st  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import numpy_from_tensor, tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops, pack, ref  # noqa: E402

CPU = torch.device("cpu")


def _bits(a):
    """Host bytes of an array or tensor, bf16 as its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        return numpy_from_tensor(a)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _both(fn_t, fn_j, src_np, offs_np, tile):
    got = fn_t(tensor_from_numpy(src_np, CPU), offs_np, tile)
    want = fn_j(jnp.asarray(src_np), jnp.asarray(offs_np), tile)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    return got


@settings(max_examples=20, deadline=None)
@given(
    t=st.integers(1, 12),
    rows=st.integers(1, 8),
    cols=st.sampled_from([8, 16, 128]),
    seed=st.integers(0, 2**31 - 1),
)
def test_pack_blocks_matches_jax_property(t, rows, cols, seed):
    rng = np.random.default_rng(seed)
    n_tiles_src = 16
    src = rng.normal(size=(n_tiles_src * rows, cols)).astype(np.float32)
    offs = rng.integers(0, n_tiles_src, size=t).astype(np.int32)
    _both(ops.pack_blocks, jops.pack_blocks, src, offs, rows)


@settings(max_examples=20, deadline=None)
@given(
    t=st.integers(1, 12),
    rows=st.sampled_from([8, 16]),
    cols=st.integers(1, 8),
    seed=st.integers(0, 2**31 - 1),
)
def test_pack_cols_matches_jax_property(t, rows, cols, seed):
    rng = np.random.default_rng(seed)
    n_tiles_src = 16
    src = rng.normal(size=(rows, n_tiles_src * cols)).astype(np.float32)
    offs = rng.integers(0, n_tiles_src, size=t).astype(np.int32)
    _both(ops.pack_cols, jops.pack_cols, src, offs, cols)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_pack_blocks_dtypes(dtype):
    src = np.asarray(jnp.arange(64 * 8).reshape(64, 8).astype(dtype))
    offs = np.asarray([7, 0, 3], np.int32)
    _both(ops.pack_blocks, jops.pack_blocks, src, offs, 8)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_pack_cols_dtypes(dtype):
    src = np.asarray(jnp.arange(8 * 64).reshape(8, 64).astype(dtype))
    offs = np.asarray([7, 0, 3], np.int32)
    _both(ops.pack_cols, jops.pack_cols, src, offs, 8)


@pytest.mark.parametrize("rows, cols, tile, dim", [
    (37, 5, 8, 0),     # ragged tail row tile
    (5, 37, 12, 1),    # ragged tail column tile, tile not a power of two
    (3, 50, 7, 1),
])
def test_pack_ragged_tail_reads_zeros_like_jax(rows, cols, tile, dim):
    rng = np.random.default_rng(rows * 100 + cols)
    src = rng.normal(size=(rows, cols)).astype(np.float32)  # jax runs without x64
    n = -(-(rows if dim == 0 else cols) // tile)
    offs = np.asarray([n - 1, 0, n - 1], np.int32)
    fn_t, fn_j = ((ops.pack_blocks, jops.pack_blocks) if dim == 0
                  else (ops.pack_cols, jops.pack_cols))
    got = _both(fn_t, fn_j, src, offs, tile)
    assert got.shape[dim] == len(offs) * tile


def test_wrapper_rejects_out_of_range_offsets():
    src = torch.zeros((20, 4))
    with pytest.raises(ValueError, match="tile offsets must lie in"):
        ops.pack_blocks(src, np.asarray([3], np.int32), tile_rows=8)  # 3 tiles
    with pytest.raises(ValueError, match="tile offsets must lie in"):
        ops.pack_blocks(src, np.asarray([-1], np.int32), tile_rows=8)
    with pytest.raises(ValueError, match="tile offsets must lie in"):
        ops.pack_cols(torch.zeros((4, 20)), np.asarray([0, 5], np.int32),
                      tile_cols=4)


def test_wrapper_rejects_non_contiguous_and_non_2d():
    base = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="C-contiguous"):
        ops.pack_blocks(base[:, ::2], np.asarray([0], np.int32), tile_rows=8)
    with pytest.raises(ValueError, match="C-contiguous"):
        ops.pack_cols(base.t(), np.asarray([0], np.int32), tile_cols=8)
    with pytest.raises(ValueError, match="2-D"):
        ops.pack_blocks(torch.zeros(16), np.asarray([0], np.int32))


def test_wrapper_takes_host_offsets_only():
    """Offsets come from the plan as host int32; a tensor of offsets would
    cost a device->host->device round trip, so the wrappers refuse it."""
    src = torch.zeros((16, 4))
    with pytest.raises(TypeError, match="host integer array"):
        ops.pack_blocks(src, torch.tensor([0], dtype=torch.int32), tile_rows=8)
    with pytest.raises(ValueError, match="1-D integer array"):
        ops.pack_cols(src, np.asarray([0.0]), tile_cols=2)


def test_build_is_keyed_on_source_and_flags(monkeypatch):
    """A change of the nvcc flags (or of the source) names another library,
    so a stale build is never reused."""
    first = pack.library_path()
    assert first.parent.name == "repro_torch" and first.suffix == ".so"
    assert pack.library_path() == first
    monkeypatch.setattr(pack, "_NVCC_FLAGS", [*pack._NVCC_FLAGS, "-lineinfo"])
    assert pack.library_path() != first


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    src = torch.arange(64.0).reshape(16, 4)
    offs = np.asarray([1, 0], np.int32)
    pack.reset_launch_counts()
    got = ops.pack_blocks(src, offs, tile_rows=8)
    assert torch.equal(got, ref.pack_blocks_ref(src, torch.from_numpy(offs),
                                                tile_rows=8))
    assert torch.equal(got, torch.cat([src[8:], src[:8]]))
    assert pack.launch_counts() == {"pack_blocks": 0, "pack_cols": 0}


def test_launch_counter_loses_no_update_under_threads():
    """Task threads launch concurrently; the per-wrapper count is a locked
    read-modify-write, so no increment may be lost."""
    pack.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [pack._count("pack_cols") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert pack.launch_counts() == {"pack_blocks": 0, "pack_cols": 32000}
    pack.reset_launch_counts()
