"""The port's collective accounting and roofline terms
(``repro_torch.launch.hlo``) beside the JAX package's ``launch/hlo.py``:
the twins of the HLO and roofline cases of ``tests/test_sharding.py``,
the analytic counters held exactly equal over every arch, shape and mesh
split, and ``CommLog`` reading the HLO sample's collectives from live ones
on a fake group of 256 ranks."""

import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shapes_for as jshapes_for  # noqa: E402
from repro.launch import hlo as jhlo  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for  # noqa: E402
from repro_torch.launch import hlo  # noqa: E402


def _hlo_sample() -> str:
    path = os.path.join(os.path.dirname(__file__), "test_sharding.py")
    spec = importlib.util.spec_from_file_location("_sharding_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HLO_SAMPLE


def test_collective_bytes_while_scaling():
    sample = _hlo_sample()
    stats = hlo.collective_bytes(sample)
    want = jhlo.collective_bytes(sample)
    assert stats.bytes_by_kind == want.bytes_by_kind
    assert stats.count_by_kind == want.count_by_kind
    assert stats.bytes_by_kind["all-gather"] == 256 * 128 * 4
    assert stats.bytes_by_kind["all-reduce"] == 16 * 128 * 4 * 2 * 22
    assert stats.count_by_kind["all-reduce"] == 22


def test_shape_bytes_parsing():
    for text, n in (("bf16[2,3]", 12), ("f32[] ", 4), ("(f32[2], s8[4])", 12)):
        assert hlo._shape_bytes(text) == jhlo._shape_bytes(text) == n


def test_roofline_terms_at_the_h100_rates():
    r = hlo.Roofline(flops=hlo.PEAK_FLOPS, hbm_bytes=hlo.HBM_BW,
                     coll_bytes=hlo.LINK_BW, model_flops=hlo.PEAK_FLOPS / 2)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.bottleneck in ("compute", "memory", "collective")
    assert abs(r.roofline_fraction - 0.5) < 1e-9
    # the card's figures, none of the reference's TPU ones
    assert (hlo.PEAK_FLOPS, hlo.HBM_BW, hlo.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert hlo.peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 989e12, 67e12)
    with pytest.raises(RuntimeError, match="no peak rates"):
        hlo.peaks("TPU v5e")
    with open(hlo.__file__) as f:
        text = f.read()
    for tpu in ("197e12", "819e9", "50e9"):
        assert not re.search(rf"(?<![\d.]){tpu}", text), tpu


def test_analytic_stats_scale_with_shape():
    cfg = get_config("tinyllama-1.1b")
    train = SHAPES[0]
    a256 = hlo.analytic_stats(cfg, train, n_data=16, n_model=16)
    a512 = hlo.analytic_stats(cfg, train, n_data=32, n_model=16)
    assert a512["flops"] < a256["flops"]  # more devices -> fewer flops each
    assert a256 == jhlo.analytic_stats(jget_config("tinyllama-1.1b"), train,
                                       n_data=16, n_model=16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counters_equal_the_reference(arch):
    """Every counter, exactly, for each shape of the arch and each mesh
    split of the dry run's meshes (and pure data parallelism)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes = shapes_for(cfg)
    assert [s.name for s in shapes] == [s.name for s in jshapes_for(jcfg)]
    for shape in shapes:
        b, s = shape.global_batch, shape.seq_len
        assert hlo.model_flops_per_device(cfg, shape, 256) == \
            jhlo.model_flops_per_device(jcfg, shape, 256)
        assert hlo.forward_flops(cfg, b, s) == jhlo.forward_flops(jcfg, b, s)
        assert hlo.decode_flops(cfg, b, s) == jhlo.decode_flops(jcfg, b, s)
        assert hlo._cache_bytes(cfg, b, s) == jhlo._cache_bytes(jcfg, b, s)
        for n_data, n_model in ((16, 16), (32, 16), (256, 1)):
            for accum in (1, 4):
                assert hlo.analytic_stats(cfg, shape, n_data, n_model, accum) == \
                    jhlo.analytic_stats(jcfg, shape, n_data, n_model, accum), \
                    (shape.name, n_data, n_model, accum)


def test_comm_log_reads_the_hlo_samples_collectives_live():
    """22 all-reduces of f32[16,128] and one all-gather to f32[256,128] on
    a fake group of 256 ranks: the bytes and calls the HLO reader gives
    for the sample, where the loop body runs 22 times."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as fc

    from repro_torch.launch.dryrun import virtual_ranks

    with virtual_ranks(256), FakeTensorMode():
        group = dist.group.WORLD
        with hlo.CommLog() as log:
            for _ in range(22):
                fc.all_reduce(torch.empty(16, 128), "sum", group)
            fc.all_gather_tensor(torch.empty(1, 128), 0, group)
    assert not dist.is_initialized()
    stats = log.stats()
    want = hlo.collective_bytes(_hlo_sample())
    assert stats.bytes_by_kind == want.bytes_by_kind == {
        "all-gather": 256 * 128 * 4, "all-reduce": 16 * 128 * 4 * 2 * 22}
    assert stats.count_by_kind == {"all-gather": 1, "all-reduce": 22}
    assert {n for _, _, n, _ in log.calls} == {256}
    assert [shape for kind, *_, shape in log.calls if kind == "all-gather"] == \
        [(256, 128)]


def test_comm_log_counts_the_c10d_calls_and_skips_one_rank_groups():
    """``torch.distributed``'s in-place calls (``moe_a2a``'s) are counted
    as the functional ones; a group of one rank moves nothing."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import virtual_ranks

    with virtual_ranks(4), FakeTensorMode():
        pair = dist.new_group([0, 1])
        solo = dist.new_group([0])
        with hlo.CommLog() as log:
            dist.all_gather_into_tensor(torch.empty(2, 8), torch.empty(1, 8),
                                        group=pair)
            dist.reduce_scatter_tensor(torch.empty(1, 8), torch.empty(2, 8),
                                       group=pair)
            dist.all_reduce(torch.empty(4), group=solo)
    assert log.stats().bytes_by_kind == {"all-gather": 2 * 8 * 4,
                                         "reduce-scatter": 8 * 4 * 2}


def test_comm_log_sees_the_gather_dtensor_adds_inside_a_matmul():
    """``x @ w`` on a fake (2, 2) ("data", "model") mesh, both split along
    their first dimension over the data ranks: the contraction dimension
    of ``w`` is split, so DTensor gathers ``w`` inside the op.  The
    recorder must see that gather (it hands the ``DTensor`` op back so
    that DTensor lowers it while the mode is on): one all-gather over the
    two data ranks whose result is ``w``'s whole contraction dimension by
    the columns this rank keeps."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import virtual_ranks

    with virtual_ranks(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = DTensor.from_local(torch.empty(4, 16), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.empty(8, 32), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            with hlo.CommLog() as log:
                y = x @ w
            cols = y.to_local().shape[1]
    assert y.shape == (8, 32)
    assert [(k, n) for k, _, n, _ in log.calls] == [("all-gather", 2)]
    (_, nbytes, _, shape), = log.calls
    assert shape[0] * shape[1] == 16 * cols and nbytes == 16 * cols * 4


def test_comm_log_counts_dtensors_shard_dim_all_to_all():
    """A change of split dimension on a CUDA mesh is one
    ``_dtensor.shard_dim_alltoall`` call (a CPU mesh gathers instead):
    recorded as an all-to-all of its result's bytes."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import virtual_ranks

    with virtual_ranks(4), FakeTensorMode():
        pair = dist.new_group([0, 1])
        with hlo.CommLog() as log:
            out = torch.ops._dtensor.shard_dim_alltoall(
                torch.empty(4, 8), 0, 1, pair.group_name)
    assert out.shape == (8, 4)
    assert log.calls == [("all-to-all", 8 * 4 * 4, 2, (8, 4))]
