"""Tests of the port that need an NVIDIA GPU: the CUDA pack kernels against
their plain versions, the wrappers' checks on CUDA tensors, and a small
4->2 workflow on ``cuda:0``.  They import torch and the port only (no JAX),
so the card's machine runs them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

and they skip where there is no card."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Wilkins, h5  # noqa: E402
from repro_torch.core.datamodel import (BlockOwnership,  # noqa: E402
                                        reset_transport_stats, transport_stats)
from repro_torch.core.redistribute import even_blocks  # noqa: E402
from repro_torch.kernels import ops, pack, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pack kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "float64",
                                   "uint8"])
@pytest.mark.parametrize("dim, shape, tile, t", [
    (0, (61, 13), 8, 12), (0, (300, 9), 8, 257), (0, (16, 4), 8, 1),
    (1, (7, 61), 12, 12), (1, (9, 50), 8, 1),
    (1, (33, 7 * 256 * 3 + 5), 7 * 256, 257),
])
def test_kernel_matches_plain_version(cuda, dtype, dim, shape, tile, t):
    g = torch.Generator().manual_seed(7)
    src = torch.randint(0, 200, shape, generator=g).to(getattr(torch, dtype))
    n = -(-shape[dim] // tile)
    offs = torch.randint(0, n, (t,), generator=g, dtype=torch.int32)
    fn, plain = ((ops.pack_blocks, ref.pack_blocks_ref) if dim == 0
                 else (ops.pack_cols, ref.pack_cols_ref))
    name = "pack_blocks" if dim == 0 else "pack_cols"
    before = pack.launch_counts()[name]
    got = fn(src.to(cuda), offs.numpy(), tile)
    torch.cuda.synchronize()
    assert pack.launch_counts()[name] == before + 1
    assert got.is_cuda
    assert torch.equal(got.cpu(), plain(src, offs, tile))


def test_wrapper_checks_cuda_inputs(cuda):
    src = torch.zeros((16, 16), device=cuda)
    with pytest.raises(ValueError, match="C-contiguous"):
        ops.pack_cols(src.t(), np.asarray([0], np.int32), tile_cols=8)
    with pytest.raises(ValueError, match="tile offsets must lie in"):
        ops.pack_blocks(src, np.asarray([2], np.int32), tile_rows=8)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.pack_blocks(torch.zeros((8, 2), dtype=torch.complex128, device=cuda),
                        np.asarray([0], np.int32))


def test_reshard_auto_keeps_card_tensors_on_the_card(cuda):
    """prefer="auto": a lowerable CUDA tensor goes through the kernels; one
    whose plan has no kernel lowering raises instead of copying to the host,
    and only prefer="numpy" takes the host executors."""
    from repro_torch.core.comm import TaskComm
    from repro_torch.core.redistribute import RedistSpec

    spec = RedistSpec(axis=0, nslots=1, slot=0, nranks=2)
    g = torch.arange(24 * 4, dtype=torch.float32, device=cuda).reshape(24, 4)
    reset_transport_stats()
    blocks = TaskComm().reshard(g, spec, ranks="all")
    assert all(b.is_cuda for b in blocks)
    assert torch.equal(torch.cat(blocks), g)
    with pytest.raises(ValueError, match='pass prefer="numpy"'):
        TaskComm().reshard(g[:, 0].contiguous(), spec, ranks="all")
    host = TaskComm().reshard(g[:, 0].contiguous(), spec, ranks="all",
                              prefer="numpy")
    assert all(isinstance(b, np.ndarray) for b in host)
    np.testing.assert_array_equal(np.concatenate(host), g[:, 0].cpu().numpy())
    s = transport_stats().snapshot()
    assert (s["reshard_pack"], s["reshard_numpy"]) == (1, 1)


def test_small_4to2_workflow_on_the_card(cuda):
    shape, steps = (24, 16, 8), 2
    own = BlockOwnership()
    for r, (s, sh) in enumerate(even_blocks(shape, 4)):
        own.add(r, s, sh)
    fields, bad, lock = {}, [], threading.Lock()
    cfg = {"tasks": [
        {"func": "p", "taskCount": 4,
         "outports": [{"filename": "o.h5", "dsets": [{"name": "/d", "memory": 1}]}]},
        {"func": "rows", "taskCount": 2, "nprocs": 2,
         "inports": [{"filename": "o.h5", "redistribute": 1,
                      "dsets": [{"name": "/d", "memory": 1}]}]},
        {"func": "cols", "taskCount": 2, "nprocs": 2,
         "inports": [{"filename": "o.h5", "redistribute": {"axis": 2},
                      "dsets": [{"name": "/d", "memory": 1}]}]},
    ]}

    def producer(comm):
        gen = torch.Generator(device=comm.device).manual_seed(comm.instance)
        for t in range(steps):
            field = torch.rand(shape, generator=gen, device=comm.device)
            with lock:
                fields[(comm.instance, t)] = field
            with h5.File("o.h5", "w") as f:
                f.attrs["p"], f.attrs["t"] = comm.instance, t
                f.create_dataset("/d", data=field, ownership=own, copy=False)

    def consumer(comm):
        spec = comm.resolve_redist_spec()
        dst, _ = spec.dst_boxes(shape)
        while (f := h5.File("o.h5", "r")) is not None:
            field = fields[(f.attrs["p"], f.attrs["t"])]
            for r, b in zip(spec.my_ranks(), comm.reshard(f["/d"], prefer="pack")):
                starts, sh = dst[r]
                want = field[tuple(slice(s, s + n) for s, n in zip(starts, sh))]
                if not (b.is_cuda and torch.equal(b, want)):
                    bad.append((comm.task, r))

    reset_transport_stats()
    pack.reset_launch_counts()
    Wilkins(cfg, {"p": producer, "rows": consumer, "cols": consumer}).run(timeout=120)
    assert bad == []
    s = transport_stats().snapshot()
    assert s["reshard_pack"] == 2 * 2 * steps * 2 and s["reshard_numpy"] == 0
    assert pack.launch_counts() == {"pack_blocks": 16, "pack_cols": 16}
