"""Tests of the port that need an NVIDIA GPU: the CUDA pack kernels (K1,
K2), flash attention (K3) and the SSD intra-chunk step (K4) against their
plain versions, the wrappers' checks on CUDA tensors, a small 4->2 workflow
and two-layer serving engines on ``cuda:0`` that count their launches.
They import torch and the port only (no JAX), so the card's machine runs
them with

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
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda

PACK = ("pack_blocks", "pack_cols")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in float32
    torch.backends.cudnn.allow_tf32 = False
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
    before = build.launch_counts([name])[name]
    got = fn(src.to(cuda), offs.numpy(), tile)
    torch.cuda.synchronize()
    assert build.launch_counts([name])[name] == before + 1
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
    build.reset_launch_counts(PACK)
    Wilkins(cfg, {"p": producer, "rows": consumer, "cols": consumer}).run(timeout=120)
    assert bad == []
    s = transport_stats().snapshot()
    assert s["reshard_pack"] == 2 * 2 * steps * 2 and s["reshard_numpy"] == 0
    assert build.launch_counts(PACK) == {"pack_blocks": 16, "pack_cols": 16}


# K3 cases: (B, S, H, KV, D, dtype, causal, window)
FA_CASES = [
    (1, 1000, 4, 4, 64, "float32", False, 0),     # MHA, non-causal
    (1, 1000, 6, 2, 128, "float32", True, 0),     # GQA rep 3 (Llama-3.2)
    (2, 1000, 8, 1, 80, "float32", True, 256),    # MQA, causal + window
    (1, 1000, 24, 8, 128, "bfloat16", True, 0),
    (1, 1000, 6, 2, 80, "bfloat16", True, 100),
    (1, 333, 4, 1, 64, "bfloat16", False, 0),
    (1, 77, 2, 2, 16, "float32", True, 0),
    (1, 130, 4, 2, 32, "float32", True, 48),
    (1, 2048, 24, 8, 128, "float32", True, 0),    # the serving path's shape
    (1, 2048, 24, 8, 128, "bfloat16", True, 0),
    (1, 1000, 4, 2, 16, "bfloat16", True, 0),     # tensor-core kernel, D = 16,
    (1, 1000, 4, 2, 64, "bfloat16", True, 0),     # 64 and 96, Sq not a
    (2, 999, 6, 2, 96, "bfloat16", False, 0),     # multiple of 64
]
# Both sides compute in float32 and round to bf16 once, so a bf16 output
# may differ by one bf16 ulp: at most 2^-7 of its magnitude (rtol), plus an
# absolute floor for outputs near zero.
FA_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (4e-3, 8e-3)}


@pytest.mark.parametrize("b,s,h,kv,d,dtype,causal,window", FA_CASES)
def test_flash_attention_matches_plain_version(cuda, b, s, h, kv, d, dtype,
                                               causal, window):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=g, device=cuda).to(dt)
    k = torch.randn((b, s, kv, d), generator=g, device=cuda).to(dt)
    v = torch.randn((b, s, kv, d), generator=g, device=cuda).to(dt)
    before = build.launch_counts(["flash_attention"])["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.launch_counts(["flash_attention"])["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and got.shape == q.shape
    atol, rtol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_attention_reads_fused_views_in_place(cuda):
    """bf16 q/k/v sliced from one fused (B, S, H + 2 KV, D) tensor have unit
    D stride and 16-byte strides: the kernel reads them without a copy.  A
    view whose pointer is off the 16-byte grid is copied first; both agree
    with the plain version."""
    b, s, h, kv, d = 2, 333, 6, 2, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    fused = torch.randn((b, s, h + 2 * kv, d), generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kv], fused[:, :, h + kv:]
    assert not q.is_contiguous() and all(fa._kernel_layout(t) is t for t in (q, k, v))
    flat = torch.randn(b * s * h * d + 1, generator=g, device=cuda).to(torch.bfloat16)
    q_off = flat[1:].view(b, s, h, d)
    assert fa._kernel_layout(q_off) is not q_off
    for qq in (q, q_off):
        got = ops.flash_attention(qq, k, v, causal=True)
        want = ref.flash_attention_ref(qq, k, v, causal=True)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=FA_TOL["bfloat16"][0],
                                   rtol=FA_TOL["bfloat16"][1])


# K4 cases: (B, S, H, P, G, N, chunk)
SSD_CASES = [
    (1, 2048, 80, 64, 1, 128, 256),   # the serving path's shape
    (2, 1000, 8, 64, 2, 128, 256),    # G = 2, ragged
    (1, 300, 4, 24, 1, 20, 128),      # P and N off the 16 grid, ragged
    (1, 100, 4, 8, 2, 8, 32),
    (1, 512, 12, 64, 1, 128, 256),    # 12 heads: subsets of 8 and 4
    (1, 600, 16, 32, 4, 64, 128),     # G = 4: one short subset per group
    (1, 256, 6, 80, 2, 32, 256),      # P > 64: subsets of 4 heads
    (1, 640, 4, 64, 1, 32, 320),      # q = 320: S in two windows
]


def _ssd_inputs(cuda, b, s, h, p, g, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dA = -torch.randn((b, s, h), generator=gen, device=cuda).abs() * 0.1
    Bm = torch.randn((b, s, g, n), generator=gen, device=cuda)
    Cm = torch.randn((b, s, g, n), generator=gen, device=cuda)
    s0 = torch.randn((b, h, n, p), generator=gen, device=cuda)
    return x, dA, Bm, Cm, s0


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_intra_chunk_matches_plain_version(cuda, b, s, h, p, g, n, chunk):
    q = min(chunk, s)
    nc = s // q
    x, dA, Bm, Cm, _ = _ssd_inputs(cuda, b, nc * q, h, p, g, n, s)
    args = (x.reshape(b, nc, q, h, p), dA.reshape(b, nc, q, h),
            Bm.reshape(b, nc, q, g, n), Cm.reshape(b, nc, q, g, n))
    before = build.launch_counts(["ssd_intra_chunk"])["ssd_intra_chunk"]
    y, st = ops.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert build.launch_counts(["ssd_intra_chunk"])["ssd_intra_chunk"] == before + 1
    y_ref, st_ref = ref.ssd_intra_chunk_ref(*args)
    torch.testing.assert_close(y, y_ref, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, st_ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_ssd_chunked_kernel_matches_plain_scan(cuda, b, s, h, p, g, n, chunk,
                                               with_state):
    from repro_torch.models.ssm import ssd_chunked

    x, dA, Bm, Cm, s0 = _ssd_inputs(cuda, b, s, h, p, g, n, s + 1)
    s0 = s0 if with_state else None
    y, f = ops.ssd_chunked_kernel(x, dA, Bm, Cm, chunk=chunk, initial_state=s0)
    y_ref, f_ref = ssd_chunked(x, dA, Bm, Cm, chunk=chunk, initial_state=s0)
    torch.testing.assert_close(y, y_ref, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(f, f_ref, atol=2e-4, rtol=2e-4)


def test_model_kernel_wrappers_check_cuda_inputs(cuda):
    q = torch.zeros((1, 8, 2, 16), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):   # raw launcher
        fa.flash_attention(q, q.detach(), q.detach(), True, 0)
    with pytest.raises(ValueError, match="multiple of 16"):
        z = torch.zeros((1, 8, 2, 24), device=cuda)
        ops.flash_attention(z, z, z)
    x = torch.zeros((1, 1, 8, 2, 130), device=cuda)
    with pytest.raises(ValueError, match=r"in \[1, 128\]"):
        ops.ssd_intra_chunk(x, torch.zeros((1, 1, 8, 2), device=cuda),
                            torch.zeros((1, 1, 8, 1, 8), device=cuda),
                            torch.zeros((1, 1, 8, 1, 8), device=cuda))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_two_layer_engine_on_the_card_counts_its_launches(cuda, arch):
    """Head dim 64, bf16, use_flash: every prefill launches the kernel once
    per layer, decode never; the greedy tokens equal the plain path's."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, Request, ServeConfig

    cfg = get_config(arch).replace(n_layers=2, vocab=1024)
    if arch == "llama3.2-3b":
        cfg = cfg.replace(d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024)
        name = "flash_attention"
    else:
        cfg = cfg.replace(d_model=256)   # d_inner 512: 8 heads of P = 64
        name = "ssd_intra_chunk"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (300, 600, 7)]
    outs = {}
    for use_flash in (True, False):
        eng = Engine(cfg.replace(use_flash=use_flash),
                     ServeConfig(max_slots=2, max_len=1024), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(1))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        build.reset_launch_counts([name])
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        launches = build.launch_counts([name])[name]
        assert launches == (len(prompts) * cfg.n_layers if use_flash else 0)
        assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
        outs[use_flash] = [r.out_tokens for r in reqs]
    agree = sum(a == b for a, b in zip(outs[True], outs[False]))
    assert agree >= 2, outs


# --------------------------------------------------------- recovery slice
def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.train import checkpoint as ck

    g = torch.Generator(device=cuda).manual_seed(3)
    state = {"rho": torch.randn((8, 5), generator=g, device=cuda),
             "w": torch.randn(6, generator=g, device=cuda).to(torch.bfloat16),
             "n": torch.tensor(4)}
    saver = ck.AsyncCheckpointer(str(tmp_path))
    saver.save(0, state)
    state["rho"].mul_(2.0)            # written in place after save returned
    saver.wait()
    out = ck.load_pytree(str(tmp_path / "step_00000000.ckpt"),
                         {"rho": torch.zeros((8, 5), device=cuda),
                          "w": torch.zeros(6, dtype=torch.bfloat16, device=cuda),
                          "n": torch.zeros((), dtype=torch.int64)})
    assert out["rho"].is_cuda and out["w"].is_cuda and not out["n"].is_cuda
    assert torch.equal(out["rho"] * 2.0, state["rho"])
    assert torch.equal(out["w"].view(torch.int16), state["w"].view(torch.int16))


def test_policy_rescale_replays_tensors_on_the_card(cuda, tmp_path):
    """reeber loses an instance at step 1 and comes back at one instance:
    the replayed steps reach it as CUDA tensors stitched on the card, its
    per-rank blocks go through K1, and the counts equal a crash-free run."""
    from repro_torch.core import FaultSpec, world

    yaml = """
tasks:
  - func: sim
    on_failure: {restart: {max_retries: 2}}
    outports: [{filename: f.h5, dsets: [{name: /d, memory: 1}]}]
  - func: reeber
    taskCount: 2
    nprocs: 2
    on_failure: {rescale: {nslots: 1, max_retries: 2}}
    inports: [{filename: f.h5, redistribute: 1, dsets: [{name: /d, memory: 1}]}]
"""
    rows, steps = 64, 4

    def run(faults):
        out, kinds, blocks = {}, set(), [0]

        def sim(comm):
            r = comm.restore({"t": torch.zeros((), dtype=torch.int64)})
            for t in range(int(r[1]["t"]) if r else 0, steps):
                g = torch.Generator(device=cuda).manual_seed(t)
                with h5.File("f.h5", "w") as f:
                    f.create_dataset("/d", copy=False, data=torch.rand(
                        (rows, 32, 16), generator=g, device=cuda))
                comm.checkpoint({"t": torch.tensor(t + 1)})

        def reeber():
            comm = world()
            spec = comm.resolve_redist_spec(port="f.h5")
            _, (n_rows, _, _) = even_blocks((rows, 32, 16), spec.nslots)[spec.slot]
            like = {"c": torch.zeros((n_rows, steps), dtype=torch.int64,
                                     device=cuda),
                    "n": torch.zeros((), dtype=torch.int64)}
            r = comm.restore(like)
            c, n = (r[1]["c"].clone(), int(r[1]["n"])) if r else (like["c"], 0)
            while True:
                f = h5.File("f.h5", "r")
                if f is None:
                    break
                kinds.add(f["/d"].read_direct().device.type)
                bs = comm.reshard(f["/d"], prefer="pack")
                blocks[0] += len(bs)
                c[:, n] = torch.cat([(b > 0.5).sum(dim=(1, 2)) for b in bs])
                n += 1
                comm.checkpoint({"c": c, "n": torch.tensor(n)},
                                sharded_axes={"c": 0})
            out[comm.instance] = c

        w = Wilkins(yaml, {"sim": sim, "reeber": reeber}, devices=[cuda],
                    spill_dir=str(tmp_path / str(bool(faults))))
        build.reset_launch_counts(PACK)
        rep = w.run(timeout=120, faults=faults)
        torch.cuda.synchronize()
        final = w.graph.tasks["reeber"].task_count
        counts = torch.cat([out[j] for j in range(final)])
        return rep, counts, kinds, blocks[0], build.launch_counts(PACK)

    _, ref_counts, _, _, _ = run(None)
    rep, counts, kinds, blocks, launches = run(
        FaultSpec(task="reeber", point="recv", step=1, instance=0))
    assert [(e["old_nslots"], e["new_nslots"]) for e in rep.rescales] == [(2, 1)]
    assert kinds == {"cuda"}
    assert torch.equal(counts, ref_counts)
    assert launches["pack_blocks"] == blocks > 0


# ---------------------------------------------------------- training slice
def _grad_close(got, want):
    """2e-4 relative, and absolute on the scale of the gradient's largest
    entry (``tests/test_torch_ssd.py``)."""
    for g, w in zip(got, want):
        atol = 2e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, atol=atol, rtol=2e-4)


@pytest.mark.parametrize("b,s,h,kv,d,window", [
    (1, 2048, 24, 8, 128, 0),     # the serving and training shape
    (2, 333, 8, 1, 64, 100),      # MQA, window, ragged
    (1, 6144, 32, 32, 80, 4096),  # zamba2's window gate: past its window
    (2, 1000, 32, 8, 80, 256),    # GQA with a window, ragged
])
def test_flash_attention_function_grads_match_plain(cuda, b, s, h, kv, d, window):
    """K3 under autograd on the card: the forward launches the kernel once,
    the backward recomputes in plain torch; the gradients of sum(out^2)
    equal autograd through the plain op at 2e-4 in float32."""
    g = torch.Generator(device=cuda).manual_seed(5)
    ins = [torch.randn(shape, generator=g, device=cuda)
           for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    a = [t.clone().requires_grad_() for t in ins]
    r = [t.clone().requires_grad_() for t in ins]
    build.reset_launch_counts(["flash_attention"])
    out = ops.flash_attention(*a, causal=True, window=window)
    got = torch.autograd.grad((out ** 2).sum(), a)
    torch.cuda.synchronize()
    assert build.launch_counts(["flash_attention"])["flash_attention"] == 1
    want = torch.autograd.grad(
        (ref.flash_attention_ref(*r, causal=True, window=window) ** 2).sum(), r)
    _grad_close(got, want)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_ssd_function_grads_match_plain(cuda, with_state):
    """The scan around K4 under autograd on the card at S = 2048 (the
    training shape's heads): one launch, gradients of sum(y^2) equal to
    autograd through the plain ``ssd_chunked`` at 2e-4."""
    from repro_torch.models.ssm import ssd_chunked

    x, dA, Bm, Cm, s0 = _ssd_inputs(cuda, 1, 2048, 80, 64, 1, 128, 9)
    ins = [x, dA, Bm, Cm] + ([s0] if with_state else [])
    a = [t.clone().requires_grad_() for t in ins]
    r = [t.clone().requires_grad_() for t in ins]
    build.reset_launch_counts(["ssd_intra_chunk"])
    y, _ = ops.ssd_chunked_kernel(*a[:4], chunk=256,
                                  initial_state=a[4] if with_state else None)
    got = torch.autograd.grad((y ** 2).sum(), a)
    torch.cuda.synchronize()
    assert build.launch_counts(["ssd_intra_chunk"])["ssd_intra_chunk"] == 1
    y_ref, _ = ssd_chunked(*r[:4], chunk=256,
                           initial_state=r[4] if with_state else None)
    _grad_close(got, torch.autograd.grad((y_ref ** 2).sum(), r))


def test_ssd_function_grads_match_plain_at_zamba2s_shape(cuda):
    """The scan around K4 under autograd at zamba2's SSD shape (80 heads of
    64, one group, N = 64): one launch, gradients within 2e-4."""
    from repro_torch.models.ssm import ssd_chunked

    ins = list(_ssd_inputs(cuda, 2, 2048, 80, 64, 1, 64, 11)[:4])
    a = [t.clone().requires_grad_() for t in ins]
    r = [t.clone().requires_grad_() for t in ins]
    build.reset_launch_counts(["ssd_intra_chunk"])
    y, _ = ops.ssd_chunked_kernel(*a, chunk=256)
    got = torch.autograd.grad((y ** 2).sum(), a)
    torch.cuda.synchronize()
    assert build.launch_counts(["ssd_intra_chunk"])["ssd_intra_chunk"] == 1
    y_ref, _ = ssd_chunked(*r, chunk=256)
    _grad_close(got, torch.autograd.grad((y_ref ** 2).sum(), r))


def test_hybrid_train_step_on_the_card_counts_its_launches(cuda):
    """zamba2 at 6 narrow layers (one shared-block group), bf16,
    ``remat="full"``: K4 launches twice a layer (the forward and the
    checkpoint's recompute), K3 once (the shared block runs outside
    ``remat``), and the loss falls over 4 steps."""
    from repro_torch.configs import get_config
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticCorpus,
                                   init_state, make_train_step)

    cfg = get_config("zamba2-2.7b").replace(
        n_layers=6, vocab=1024, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, use_flash=True)
    assert cfg.remat == "full" and cfg.dtype == "bfloat16" and cfg.attn_every == 6
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_state(torch.Generator(device=cuda).manual_seed(0), cfg, ocfg, cuda)
    step = make_train_step(cfg, ocfg)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=512,
                                        global_batch=2))
    losses = []
    for i in range(4):
        build.reset_launch_counts()
        state, m = step(state, corpus.batch(i))
        losses.append(float(m["loss"]))
        assert build.launch_counts(["flash_attention", "ssd_intra_chunk"]) == \
            {"flash_attention": 1, "ssd_intra_chunk": 12}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_two_layer_train_step_on_the_card_counts_its_launches(cuda, arch):
    """bf16, ``remat="full"``, ``use_flash``: a training step launches its
    kernel twice per layer (the forward and the checkpoint's recompute),
    and the loss falls over 4 steps."""
    from repro_torch.configs import get_config
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticCorpus,
                                   init_state, make_train_step)

    cfg = get_config(arch).replace(n_layers=2, vocab=1024, use_flash=True)
    if arch == "llama3.2-3b":
        cfg = cfg.replace(d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024)
        name = "flash_attention"
    else:
        cfg = cfg.replace(d_model=256)
        name = "ssd_intra_chunk"
    assert cfg.remat == "full" and cfg.dtype == "bfloat16"
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_state(torch.Generator(device=cuda).manual_seed(0), cfg, ocfg, cuda)
    step = make_train_step(cfg, ocfg)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=512,
                                        global_batch=2))
    losses = []
    for i in range(4):
        build.reset_launch_counts([name])
        state, m = step(state, corpus.batch(i))
        losses.append(float(m["loss"]))
        assert build.launch_counts([name])[name] == 2 * cfg.n_layers
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
