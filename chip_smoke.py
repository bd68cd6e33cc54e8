"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together) and then, each phase printing one
JSON line and any failure exiting non-zero:

1. device -- the card (``nvidia-smi`` name and power limit) and the build time
   (near zero when a build of the same sources and flags is already there);
2. kernels -- both kernels byte-equal to their plain PyTorch versions on the
   card over dtypes, ragged tails, tile widths and tile counts, including the
   shapes of phase 3;
3. main path -- a Nyx-style in situ coupling through ``repro_torch.core.Wilkins``
   on ``cuda:0``: 4 producer instances each write a 256^3 float32 density
   field per timestep (64 MiB, 4-block axis-0 ownership) for 8 timesteps; two
   consumers of 2 instances x 2 ranks reshard their slabs with
   ``comm.reshard(..., prefer="pack")`` -- ``reeber`` along axis 0 (pack_blocks),
   ``viz`` along axis 1 (pack_cols) -- and check every block against the field
   on the card.  The kernels' launch counts are read around this run;
4. times -- the workflow's wall time per timestep;
5. kernels_model -- flash attention (K3) and the SSD intra-chunk step (K4)
   against their plain PyTorch versions on the card: K3 in float32 (its
   CUDA-core kernel) and bfloat16 (its tensor-core kernel), MHA / GQA / MQA,
   head dims 16 to 128, causal, windowed and non-causal, S not a multiple of
   the 64-row tile, q/k/v as strided slices of one fused tensor (read in
   place), the serving shape in both dtypes and phase 9's training shape
   (batch 2) in bf16, and the shapes phase 6's other models hand it
   (``FA_FAMILY_CASES``: zamba2's 32 heads of 80 with its 4096 window at
   2048 and 6144 tokens, internvl2's 64/8 heads of 128 at 2048 + 256,
   phi3.5-moe's 32/8, whisper's decoder at 448); K4 with 1, 2 and 4
   groups, head counts that leave a short head subset, P above 64, ragged
   S, the serving shape, the training shape and zamba2's (N = 64); TF32
   off, so the plain versions are float32;
6. serve -- six models one after the other (``SERVE_MODELS``), at full
   width with random weights from ``--seed`` in bf16, through
   ``repro_torch.serve.Engine`` on ``cuda:0`` with ``use_flash``:
   ``llama3.2-3b``, ``mamba2-2.7b``, ``zamba2-2.7b`` (hybrid: K3 with its
   window and K4 in one forward), ``whisper-base`` (encdec: K3 in the
   decoder only, the encoder non-causal and plain; the engine's zero stub
   frames), ``phi3.5-moe-42b-a6.6b`` and ``internvl2-76b`` (after 256 zero
   stub vision tokens), the last two cut to 8 of their 32 and 80 layers.
   8 greedy requests of 16 new tokens, prompts of 256-2048 tokens (32-448
   for whisper, whose decoder context is 448), one of them the probe (1000
   tokens; 448 for whisper), 4 slots.  Every request must finish, and the
   prefills must launch each kernel exactly 8 x its launches per prefill
   (K3 28 / 9 / 6 / 8 / 8, K4 64 / 54), so decode and whisper's encoder
   launch none.  The probe's last-token prefill logits are held twice: on
   a float32 copy of the weights the kernel path must agree with the plain
   path within a limit per model (``F32_LIMIT``); as served in bf16, the
   kernel path's distance from the float32 plain logits must stay within
   ``BF16_RATIO`` times the bf16 plain path's own (64 bf16 layers of random
   weights amplify rounding-order differences, so a fixed bf16 limit would
   hold nothing).  These gates give whisper and internvl2 seeded random
   stub inputs.  zamba2 also runs one prefill of 6144 tokens, past its
   window, through ``hybrid.forward`` on its float32 weights: every
   position's logits on the kernel path against the plain (blockwise,
   windowed) path under its ``F32_LIMIT``.  Launch counts are set to 0
   just before each model's requests and read just after; prefill and
   decode are timed alone, and with ``--profile`` decode's device time is
   taken with ``torch.profiler``;
7. the per-kernel line -- K1 and K2 at the shapes of phase 3, K3 (bf16, and
   float32 as a second entry) and K4 at the serving shape (S = 2048): CUDA
   events with a cold L2, beside the bound (the larger of bytes over the
   memory rate and operations over the peak rate of their type) and its
   share of the kernel's time, the plain version and one PyTorch call
   computing the same function where there is one (SDPA for K3; where a
   window bites, with a boolean sliding-window mask).  ``launches`` is the
   count on the path: phase 3 for K1/K2, phase 6's requests of all six
   models for K3 bf16 and K4 (``launches_by_arch`` splits them), phase 6's
   float32 gates for K3 float32; K1/K2 also carry their launches in each
   run of phase 8 (``launches_faults``), K3 bf16 and K4 in phase 9's
   training steps (``launches_train``);
8. faults -- checkpointed restart and elastic rescale on ``cuda:0`` at the
   field size of phase 3: one ``nyx`` evolves a 256^3 float32 density (from
   ``--seed``) through 8 snapshots with a torch diffusion step and
   checkpoints ``{"rho", "t"}`` (64 MiB) after every snapshot under
   ``on_failure: restart``; ``reeber`` (2 instances x 2 ranks, axis 0,
   ``on_failure: {rescale: {nslots: 1}}``, a stall watchdog) cuts each slab
   into rank blocks with ``comm.reshard(..., prefer="pack")`` (K1), counts
   the cells above a threshold per row and snapshot, and checkpoints the
   counts as a shard; ``viz`` (``io_freq: 2``, axis 1, K2) is dropped when
   it fails.  Four runs: (a) crash-free, (b) ``reeber[0]`` crashes at recv
   step 2 (policy rescale 2->1), (c) ``reeber[1]`` stalls at recv step 1
   (watchdog rescale 2->1), (d) ``nyx`` crashes at close step 3 and restarts
   from its checkpoint while ``viz`` crashes and is dropped.  Gates: every
   run's counts byte-identical to (a)'s, (a)'s equal to the same 8 steps
   recounted in a plain loop on the card, exactly one (2, 1) rescale in (b)
   and (c) with triggers ``policy`` and ``stall``, and in every run K1's
   launches (counts set to 0 just before the run, read just after) equal to
   the rank blocks ``reeber``'s ``comm.reshard`` calls returned (one launch
   per block), K2's to ``viz``'s.  Printed per run: wall time per snapshot,
   checkpoint blocking time and bytes, restart and rescale latency and cut
   step, the calls and launches;
9. train -- ``llama3.2-3b`` and then ``mamba2-2.7b`` trained with
   ``repro_torch.train`` on ``cuda:0``, K3 and K4 under autograd (their
   forward the kernel, their backward a plain recompute).  (a) A gradient
   gate at full width and 2 layers on float32 weights, batch 1 x 2048
   tokens: the kernel path's loss within 1e-5 and every parameter's
   gradient within 1e-4 (relative L2) of the plain path's.  (b) Full width
   and depth as configured (bf16, ``remat="full"``, ``use_flash``): 4
   steps of ``make_train_step`` on batch 2 x 2048 tokens of
   ``SyntheticCorpus(seed)`` with ``AdamWConfig(lr=1e-3, warmup_steps=1,
   total_steps=4)``; every loss finite, the 4th below the 1st, the kernel
   launched exactly 2 x layers per step (the forward and the checkpoint's
   recompute; counts set to 0 just before the 4 steps and read just after),
   the other model kernel and the plain versions of K3/K4 never.  Printed:
   seconds per step, tokens/s, peak device memory, and, from a fifth step
   taken under ``torch.profiler``, the device time per step by kernel kind
   and its share of the unprofiled step's wall time (the busy share), and
   the wall time of one more AdamW update (on zero gradients).  (c) Each autograd
   Function's gradients of sum(out^2) against autograd through the plain
   op on the card at 2e-4 in float32: K3 at the serving shape, K4 at
   S = 2048.

The lines before the last are the whole run's wall time (builds included),
the per-kernel summary and the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero before printing any
result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SHAPE = (256, 256, 256)      # one 64 MiB float32 density field
STEPS = 8
N_PROD = 4
TILE = 8                     # tile extent along the decomposed axis
REPS = 30                    # timed launches per measurement
SPIN_CYCLES = 1_000_000      # about half a millisecond of the card's clock
# peak memory bandwidth (bytes/s), dense bf16 tensor-core and float32 CUDA-core
# rates (FLOP/s), by device name (NVIDIA data sheets, at the full power limit)
PEAKS = (("H100 80GB HBM3", 3.35e12, 989e12, 67e12),
         ("H100 SXM", 3.35e12, 989e12, 67e12),
         ("H100 NVL", 3.9e12, 835e12, 60e12),
         ("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H200", 4.8e12, 989e12, 67e12))
REPLACES = {"pack_blocks": "src/repro/kernels/pack.py:37",
            "pack_cols": "src/repro/kernels/pack.py:74",
            "flash_attention": "src/repro/kernels/flash_attention.py:87",
            "ssd_intra_chunk": "src/repro/kernels/ssd_scan.py:52"}
CSRC = "src/repro_torch/kernels/csrc"
SOURCES = {"pack_blocks": "pack", "pack_cols": "pack",
           "flash_attention": "flash_attention", "ssd_intra_chunk": "ssd_scan"}
# phase 6: six models at full width, one after the other: (arch, each kernel's
# launches per prefill, prompt lengths drawn from the seed, the probe's length
# (one prompt's, and the flash-vs-plain probe), layers kept of the config's).
# phi3.5-moe and internvl2 keep 8 of their 32 and 80 layers.  In bf16 the full
# models take 85 and 153 GB, more than the card holds, but bf16 weights and
# the KV cache alone would fit about 30 and 42 layers (80 GB, no activations).
# The cut is set by the float32 gate, which converts these same weights in
# place (4 bytes a parameter: room for about 15 and 20 layers), with room left
# for its activations and for the script's time limit
SERVE_MODELS = (
    ("llama3.2-3b", {"flash_attention": 28}, (256, 2048), 1000, None),
    ("mamba2-2.7b", {"ssd_intra_chunk": 64}, (256, 2048), 1000, None),
    ("zamba2-2.7b", {"flash_attention": 9, "ssd_intra_chunk": 54}, (256, 2048),
     1000, None),
    ("whisper-base", {"flash_attention": 6}, (32, 448), 448, None),  # decoder only
    ("phi3.5-moe-42b-a6.6b", {"flash_attention": 8}, (256, 2048), 1000, 8),
    ("internvl2-76b", {"flash_attention": 8}, (256, 2048), 1000, 8),
)
N_REQUESTS = 8
NEW_TOKENS = 16
SERVE_SLOTS = 4
SERVE_MAX_LEN = 4096
# phase 6 gates: kernel path vs plain path on float32 weights, per model, and,
# as served in bf16, the kernel path's error against the float32 plain logits
# over the bf16 plain path's error against them.  The K3-only models take
# llama's limit and zamba2 mamba's.  Readings on the H100 (relative L2):
# llama 3.8e-6, mamba 2.4e-4, zamba2 3.1e-4 (its 6144-token window gate
# 1.7e-4), whisper 7.9e-7, phi3.5-moe 1.4e-6, internvl2 4.3e-6
F32_LIMIT = {"llama3.2-3b": 1e-4, "mamba2-2.7b": 2e-3, "zamba2-2.7b": 2e-3,
             "whisper-base": 1e-4, "phi3.5-moe-42b-a6.6b": 1e-4,
             "internvl2-76b": 1e-4}
BF16_RATIO = 2.0
WINDOW_GATE_S = 6144         # zamba2: one prefill past its 4096-token window
TIME_S = 2048                # serving shape at which K3 and K4 are timed
# phase 9: training at full width, one model after the other
TRAIN_ARCHS = (("llama3.2-3b", "flash_attention"), ("mamba2-2.7b", "ssd_intra_chunk"))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
GATE_LAYERS, GATE_BATCH = 2, 1
LOSS_LIMIT = 1e-5            # kernel vs plain path, float32, relative
GRAD_LIMIT = 1e-4            # relative L2, every parameter
FN_GRAD_TOL = 2e-4           # each Function vs the plain op (test_kernels.py)
# phase 8: the fault-tolerance runs
FAULT_SNAPSHOTS = 8
THRESHOLD = 1.01             # a halo cell: density above this
STALL_TIMEOUT_S = 1.5        # reeber's watchdog window
STALL_S = 5.0                # run (c)'s injected stall, well past the window
FAULT_RUNS = (
    ("a", []),
    ("b", [{"task": "reeber", "point": "recv", "step": 2, "instance": 0}]),
    ("c", [{"task": "reeber", "kind": "stall", "point": "recv", "step": 1,
            "instance": 1, "seconds": STALL_S}]),
    ("d", [{"task": "nyx", "point": "close", "step": 3},
           {"task": "viz", "point": "open", "step": 1}]),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def peaks(name: str):
    """(bytes/s, bf16 FLOP/s, float32 FLOP/s) of the card."""
    for key, *rates in PEAKS:
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates on record for {name!r}")


def source(name: str) -> str:
    return f"{CSRC}/{SOURCES[name]}.cu"


# --------------------------------------------------------------- phase 2
def check_kernels(ops, ref, build, dev) -> float:
    """Every kernel call equal to its plain version; returns the largest
    absolute difference seen (0 for a byte copy)."""
    g = torch.Generator(device=dev).manual_seed(11)
    rng = np.random.default_rng(11)
    cases = []
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.float64):
        for t in (1, 12, 257):
            cases += [(dt, 0, (61, 13), 8, t), (dt, 0, (300, 9), 8, t),
                      (dt, 1, (7, 61), 8, t), (dt, 1, (9, 50), 12, t),
                      (dt, 1, (33, 7 * 256 * 3 + 5), 7 * 256, t)]
    # the shapes the main path hands the kernels (see phase 3)
    cases += [(torch.float32, 0, (128, 65536), TILE, 8),
              (torch.float32, 1, (256, 32768), TILE * 256, 8)]
    # ... and phase 8: reeber's 128-row slabs and, after the rescale, its
    # 256-row slab, two ranks each; viz's whole field in column tiles
    cases += [(torch.float32, 0, (128, 65536), TILE, 8),
              (torch.float32, 0, (256, 65536), TILE, 16),
              (torch.float32, 1, (256, 65536), TILE * 256, 16)]
    worst = 0.0
    for dt, dim, shape, tile, t in cases:
        src = torch.randint(-1000, 1000, shape, generator=g, device=dev).to(dt)
        n = -(-shape[dim] // tile)
        offs = rng.integers(0, n, size=t).astype(np.int32)  # host, as plans give them
        fn, plain = ((ops.pack_blocks, ref.pack_blocks_ref) if dim == 0
                     else (ops.pack_cols, ref.pack_cols_ref))
        name = "pack_blocks" if dim == 0 else "pack_cols"
        before = build.launch_counts([name])[name]
        got = fn(src, offs, tile)
        torch.cuda.synchronize()
        if build.launch_counts([name])[name] != before + 1:
            raise RuntimeError(f"{name} did not count its launch")
        want = plain(src, torch.from_numpy(offs).to(dev), tile)
        if not torch.equal(got, want):
            raise RuntimeError(f"{name} differs from its plain version: "
                               f"{dt} {shape} tile={tile} T={t}")
        worst = max(worst, (got.double() - want.double()).abs().max().item())
    return worst


# --------------------------------------------------------------- phase 3
def workflow(core, dev, seed: int, verify: bool):
    from repro_torch.core.datamodel import BlockOwnership
    from repro_torch.core.redistribute import even_blocks

    own = BlockOwnership()
    for r, (s, sh) in enumerate(even_blocks(SHAPE, N_PROD)):
        own.add(r, s, sh)
    fields = {}
    calls = {"reeber": 0, "viz": 0}
    failures = []
    lock = threading.Lock()
    cfg = {"tasks": [
        {"func": "nyx", "taskCount": N_PROD, "nprocs": 1,
         "outports": [{"filename": "plt.h5",
                       "dsets": [{"name": "/density", "memory": 1}]}]},
        {"func": "reeber", "taskCount": 2, "nprocs": 2,
         "inports": [{"filename": "plt.h5", "redistribute": 1,
                      "dsets": [{"name": "/density", "memory": 1}]}]},
        {"func": "viz", "taskCount": 2, "nprocs": 2,
         "inports": [{"filename": "plt.h5", "redistribute": {"axis": 1},
                      "dsets": [{"name": "/density", "memory": 1}]}]},
    ]}

    def nyx(comm):
        gen = torch.Generator(device=comm.device).manual_seed(seed * 100 + comm.instance)
        for t in range(STEPS):
            field = torch.rand(SHAPE, generator=gen, device=comm.device)
            if verify:
                with lock:
                    fields[(comm.instance, t)] = field
            with core.h5.File("plt.h5", "w") as f:
                f.attrs["producer"] = comm.instance
                f.attrs["step"] = t
                f.create_dataset("/density", data=field, ownership=own, copy=False)

    def consumer(comm):
        spec = comm.resolve_redist_spec()
        dst, _ = spec.dst_boxes(SHAPE)
        while True:
            f = core.h5.File("plt.h5", "r")
            if f is None:
                break
            blocks = comm.reshard(f["/density"], prefer="pack")
            with lock:
                calls[comm.task] += 1
            if not verify:
                torch.cuda.synchronize()
                continue
            field = fields[(f.attrs["producer"], f.attrs["step"])]
            for r, b in zip(spec.my_ranks(), blocks):
                starts, sh = dst[r]
                want = field[tuple(slice(s, s + n) for s, n in zip(starts, sh))]
                if not (b.device == field.device and torch.equal(b, want)):
                    failures.append((comm.task, comm.instance, r))

    w = core.Wilkins(cfg, {"nyx": nyx, "reeber": consumer, "viz": consumer},
                     devices=[dev])
    t0 = time.perf_counter()
    report = w.run(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return report, calls, failures, wall


# --------------------------------------------------------------- phase 4
def time_ms(fn, flush) -> float:
    """Median device time of ``fn`` over REPS launches, L2 flushed before
    each (the main path finds its slab cold).  A spin kernel keeps the card
    busy while the host queues the start event and ``fn``'s launches, so a
    slow host adds no idle time between the events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def time_kernels(pack, ops, ref, dev, peak_bw, launches, steps, worst):
    """Time each kernel at the shapes phase 3 gives it: one consumer rank's
    gather of 8 tiles from its instance's slab."""
    lib = pack._library()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    out = []
    # reeber slab: (128, 256, 256) viewed (128, 65536); viz slab after its
    # contiguous copy: (256, 128, 256) viewed (256, 32768) with tc = 8 * 256
    for name, rows, cols, tile, fn_name in (
            ("pack_blocks", 128, 65536, TILE, "wlk_pack_rows"),
            ("pack_cols", 256, 32768, TILE * 256, "wlk_pack_cols")):
        src = torch.rand((rows, cols), generator=g, device=dev)
        offs = torch.arange(8, 16, dtype=torch.int32, device=dev)  # rank 1's tiles
        offs_host = offs.cpu().numpy()  # what the plan hands the wrapper
        shape = (8 * tile, cols) if name == "pack_blocks" else (rows, 8 * tile)
        dst = torch.empty(shape, dtype=src.dtype, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def kernel():
            err = getattr(lib, fn_name)(src.data_ptr(), dst.data_ptr(),
                                        offs.data_ptr(), rows, cols, tile, 8,
                                        src.element_size(), stream)
            if err:
                raise RuntimeError(f"{name}: cudaError_t {err}")

        wrapper = getattr(ops, name)
        plain = getattr(ref, f"{name}_ref")
        if name == "pack_blocks":
            def library():
                return src.view(-1, tile, cols).index_select(0, offs)
        else:
            def library():
                return src.view(rows, -1, tile).index_select(1, offs)
        moved = 2 * dst.numel() * dst.element_size() + offs.numel() * 4
        bound = moved / peak_bw * 1e3
        ms = time_ms(kernel, flush)
        out.append({
            "name": name, "dtype": "float32", "route": "cuda",
            "source": source(name),
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_step": launches[name] / steps,
            "max_abs_err": worst,
            "ms": ms,
            "wrapper_ms": time_ms(lambda: wrapper(src, offs_host, tile), flush),
            "plain_ms": time_ms(lambda: plain(src, offs, tile), flush),
            "bound_ms": bound, "bound_by": "bytes", "share_of_bound": bound / ms,
            "bytes": moved,
            "library_ms": time_ms(library, flush),
            "bandwidth_gbs": moved / ms / 1e6,
        })
    return out


# --------------------------------------------------------------- phase 5
FA_CASES = [  # (B, S, H, KV, D, dtype, causal, window)
    (1, 1000, 4, 4, 64, torch.float32, False, 0),      # MHA, non-causal
    (1, 1000, 24, 8, 128, torch.float32, True, 0),     # GQA rep 3 (Llama-3.2)
    (2, 1000, 8, 1, 80, torch.float32, True, 256),     # MQA, causal + window
    (1, 1000, 4, 4, 64, torch.bfloat16, False, 0),
    (1, 1000, 24, 8, 128, torch.bfloat16, True, 0),
    (2, 1000, 8, 1, 80, torch.bfloat16, True, 256),
    (1, 1000, 6, 2, 96, torch.bfloat16, True, 100),
    (1, 1000, 4, 2, 16, torch.bfloat16, True, 0),      # tensor-core kernel at
    (1, 1000, 4, 2, 64, torch.bfloat16, True, 0),      # D = 16, 64, 96, Sq not
    (2, 999, 6, 2, 96, torch.bfloat16, False, 0),      # a multiple of 64
    (1, TIME_S, 24, 8, 128, torch.float32, True, 0),   # the serving shape
    (1, TIME_S, 24, 8, 128, torch.bfloat16, True, 0),
    (2, TIME_S, 24, 8, 128, torch.bfloat16, True, 0),  # the training shape
]
# phase 6's other models, at the shapes their prefills hand K3: label ->
# (B, S, H, KV, D, dtype, causal, window)
FA_FAMILY_CASES = {
    "zamba2 serving": (1, TIME_S, 32, 32, 80, torch.bfloat16, True, 4096),
    "zamba2 window gate": (1, 6144, 32, 32, 80, torch.float32, True, 4096),
    "zamba2 past the window": (1, 6144, 32, 32, 80, torch.bfloat16, True, 4096),
    "internvl2 serving": (1, TIME_S + 256, 64, 8, 128, torch.bfloat16, True, 0),
    "phi3.5-moe serving": (1, TIME_S, 32, 8, 128, torch.bfloat16, True, 0),
    "whisper decoder": (1, 448, 8, 8, 64, torch.bfloat16, True, 0),
}
# bf16 q/k/v as slices of one fused (B, S, H + 2 KV, D) tensor: strided views
# with unit D stride, which the kernel reads in place: (B, S, H, KV, D, causal)
FA_FUSED_CASES = [(2, 1000, 24, 8, 128, True)]
# (atol, rtol).  Both sides compute in float32 and round to bf16 once, so a
# bf16 output may differ by one bf16 ulp: at most 2^-7 of its magnitude
# (rtol), plus an absolute floor for outputs near zero.
FA_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (4e-3, 8e-3)}
SSD_CASES = [  # (B, S, H, P, G, N, chunk)
    (2, 1000, 8, 64, 2, 128, 256),    # G = 2, ragged S
    (1, 1000, 80, 64, 1, 128, 256),   # ragged S
    (1, 300, 4, 24, 1, 20, 128),      # P and N off the 16 grid
    (1, 1000, 12, 64, 1, 128, 256),   # 12 heads: subsets of 8 and 4
    (1, 1000, 16, 32, 4, 64, 128),    # G = 4: one short subset per group
    (1, 600, 6, 80, 2, 32, 256),      # P > 64: subsets of 4 heads
    (1, TIME_S, 80, 64, 1, 128, 256), # the serving shape
    (2, TIME_S, 80, 64, 1, 128, 256), # the training shape
]
SSD_FAMILY_CASES = {"zamba2 serving": (1, TIME_S, 80, 64, 1, 64, 256)}


def fa_inputs(dev, b, s, h, kv, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype),
            torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype),
            torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype))


def ssd_inputs(dev, b, s, h, p, g_, n, chunk, seed):
    """Chunked (B, NC, q, ...) inputs of the intra-chunk step, S padded to
    whole chunks with zeros as the wrapper pads; dA = -|N(0,1)| * 0.1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = min(chunk, s)
    nc = -(-s // q)
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dA = -torch.randn((b, s, h), generator=gen, device=dev).abs() * 0.1
    Bm = torch.randn((b, s, g_, n), generator=gen, device=dev)
    Cm = torch.randn((b, s, g_, n), generator=gen, device=dev)

    def chunks(a):
        pad = a.new_zeros((b, nc * q - s) + tuple(a.shape[2:]))
        return torch.cat([a, pad], dim=1).reshape((b, nc, q) + tuple(a.shape[2:]))

    return tuple(chunks(a) for a in (x, dA, Bm, Cm))


def check_model_kernels(ops, ref, build, dev):
    """K3 and K4 against their plain versions: the largest absolute error
    per kernel (and at the serving shape), raising beyond the tolerances."""
    def launched(name, fn):
        before = build.launch_counts([name])[name]
        out = fn()
        torch.cuda.synchronize()
        if build.launch_counts([name])[name] != before + 1:
            raise RuntimeError(f"{name} did not count its launch")
        return out

    from repro_torch.kernels import flash_attention as fa

    res = {"flash_attention": {"cases": 0, "max_abs_err_f32": 0.0,
                               "max_abs_err_bf16": 0.0, "max_share_of_limit": 0.0,
                               "serving_shape": {}, "family_shapes": {}},
           "ssd_intra_chunk": {"cases": 0, "max_abs_err": 0.0,
                               "family_shapes": {}}}
    cases = [(c, False, None) for c in FA_CASES] + [
        ((b, s, h, kv, d, torch.bfloat16, causal, 0), True, None)
        for b, s, h, kv, d, causal in FA_FUSED_CASES] + [
        (c, False, label) for label, c in FA_FAMILY_CASES.items()]
    for i, ((b, s, h, kv, d, dt, causal, window), fused, label) in enumerate(cases):
        if fused:
            g = torch.Generator(device=dev).manual_seed(100 + i)
            qkv = torch.randn((b, s, h + 2 * kv, d), generator=g, device=dev).to(dt)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
            if not all(fa._kernel_layout(t) is t for t in (q, k, v)):
                raise RuntimeError("flash_attention copies fused q/k/v views")
        else:
            q, k, v = fa_inputs(dev, b, s, h, kv, d, dt, 100 + i)
        got = launched("flash_attention", lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window))
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        atol, rtol = FA_TOL[dt]
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        share = (diff / (atol + rtol * want.float().abs())).max().item()
        if got.dtype != dt or share > 1:
            raise RuntimeError(f"flash_attention differs from its plain version "
                               f"(max abs err {err}, {share} of the limit): "
                               f"{b, s, h, kv, d, dt, causal, window}")
        r = res["flash_attention"]
        key = "max_abs_err_f32" if dt == torch.float32 else "max_abs_err_bf16"
        r[key] = max(r[key], err)
        r["max_share_of_limit"] = max(r["max_share_of_limit"], share)
        r["cases"] += 1
        if label is not None:
            r["family_shapes"][label] = {"shape": [b, s, h, kv, d], "window": window,
                                         "dtype": str(dt).removeprefix("torch."),
                                         "max_abs_err": err, "share_of_limit": share}
        elif (b, s, h, kv, d) == (1, TIME_S, 24, 8, 128):
            r["serving_shape"][str(dt).removeprefix("torch.")] = err
        del got, want, diff
    ssd_cases = [(c, None) for c in SSD_CASES] + [
        (c, label) for label, c in SSD_FAMILY_CASES.items()]
    for i, ((b, s, h, p, g_, n, chunk), label) in enumerate(ssd_cases):
        args = ssd_inputs(dev, b, s, h, p, g_, n, chunk, 200 + i)
        y, st = launched("ssd_intra_chunk", lambda: ops.ssd_intra_chunk(*args))
        y_ref, st_ref = ref.ssd_intra_chunk_ref(*args)
        err = max((y - y_ref).abs().max().item(), (st - st_ref).abs().max().item())
        if not (torch.allclose(y, y_ref, atol=2e-4, rtol=2e-4)
                and torch.allclose(st, st_ref, atol=2e-4, rtol=2e-4)):
            raise RuntimeError(f"ssd_intra_chunk differs from its plain version "
                               f"(max abs err {err}): {b, s, h, p, g_, n, chunk}")
        r = res["ssd_intra_chunk"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"] += 1
        if label is not None:
            r["family_shapes"][label] = {"shape": [b, s, h, p, g_, n, chunk],
                                         "max_abs_err": err}
        elif (b, s, n) == (1, TIME_S, 128):
            r["max_abs_err_serving_shape"] = err
    return res


# --------------------------------------------------------------- phase 6
def device_kernels(fn):
    """The CUDA kernels ``fn`` ran, from ``torch.profiler``'s key averages
    (an empty list where the profiler saw no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def decode_device_time(fn, n, wall_per_token):
    """Device (kernel) time per token of ``fn`` under ``torch.profiler``,
    and its share of the unprofiled wall time per token.  A measurement
    only: where the profiler gives no device time, it says so."""
    try:
        events = device_kernels(fn)
    except Exception as exc:  # noqa: BLE001 -- the profiler is untried on this card
        return {"decode_device_time": f"not measured: {type(exc).__name__}: {exc}"}
    dev_us = sum(e.self_device_time_total for e in events)
    if not dev_us:
        return {"decode_device_time": "not measured: no device time in the trace"}
    per_token = dev_us * 1e-6 / n
    return {"decode_device_s_per_token": per_token,
            "decode_device_busy_share": per_token / wall_per_token,
            "decode_kernels_per_token": sum(e.count for e in events) / n}


def stub_inputs(cfg, dev, seed):
    """The frontends' stand-ins of the vlm and encdec families for the
    logits gates: vision embeddings (1, V, d) and frames (1, S_src, d),
    N(0, 0.02^2) from the seed (the engine serves zeros, as the reference
    engine does)."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    if cfg.family == "vlm":
        return {"vision_embeds": 0.02 * torch.randn(
            (1, cfg.vision_tokens, cfg.d_model), generator=g, device=dev)}
    if cfg.family == "encdec":
        return {"frames": 0.02 * torch.randn(
            (1, cfg.source_len, cfg.d_model), generator=g, device=dev)}
    return {}


def launches_since(build, before):
    """Each kernel's launches since ``before`` (a ``launch_counts()``), for
    the kernels that launched."""
    return {k: n - before.get(k, 0) for k, n in build.launch_counts().items()
            if n - before.get(k, 0)}


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def window_gate(model, cfg, want, build, dev, seed):
    """zamba2 past its window: one prefill of WINDOW_GATE_S tokens through
    ``hybrid.forward`` without a cache, on the model's float32 weights;
    the kernel path's logits at every position against the plain path's
    (blockwise, windowed) under the model's F32_LIMIT, and the kernel
    path's launches against ``want``, one prefill's."""
    from repro_torch.models import hybrid
    from repro_torch.models import layers as L

    c = cfg.replace(dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, (1, WINDOW_GATE_S)), device=dev)
    out, launched = {}, {}
    for use_flash in (True, False):
        before = build.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _ = hybrid.forward(model, c.replace(use_flash=use_flash), toks)
        out[use_flash] = L.unembed(model.embed, h)[0].float()
        torch.cuda.synchronize()
        launched[use_flash] = launches_since(build, before)
        out[f"s_{use_flash}"] = time.perf_counter() - t0
    err = rel_l2(out[True], out[False])
    row = {"tokens": WINDOW_GATE_S, "window": cfg.window,
           "flash_vs_plain_rel_l2_f32": err, "limit": F32_LIMIT[cfg.name],
           "launches": launched[True], "plain_launches": launched[False],
           "flash_s": out["s_True"], "plain_s": out["s_False"],
           "logits_finite": bool(torch.isfinite(out[True]).all()
                                 and torch.isfinite(out[False]).all())}
    problems = []
    if not (row["logits_finite"] and err <= F32_LIMIT[cfg.name]):
        problems.append(f"{cfg.name}: the {WINDOW_GATE_S}-token windowed prefill "
                        f"differs: {row}")
    if launched[True] != want or launched[False]:
        problems.append(f"{cfg.name}: window gate launches {launched}, "
                        f"expected {want} on the kernel path and none plain")
    del out
    return row, launched[True], problems


def serve_model(arch, per_prefill, prompt_lens, probe_len, n_layers, build, dev,
                seed, profile):
    """One model at full width through the port's Engine; returns its
    metrics, the launches of every kernel during its requests, and the
    launches of its float32 gates."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_family
    from repro_torch.serve import Engine, Request, ServeConfig

    full = get_config(arch)
    cfg = full.replace(use_flash=True)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, ServeConfig(max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN),
                 device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, size=N_REQUESTS)
    lens[N_REQUESTS // 2] = probe_len
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32) for n in lens]

    warm = Request(rid=-1, prompt=prompts[0][:64], max_new_tokens=2)  # cuBLAS, allocator
    eng.submit(warm)
    eng.run_until_drained()
    torch.cuda.synchronize()

    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    build.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = build.launch_counts()

    problems = []
    if not all(r.done and len(r.out_tokens) == NEW_TOKENS for r in reqs):
        problems.append(f"{arch}: requests unfinished: "
                        f"{[len(r.out_tokens) for r in reqs]}")
    for kernel, per in per_prefill.items():
        want = N_REQUESTS * per
        if launches.get(kernel, 0) != want:
            problems.append(f"{arch}: {kernel} launched {launches.get(kernel, 0)} "
                            f"times, expected {want} ({per} per prefill, none in "
                            f"decode)")
    others = {k: n for k, n in launches.items() if k not in per_prefill and n}
    if others:
        problems.append(f"{arch}: other kernels launched on its path: {others}")

    peak_mem = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in eng.params.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in eng.params.parameters())
    fam = get_family(cfg)
    probe = torch.as_tensor(prompts[N_REQUESTS // 2][None].astype(np.int64),
                            device=dev)
    stubs = stub_inputs(cfg, dev, seed)

    def last_logits(c, dtype=torch.bfloat16, decode_timing=None):
        """Last-token prefill logits of the probe (the prefill timed alone);
        with ``decode_timing`` (a dict), its decode timed and profiled."""
        cache = fam.init_cache(c, 1, SERVE_MAX_LEN, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = fam.prefill(eng.params, c, {"tokens": probe, **stubs}, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if decode_timing is not None:
            first = out[:, -1:].argmax(-1)

            def decode(n):
                t = first
                for _ in range(n):
                    o, _ = fam.decode_step(eng.params, c, t, cache)
                    t = o[:, -1:].argmax(-1)

            decode(2)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(NEW_TOKENS)
            torch.cuda.synchronize()
            per_token = (time.perf_counter() - t0) / NEW_TOKENS
            decode_timing["decode_s_per_token"] = per_token
            if profile:
                decode_timing.update(decode_device_time(
                    lambda: decode(NEW_TOKENS), NEW_TOKENS, per_token))
        return out[0, -1].float(), prefill_s

    timing, logits = {}, {}
    with torch.no_grad():
        # as served (bf16), each path timed alone
        for use_flash in (True, False):
            logits[use_flash], t = last_logits(
                cfg.replace(use_flash=use_flash),
                decode_timing=timing if use_flash else None)
            timing[f"prefill_{probe_len}_s_{'flash' if use_flash else 'plain'}"] = t
        # the same weights in float32, where rounding-order differences stay
        # small through the model's depth
        eng.params.float()
        before = build.launch_counts()
        logits32 = {uf: last_logits(cfg.replace(use_flash=uf, dtype="float32"),
                                    dtype=torch.float32)[0] for uf in (True, False)}
        f32_launches = launches_since(build, before)
        window = None
        if cfg.window and WINDOW_GATE_S > cfg.window:
            window, window_launches, more = window_gate(
                eng.params, cfg, per_prefill, build, dev, seed)
            problems += more
    agree = {"flash_vs_plain_rel_l2_f32": rel_l2(logits32[True], logits32[False]),
             "flash_vs_plain_rel_l2_bf16": rel_l2(logits[True], logits[False]),
             "flash_bf16_vs_plain_f32_rel_l2": rel_l2(logits[True], logits32[False]),
             "plain_bf16_vs_plain_f32_rel_l2": rel_l2(logits[False], logits32[False])}
    flash_err = agree["flash_bf16_vs_plain_f32_rel_l2"]
    plain_err = agree["plain_bf16_vs_plain_f32_rel_l2"]
    agree["bf16_error_ratio"] = flash_err / plain_err if plain_err else None
    finite = all(bool(torch.isfinite(t).all())
                 for t in (*logits.values(), *logits32.values()))
    if not (finite and agree["flash_vs_plain_rel_l2_f32"] <= F32_LIMIT[arch]
            and flash_err <= BF16_RATIO * plain_err):
        problems.append(f"{arch}: flash vs plain prefill logits {agree} against "
                        f"limits {F32_LIMIT[arch]} (float32) and ratio "
                        f"{BF16_RATIO} (bf16), finite {finite}")
    if f32_launches != per_prefill:
        problems.append(f"{arch}: the float32 gate launched {f32_launches}, "
                        f"expected {per_prefill}")

    ttfts = sorted(r.t_first - r.t_submit for r in reqs)
    tokens = sum(len(r.out_tokens) for r in reqs)
    pct = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))]  # noqa: E731
    row = {"phase": "serve", "arch": arch, "family": cfg.family, "use_flash": True,
           "params": n_params, "param_bytes": param_bytes,
           "init_s": init_s, "requests": N_REQUESTS, "prompt_lens": lens.tolist(),
           "prompt_tokens": int(lens.sum()), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "ttft_p50_s": pct(ttfts, .5),
           "ttft_p95_s": pct(ttfts, .95), "launches": launches,
           "launches_per_prefill": per_prefill,
           **agree, "f32_limit": F32_LIMIT[arch], "logits_finite": finite,
           "float32_gate_launches": dict(f32_launches), **timing,
           "max_memory_allocated": peak_mem}
    if n_layers is not None:
        row["reduced"] = {"n_layers": [n_layers, full.n_layers]}
    if stubs:
        row["gate_stub_inputs"] = {k: list(v.shape) for k, v in stubs.items()}
    if window is not None:
        row["window_gate"] = window
        for k, n in window_launches.items():
            f32_launches[f"{k}:window"] = n
    del eng, logits, logits32
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches, f32_launches, problems


# --------------------------------------------------------------- phase 7
def fa_flops(b, s, h, d, window) -> float:
    """Operations of causal attention over s tokens, window included: each
    query i scores and sums min(i + 1, window) keys (2 products x 2 d)."""
    keys = s * (s + 1) / 2
    if window and window < s:
        keys = window * (window + 1) / 2 + (s - window) * window
    return 4 * b * h * d * keys


def sdpa(q, k, v, window):
    """One PyTorch call computing causal (windowed) GQA attention, on BHSD
    views: ``scaled_dot_product_attention`` with ``is_causal``, or, where
    the window bites, with a boolean (S, S) mask (j <= i) & (j > i - window)
    built here once.  Returns (the call, what it is)."""
    s, h, kv = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = {"enable_gqa": True} if h != kv else {}
    if not window or window >= s:
        return (lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa)), (
            f"torch.nn.functional.scaled_dot_product_attention(is_causal=True"
            f"{', enable_gqa=True' if gqa else ''}) on BHSD views")
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return (lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, **gqa)), (
        f"torch.nn.functional.scaled_dot_product_attention(attn_mask=(j <= i) "
        f"& (j > i - {window}) as a bool (S, S) tensor"
        f"{', enable_gqa=True' if gqa else ''}) on BHSD views")


def fa_timing(fa, ref, q, k, v, window, rates, flush):
    """K3 (causal, ``window``) on q/k/v, cold L2: its time, its plain
    version's and SDPA's (with SDPA's largest difference from the kernel),
    beside the bound."""
    bw, bf16_rate, f32_rate = rates
    rate = bf16_rate if q.dtype == torch.bfloat16 else f32_rate
    b, s, h, d = q.shape
    flops = fa_flops(b, s, h, d, window)
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ms = time_ms(lambda: fa.flash_attention(q, k, v, True, window), flush)
    bound = max(flops / rate, moved / bw) * 1e3
    library, library_name = sdpa(q, k, v, window)
    lib_err = (library().transpose(1, 2).float()
               - fa.flash_attention(q, k, v, True, window).float()).abs().max().item()
    return {"ms": ms,
            "plain_ms": time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window), flush),
            "bound_ms": bound,
            "bound_by": "operations" if flops / rate > moved / bw else "bytes",
            "share_of_bound": bound / ms,
            "flops": flops, "bytes": moved, "peak_flops": rate,
            "library_ms": time_ms(library, flush), "library": library_name,
            "library_max_abs_diff": lib_err,
            "tflops": flops / ms / 1e9}


def ssd_work(args):
    """(operations, bytes) of one SSD intra-chunk call on chunked inputs."""
    x, dA, Bm, Cm = args
    b, nc, qq, h, p = x.shape
    g_, n = Bm.shape[3], Bm.shape[4]
    tri = qq * (qq + 1) / 2
    flops = 2 * b * nc * (g_ * tri * n + h * tri * p + h * qq * n * p)
    moved = 4 * (2 * x.numel() + dA.numel() + Bm.numel() + Cm.numel()
                 + b * nc * h * n * p)
    return flops, moved


def ssd_timing(ssd, ref, args, rates, flush):
    """K4 on chunked float32 inputs, cold L2: its time and its plain
    version's beside the bound (no single PyTorch call computes it)."""
    bw, _, f32_rate = rates
    flops, moved = ssd_work(args)
    ms = time_ms(lambda: ssd.ssd_intra_chunk(*args), flush)
    bound = max(flops / f32_rate, moved / bw) * 1e3
    return {"ms": ms,
            "plain_ms": time_ms(lambda: ref.ssd_intra_chunk_ref(*args), flush),
            "bound_ms": bound,
            "bound_by": "operations" if flops / f32_rate > moved / bw else "bytes",
            "share_of_bound": bound / ms,
            "flops": flops, "bytes": moved, "peak_flops": f32_rate,
            "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD intra-chunk step",
            "tflops": flops / ms / 1e9}


def time_model_kernels(ref, fa, ssd, dev, rates, launches, errs):
    """K3 (bf16 and float32) and K4 at the serving shape (S = 2048), and, in
    ``family_shapes``, K3 bf16 and K4 at the shapes phase 6's other models
    hand them (``FA_FAMILY_CASES``, ``SSD_FAMILY_CASES``)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = []
    b, s, h, kv, d = 1, TIME_S, 24, 8, 128
    for dt in (torch.bfloat16, torch.float32):  # tensor cores, CUDA cores
        name = str(dt).removeprefix("torch.")
        out.append({
            "name": "flash_attention", "dtype": name, "route": "cuda",
            "source": source("flash_attention"),
            "replaces": REPLACES["flash_attention"],
            "launches": launches["flash_attention" if dt == torch.bfloat16
                                 else "flash_attention:float32"],
            "max_abs_err": errs["flash_attention"]["serving_shape"][name],
            "shape": f"q (1, 2048, 24, 128), k/v (1, 2048, 8, 128) {name}, causal",
            **fa_timing(fa, ref, *fa_inputs(dev, b, s, h, kv, d, dt, 7), 0,
                        rates, flush)})
    out.append({
        "name": "ssd_intra_chunk", "dtype": "float32", "route": "cuda",
        "source": source("ssd_intra_chunk"),
        "replaces": REPLACES["ssd_intra_chunk"],
        "launches": launches["ssd_intra_chunk"],
        "max_abs_err": errs["ssd_intra_chunk"]["max_abs_err_serving_shape"],
        "shape": "x (1, 8, 256, 80, 64), dA (1, 8, 256, 80), B/C (1, 8, 256, 1, 128) f32",
        **ssd_timing(ssd, ref, ssd_inputs(dev, 1, TIME_S, 80, 64, 1, 128, 256, 8),
                     rates, flush)})
    out[0]["family_shapes"] = {
        label: {"shape": [b, s, h, kv, d], "window": window,
                **fa_timing(fa, ref, *fa_inputs(dev, b, s, h, kv, d, dt, 9),
                            window, rates, flush)}
        for label, (b, s, h, kv, d, dt, _, window) in FA_FAMILY_CASES.items()
        if dt == torch.bfloat16}
    out[2]["family_shapes"] = {
        label: {"shape": list(c),
                **ssd_timing(ssd, ref, ssd_inputs(dev, *c, 10), rates, flush)}
        for label, c in SSD_FAMILY_CASES.items()}
    return out


# --------------------------------------------------------------- phase 8
def evolve(rho, t):
    """One deterministic diffusion step (pure function of (state, t))."""
    lap = sum(torch.roll(rho, s, a) for a in range(3) for s in (1, -1)) - 6 * rho
    return torch.clamp(rho + 0.1 * lap + 0.01 * torch.sin(t + rho), min=0.0)


def initial_density(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return 1.0 + 0.05 * torch.randn(SHAPE, generator=g, device=dev)


def plain_recount(dev, seed):
    """The counts of phase 8 without Wilkins: the same steps in a loop."""
    rho = initial_density(dev, seed)
    counts = torch.zeros((SHAPE[0], FAULT_SNAPSHOTS), dtype=torch.int64,
                         device=dev)
    for t in range(FAULT_SNAPSHOTS):
        rho = evolve(rho, t)
        counts[:, t] = (rho > THRESHOLD).sum(dim=(1, 2))
    return counts


def fault_run(core, build, dev, seed, faults, spill_dir):
    """One run of phase 8's workflow; returns its report, reeber's counts
    (rows x snapshots, concatenated over the final instances) and what the
    tasks measured."""
    from repro_torch.core.redistribute import even_blocks

    port = [{"filename": "plt*.h5", "dsets": [{"name": "/density", "memory": 1}]}]
    cfg = {"tasks": [
        {"func": "nyx", "nprocs": 1,
         "on_failure": {"restart": {"max_retries": 3}}, "outports": port},
        {"func": "reeber", "taskCount": 2, "nprocs": 2,
         "stall_timeout_s": STALL_TIMEOUT_S,
         "on_failure": {"rescale": {"nslots": 1, "max_retries": 3}},
         "inports": [dict(port[0], redistribute=1)]},
        {"func": "viz", "nprocs": 2, "on_failure": "drop",
         "inports": [dict(port[0], io_freq=2, redistribute={"axis": 1})]},
    ]}
    lock = threading.Lock()
    got = {"calls": {"reeber": 0, "viz": 0}, "blocks": {"reeber": 0, "viz": 0},
           "ckpt_s": [], "ckpt_bytes": 0, "restored_at": None, "counts": {}}

    def nyx(comm):
        state = {"rho": initial_density(comm.device, seed),
                 "t": torch.zeros((), dtype=torch.int64)}
        restored = comm.restore(state)
        if restored is not None:
            state = restored[1]
            torch.cuda.synchronize()
            got["restored_at"] = time.monotonic()
        for t in range(int(state["t"]), FAULT_SNAPSHOTS):
            rho = evolve(state["rho"], t)
            with core.h5.File(f"plt{t:05d}.h5", "w") as f:
                f.create_dataset("/density", data=rho, copy=False)
            state = {"rho": rho, "t": torch.tensor(t + 1)}
            t0 = time.perf_counter()
            comm.checkpoint(state)
            with lock:
                got["ckpt_s"].append(time.perf_counter() - t0)
                got["ckpt_bytes"] = sum(v.numel() * v.element_size()
                                        for v in state.values())

    def reshard(comm, f):
        blocks = comm.reshard(f["/density"], prefer="pack")
        with lock:
            got["calls"][comm.task] += 1
            got["blocks"][comm.task] += sum(1 for b in blocks if b.numel())
        return blocks

    def reeber(comm):
        spec = comm.resolve_redist_spec(port="plt*.h5")
        _, (rows, _, _) = even_blocks(SHAPE, spec.nslots)[spec.slot]
        like = {"counts": torch.zeros((rows, FAULT_SNAPSHOTS), dtype=torch.int64,
                                      device=comm.device),
                "n": torch.zeros((), dtype=torch.int64)}
        state = like
        restored = comm.restore(like)
        if restored is not None:
            state = restored[1]
        counts, n = state["counts"].clone(), int(state["n"])
        while True:
            f = core.h5.File("plt*.h5", "r")
            if f is None:
                break
            blocks = reshard(comm, f)
            counts[:, n] = torch.cat([(b > THRESHOLD).sum(dim=(1, 2))
                                      for b in blocks])
            n += 1
            comm.checkpoint({"counts": counts, "n": torch.tensor(n)},
                            sharded_axes={"counts": 0})
        with lock:
            got["counts"][comm.instance] = counts

    def viz(comm):
        while True:
            f = core.h5.File("plt*.h5", "r")
            if f is None:
                break
            reshard(comm, f)

    w = core.Wilkins(cfg, {"nyx": nyx, "reeber": reeber, "viz": viz},
                     devices=[dev], spill_dir=spill_dir)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    report = w.run(timeout=300, faults=faults or None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got["launches"] = build.launch_counts(["pack_blocks", "pack_cols"])
    final = w.graph.tasks["reeber"].task_count
    got["final_instances"] = final
    counts = torch.cat([got["counts"][j] for j in range(final)])
    return report, counts, got, wall


def faults_phase(core, build, dev, seed):
    """Phase 8: the four runs and their gates; returns K1/K2's launches per
    run and the phase's summary line."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    plain = plain_recount(dev, seed)
    ref = None
    launches = {}
    problems = []
    for tag, faults in FAULT_RUNS:
        spill = tempfile.mkdtemp(prefix="wilkins_faults_")
        try:
            report, counts, got, wall = fault_run(core, build, dev, seed,
                                                  faults, spill)
        finally:
            shutil.rmtree(spill, ignore_errors=True)
        if ref is None:
            ref = counts
            if not torch.equal(counts, plain):
                problems.append("(a): counts differ from the plain recount")
        elif not torch.equal(counts, ref):
            problems.append(f"({tag}): counts differ from (a)'s")
        rescales = [(e["old_nslots"], e["new_nslots"], e["trigger"])
                    for e in report.rescales]
        want = {"b": [(2, 1, "policy")], "c": [(2, 1, "stall")]}.get(tag, [])
        if rescales != want:
            problems.append(f"({tag}): rescales {rescales}, expected {want}")
        if tag == "d" and ([e["task"] for e in report.restarts] != ["nyx"]
                           or report.dropped_tasks != [("viz", 0)]):
            problems.append(f"(d): restarts {report.restarts}, dropped "
                            f"{report.dropped_tasks}")
        k1, k2 = got["launches"]["pack_blocks"], got["launches"]["pack_cols"]
        if k1 != got["blocks"]["reeber"] or k1 <= 0:
            problems.append(f"({tag}): K1 launched {k1} times for "
                            f"{got['blocks']['reeber']} reeber blocks")
        if k2 != got["blocks"]["viz"] or k2 <= 0:
            problems.append(f"({tag}): K2 launched {k2} times for "
                            f"{got['blocks']['viz']} viz blocks")
        launches[tag] = {"pack_blocks": k1, "pack_cols": k2}
        row = {"phase": "faults_run", "run": tag, "faults": faults,
               "wall_s": wall, "wall_s_per_snapshot": wall / FAULT_SNAPSHOTS,
               "counts_equal_a": bool(torch.equal(counts, ref)),
               "halo_cells_per_snapshot": counts.sum(dim=0).tolist(),
               "checkpoints": len(got["ckpt_s"]),
               "ckpt_bytes": got["ckpt_bytes"],
               "ckpt_block_s_median": statistics.median(got["ckpt_s"]),
               "ckpt_block_s_max": max(got["ckpt_s"]),
               "reshard_calls": got["calls"], "rank_blocks": got["blocks"],
               "launches": launches[tag],
               "rescales": [{k: e[k] for k in ("old_nslots", "new_nslots",
                                               "trigger", "cut_step",
                                               "latency_s")}
                            for e in report.rescales],
               "stalls": [{k: e[k] for k in ("instance", "silent_s", "action")}
                          for e in report.stalls],
               "restarts": [e["task"] for e in report.restarts],
               "dropped": report.dropped_tasks,
               "final_reeber_instances": got["final_instances"]}
        if tag == "d" and report.restarts and got["restored_at"] is not None:
            row["restart_latency_s"] = got["restored_at"] - report.restarts[0]["t"]
        emit(row)
    summary = {"phase": "faults", "runs": [t for t, _ in FAULT_RUNS],
               "counts_equal": not any("counts" in p for p in problems),
               "plain_recount_equal": bool(torch.equal(ref, plain)),
               "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(summary)
    if problems:
        raise RuntimeError("; ".join(problems))
    return launches


# --------------------------------------------------------------- phase 9
def profiled_step(step, state, batch, wall_per_step):
    """One training step under ``torch.profiler``: its device (kernel)
    time by kernel kind, that time's share of the unprofiled wall time per
    step, and the kernels that took the most device time.  A measurement
    only: where the profiler gives no device time, it says so."""
    box = {}

    def run():
        t0 = time.perf_counter()
        box["state"], _ = step(state, batch)
        torch.cuda.synchronize()
        box["wall"] = time.perf_counter() - t0

    try:
        dev = device_kernels(run)
    except Exception as exc:  # noqa: BLE001 -- the profiler is a measurement only
        return box.get("state", state), {
            "busy_share": f"not measured: {type(exc).__name__}: {exc}"}
    state, wall = box["state"], box["wall"]
    dev_s = sum(e.self_device_time_total for e in dev) * 1e-6
    if not dev_s:
        return state, {"busy_share": "not measured: no device time in the trace"}
    by_kind = {}
    for e in dev:
        kind = kernel_kind(e.key)
        t, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (t + e.self_device_time_total * 1e-6, n + e.count)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return state, {
        "profiled_step_s": wall, "device_s_per_step": dev_s,
        "busy_share": dev_s / wall_per_step,
        "busy_share_of_profiled_step": dev_s / wall,
        "device_kernels_per_step": sum(e.count for e in dev),
        "device_s_by_kind": {k: [t, n] for k, (t, n) in
                             sorted(by_kind.items(), key=lambda kv: -kv[1][0])},
        "top_device_kernels": [[e.key[:80], e.self_device_time_total * 1e-6, e.count]
                               for e in top]}


def kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name: K3 and K4, float32 matrix
    products (the plain backward recomputes run with TF32 off), other
    matrix products (bf16), reductions, copies and gathers, elementwise."""
    n = name.lower()
    for kind, keys in (("K3 flash_attention", ("fa_tc_kernel", "fa_fwd_kernel")),
                       ("K4 ssd_intra_chunk", ("ssd_intra_chunk",)),
                       ("matmul float32", ("f32f32", "sgemm")),
                       ("matmul other", ("gemm", "nvjet", "cutlass", "xmma")),
                       ("reduction", ("reduce", "softmax", "norm")),
                       ("copy, gather, cat", ("copy", "index", "cat", "gather",
                                              "scatter")),
                       ("elementwise", ("elementwise",))):
        if any(k in n for k in keys):
            return kind
    return "other"


def train_gate(arch, kernel, build, dev, seed):
    """Phase 9 (a): the kernel path against the plain path at full width,
    2 layers, float32 weights, batch 1 x 2048: loss and every gradient."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_family
    from repro_torch.train import DataConfig, SyntheticCorpus

    base = get_config(arch).replace(n_layers=GATE_LAYERS, dtype="float32")
    fam = get_family(base)
    model = fam.init(base, torch.Generator(device=dev).manual_seed(seed), dev)
    host = SyntheticCorpus(DataConfig(vocab=base.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=GATE_BATCH, seed=seed)).batch(0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
    names, params = zip(*model.named_parameters())
    out, launched = {}, 0
    for use_flash in (True, False):
        before = build.launch_counts([kernel])[kernel]
        loss = fam.loss_fn(model, base.replace(use_flash=use_flash), batch)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        launched += build.launch_counts([kernel])[kernel] - before
        out[use_flash] = (loss.detach(), grads)
    (lk, gk), (lp, gp) = out[True], out[False]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    errs = {n: rel_l2(a, b) for n, a, b in zip(names, gk, gp)}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in (*gk, *gp))
    row = {"loss_kernel": float(lk), "loss_plain": float(lp), "loss_rel": loss_rel,
           "grad_rel_l2_max": errs[worst], "grad_rel_l2_worst_param": worst,
           "grads_finite": finite, "gate_launches": launched,
           "limits": {"loss": LOSS_LIMIT, "grad": GRAD_LIMIT}}
    problems = []
    if not (finite and loss_rel <= LOSS_LIMIT and errs[worst] <= GRAD_LIMIT):
        problems.append(f"{arch}: kernel vs plain path at {GATE_LAYERS} layers "
                        f"in float32: {row}")
    if launched != 2 * GATE_LAYERS:   # the forward and remat's recompute
        problems.append(f"{arch}: the gate's kernel path launched {kernel} "
                        f"{launched} times, expected {2 * GATE_LAYERS}")
    del model, out, gk, gp, grads
    gc.collect()
    torch.cuda.empty_cache()
    return row, problems


def train_model(arch, kernel, build, ref, dev, seed):
    """Phase 9 (b): full width and depth, bf16, remat full, use_flash: 4
    steps of make_train_step, then a fifth under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticCorpus,
                                   init_state, make_train_step)
    from repro_torch.train.optim import adamw_update

    cfg = get_config(arch).replace(use_flash=True)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device=dev).manual_seed(seed), cfg, ocfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, ocfg)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
    batches = [corpus.batch(i) for i in range(TRAIN_STEPS + 1)]

    plain_calls = {"flash_attention_ref": 0, "ssd_intra_chunk_ref": 0}
    originals = {n: getattr(ref, n) for n in plain_calls}

    def counting(n):
        def fn(*a, **kw):
            plain_calls[n] += 1
            return originals[n](*a, **kw)
        return fn

    for n in plain_calls:
        setattr(ref, n, counting(n))
    losses, gnorms, step_s = [], [], []
    try:
        build.reset_launch_counts()
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = build.launch_counts()
    finally:
        for n, f in originals.items():
            setattr(ref, n, f)
    peak_mem = torch.cuda.max_memory_allocated(dev)
    steady = statistics.mean(step_s[1:])
    state, prof = profiled_step(step, state, batches[TRAIN_STEPS], steady)

    model = state.params
    # the optimizer's share of a step: one more update, on zero gradients
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adamw_update(model, zeros, state.opt, ocfg)
    torch.cuda.synchronize()
    optimizer_s = time.perf_counter() - t0
    del zeros
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    want = TRAIN_STEPS * 2 * cfg.n_layers
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"{arch}: losses {losses}: not all finite, or the "
                        f"{TRAIN_STEPS}th not below the first")
    if launches.get(kernel, 0) != want:
        problems.append(f"{arch}: {kernel} launched {launches.get(kernel, 0)} "
                        f"times in {TRAIN_STEPS} steps, expected {want} "
                        f"(2 per layer per step: forward and recompute)")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    if others or any(plain_calls.values()):
        problems.append(f"{arch}: other kernels {others} or plain versions "
                        f"{plain_calls} ran on the training path")
    row = {"phase": "train", "arch": arch, "dtype": cfg.dtype, "remat": cfg.remat,
           "use_flash": True, "params": n_params,
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "moment_bytes": sum(t.numel() * t.element_size()
                               for t in (*state.opt.m.values(), *state.opt.v.values())),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "lr": ocfg.lr, "init_s": init_s, "losses": losses, "grad_norms": gnorms,
           "step_s": step_s, "s_per_step": steady, "tokens_per_s": tokens / steady,
           "first_step_s": step_s[0], "optimizer_s": optimizer_s,
           "launches": launches,
           "launches_expected": want, "plain_calls": plain_calls,
           "max_memory_allocated": peak_mem, **prof}
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches, problems


def function_grads(ops, dev):
    """Phase 9 (c): each autograd Function against autograd through the
    plain op on the card, gradients of sum(out^2), float32: the largest
    error over each gradient's tolerance (2e-4 relative, and absolute on
    the scale of its largest entry)."""
    from repro_torch.kernels import ref
    from repro_torch.models.ssm import ssd_chunked

    def share(got, want):
        worst = 0.0
        for g, w in zip(got, want):
            lim = FN_GRAD_TOL * (max(1.0, w.abs().max().item()) + w.abs())
            worst = max(worst, ((g - w).abs() / lim).max().item())
        return worst

    def grads(fn, ins):
        xs = [t.clone().requires_grad_() for t in ins]
        out = fn(*xs)
        out = out[0] if isinstance(out, tuple) else out
        return torch.autograd.grad((out ** 2).sum(), xs)

    res = {}
    q, k, v = fa_inputs(dev, 1, TIME_S, 24, 8, 128, torch.float32, 31)
    res["flash_attention"] = share(
        grads(lambda *a: ops.flash_attention(*a, causal=True), (q, k, v)),
        grads(lambda *a: ref.flash_attention_ref(*a, causal=True), (q, k, v)))
    gen = torch.Generator(device=dev).manual_seed(32)
    b, s, h, p, g_, n = 1, TIME_S, 80, 64, 1, 128
    ins = (torch.randn((b, s, h, p), generator=gen, device=dev),
           -torch.randn((b, s, h), generator=gen, device=dev).abs() * 0.1,
           torch.randn((b, s, g_, n), generator=gen, device=dev),
           torch.randn((b, s, g_, n), generator=gen, device=dev))
    res["ssd_intra_chunk"] = share(
        grads(lambda *a: ops.ssd_chunked_kernel(*a, chunk=256), ins),
        grads(lambda *a: ssd_chunked(*a, chunk=256), ins))
    torch.cuda.synchronize()
    bad = {k: v for k, v in res.items() if not v <= 1.0}
    if bad:
        raise RuntimeError(f"autograd Function gradients differ from the plain "
                           f"op's beyond {FN_GRAD_TOL}: {bad} (share of limit)")
    return {"share_of_limit": res, "tolerance": FN_GRAD_TOL,
            "shapes": {"flash_attention": "q (1, 2048, 24, 128), k/v (1, 2048, 8, 128) f32",
                       "ssd_intra_chunk": "x (1, 2048, 80, 64), B/C (1, 2048, 1, 128), chunk 256, f32"}}


def train_phase(build, ops, ref, dev, seed):
    """Phase 9: for each model the gate, the 4 steps and their line; then
    the Functions' gradients.  Returns each kernel's launches on its
    model's training steps."""
    t_phase = time.perf_counter()
    launches = {}
    for arch, kernel in TRAIN_ARCHS:
        gate, problems = train_gate(arch, kernel, build, dev, seed)
        row, got, more = train_model(arch, kernel, build, ref, dev, seed)
        row["gate"] = gate
        emit(row)
        if problems + more:
            raise RuntimeError("; ".join(problems + more))
        launches[kernel] = {arch: got.get(kernel, 0)}
    emit({"phase": "train_functions", **function_grads(ops, dev),
          "phase_s": time.perf_counter() - t_phase})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also take decode's device time with torch.profiler")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import repro_torch.core as core
    from repro_torch.core.datamodel import reset_transport_stats, transport_stats
    from repro_torch.core.redistribute import plan_cache, reset_plan_cache
    from repro_torch.kernels import build, ops, pack, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = smi()
    rates = peaks(name)
    libs = ["pack", "flash_attention", "ssd_scan"]
    cached = [build.library_path(n).exists() for n in libs]
    t0 = time.perf_counter()
    build.build_all(libs)
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "built": libs, "build_cached": cached})

    worst = check_kernels(ops, ref, build, dev)
    emit({"phase": "kernels", "equal_to_plain": ["pack_blocks", "pack_cols"],
          "max_abs_err": worst})

    reset_plan_cache()
    reset_transport_stats()
    build.reset_launch_counts()
    report, calls, failures, wall = workflow(core, dev, args.seed, verify=True)
    launches = build.launch_counts()
    stats = transport_stats().snapshot()
    n_calls = sum(calls.values())
    expect = {"reeber": 2 * STEPS * 2, "viz": 2 * STEPS * 2}  # instances x steps x feeding producers
    problems = []
    if failures:
        problems.append(f"blocks differ from the field: {failures[:5]}")
    if calls != expect:
        problems.append(f"reshard calls {calls}, expected {expect}")
    if stats["reshard_pack"] != n_calls or stats["reshard_numpy"] != 0:
        problems.append(f"dispatch pack={stats['reshard_pack']} "
                        f"numpy={stats['reshard_numpy']} for {n_calls} calls")
    if min(launches.get(k, 0) for k in ("pack_blocks", "pack_cols")) <= 0:
        problems.append(f"a kernel never launched on the main path: {launches}")
    emit({"phase": "main_path", "served": report.total_served,
          "reshard_calls": calls, "reshard_pack": stats["reshard_pack"],
          "reshard_numpy": stats["reshard_numpy"], "launches": launches,
          "plan_cache": plan_cache().snapshot(), "wall_s": wall,
          "blocks_equal": not failures})
    if problems:
        raise RuntimeError("; ".join(problems))

    _, _, _, wall_timed = workflow(core, dev, args.seed + 1, verify=False)
    emit({"phase": "times", "workflow_s_per_step": wall_timed / STEPS,
          "workflow_wall_s": wall_timed, "steps": STEPS,
          "field_bytes": 4 * SHAPE[0] * SHAPE[1] * SHAPE[2], "producers": N_PROD})

    errs = check_model_kernels(ops, ref, build, dev)
    emit({"phase": "kernels_model",
          "tolerance": {"flash_attention_f32": FA_TOL[torch.float32],
                        "flash_attention_bf16": FA_TOL[torch.bfloat16],
                        "ssd_intra_chunk": 2e-4},
          **errs})

    serve_launches = {}   # kernel -> {arch: launches over its 8 requests}
    gate_launches = {}    # kernel (":window": zamba2's window gate) -> {arch: n}
    for arch, per_prefill, lens, probe_len, n_layers in SERVE_MODELS:
        row, served, f32, problems = serve_model(
            arch, per_prefill, lens, probe_len, n_layers, build, dev, args.seed,
            args.profile)
        for k in per_prefill:
            serve_launches.setdefault(k, {})[arch] = served.get(k, 0)
        for k, n in f32.items():
            gate_launches.setdefault(k, {})[arch] = n
        emit(row)
        if problems:
            raise RuntimeError("; ".join(problems))
    for k, by_arch in serve_launches.items():
        launches[k] = sum(by_arch.values())
    launches["flash_attention:float32"] = sum(
        n for k in ("flash_attention", "flash_attention:window")
        for n in gate_launches.get(k, {}).values())

    faults_launches = faults_phase(core, build, dev, args.seed)
    train_launches = train_phase(build, ops, ref, dev, args.seed)

    kernels = time_kernels(pack, ops, ref, dev, rates[0], launches, STEPS, worst)
    for k in kernels:
        k["launches_faults"] = {run: n[k["name"]]
                                for run, n in faults_launches.items()}
    kernels += time_model_kernels(ref, fa, ssd, dev, rates, launches, errs)
    for k in kernels[2:]:  # K3 bf16 and K4: phase 6's requests; K3 float32: its gates
        if k["name"] == "flash_attention" and k["dtype"] == "float32":
            k["launches_by_arch"] = {
                "float32 gates": gate_launches.get("flash_attention", {}),
                "window gate": gate_launches.get("flash_attention:window", {})}
        else:
            k["launches_by_arch"] = serve_launches.get(k["name"], {})
            k["launches_float32_gates"] = {
                "float32 gates": gate_launches.get(k["name"], {}),
                "window gate": gate_launches.get(f"{k['name']}:window", {})}
    for k in kernels:   # training runs K3 in bf16 only
        on_path = k["name"] == "ssd_intra_chunk" or (
            k["name"] == "flash_attention" and k["dtype"] == "bfloat16")
        k["launches_train"] = (train_launches[k["name"]] if on_path
                               else {arch: 0 for arch, _ in TRAIN_ARCHS})
    emit({"phase": "run", "run_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
