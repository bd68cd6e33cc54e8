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
   place), and the serving shape in both dtypes; K4 with 1, 2 and 4 groups,
   head counts that leave a short head subset, P above 64, ragged S and the
   serving shape; TF32 off, so the plain versions are float32;
6. serve -- ``llama3.2-3b`` and then ``mamba2-2.7b`` at full width (random
   weights from ``--seed``, bf16) through ``repro_torch.serve.Engine`` on
   ``cuda:0`` with ``use_flash``: 8 greedy requests of 16 new tokens, prompts
   of 256-2048 tokens (one of 1000), 4 slots.  Every request must finish, and
   the prefills must launch K3 8 x 28 and K4 8 x 64 times exactly (decode
   reaches no kernel).  One request's last-token prefill logits are held
   twice: on a float32 copy of the weights the kernel path must agree with
   the plain path within a limit per model (``F32_LIMIT``); as served in
   bf16, the kernel path's distance from the float32 plain logits must stay
   within ``BF16_RATIO`` times the bf16 plain path's own (64 bf16 layers of
   random weights amplify rounding-order differences, so a fixed bf16 limit
   would hold nothing).  Launch counts are set to 0 just before each model's
   requests and read just after; prefill and decode are timed alone, and
   with ``--profile`` decode's device time is taken with ``torch.profiler``;
7. the per-kernel line -- K1 and K2 at the shapes of phase 3, K3 (bf16, and
   float32 as a second entry) and K4 at the serving shape (S = 2048): CUDA
   events with a cold L2, beside the bound (the larger of bytes over the
   memory rate and operations over the peak rate of their type) and its
   share of the kernel's time, the plain version and one PyTorch call
   computing the same function where there is one.  ``launches`` is the
   count on the path: phase 3 for K1/K2, phase 6's requests for K3 bf16 and
   K4, phase 6's float32 logits gate for K3 float32.

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
# phase 6: two models at full width, one after the other
SERVE_ARCHS = (("llama3.2-3b", "flash_attention"), ("mamba2-2.7b", "ssd_intra_chunk"))
N_REQUESTS = 8
NEW_TOKENS = 16
PROMPT_LENS = (256, 2048)    # drawn from the seed
PROBE_LEN = 1000             # one prompt's length, and the flash-vs-plain probe
SERVE_SLOTS = 4
SERVE_MAX_LEN = 4096
# phase 6 gates: kernel path vs plain path on float32 weights, per model (about
# 25x and 8x the readings of 3.8e-6 and 2.5e-4 on the H100), and, as served in
# bf16, the kernel path's error against the float32 plain logits over the bf16
# plain path's error against them
F32_LIMIT = {"llama3.2-3b": 1e-4, "mamba2-2.7b": 2e-3}
BF16_RATIO = 2.0
TIME_S = 2048                # serving shape at which K3 and K4 are timed


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
]
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
]


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
                               "serving_shape": {}},
           "ssd_intra_chunk": {"cases": 0, "max_abs_err": 0.0}}
    cases = [(c, False) for c in FA_CASES] + [
        ((b, s, h, kv, d, torch.bfloat16, causal, 0), True)
        for b, s, h, kv, d, causal in FA_FUSED_CASES]
    for i, ((b, s, h, kv, d, dt, causal, window), fused) in enumerate(cases):
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
        if s == TIME_S:
            r["serving_shape"][str(dt).removeprefix("torch.")] = err
    for i, (b, s, h, p, g_, n, chunk) in enumerate(SSD_CASES):
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
        if s == TIME_S:
            r["max_abs_err_serving_shape"] = err
    return res


# --------------------------------------------------------------- phase 6
def decode_device_time(fn, n, wall_per_token):
    """Device (kernel) time per token of ``fn`` under ``torch.profiler``,
    and its share of the unprofiled wall time per token.  A measurement
    only: where the profiler gives no device time, it says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA)
        launches = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    except Exception as exc:  # noqa: BLE001 -- the profiler is untried on this card
        return {"decode_device_time": f"not measured: {type(exc).__name__}: {exc}"}
    if not dev_us:
        return {"decode_device_time": "not measured: no device time in the trace"}
    per_token = dev_us * 1e-6 / n
    return {"decode_device_s_per_token": per_token,
            "decode_device_busy_share": per_token / wall_per_token,
            "decode_kernels_per_token": launches / n}


def serve_model(arch, kernel, build, dev, seed, profile):
    """One model at full width through the port's Engine; returns its
    metrics and the launches of every kernel during its requests."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_family
    from repro_torch.serve import Engine, Request, ServeConfig

    cfg = get_config(arch).replace(use_flash=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, ServeConfig(max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN),
                 device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=N_REQUESTS)
    lens[N_REQUESTS // 2] = PROBE_LEN
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
    want = N_REQUESTS * cfg.n_layers
    if launches.get(kernel, 0) != want:
        problems.append(f"{arch}: {kernel} launched {launches.get(kernel, 0)} "
                        f"times, expected {want} (one per layer per prefill)")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    if others:
        problems.append(f"{arch}: other kernels launched on its path: {others}")

    peak_mem = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in eng.params.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in eng.params.parameters())
    fam = get_family(cfg)
    probe = torch.as_tensor(prompts[N_REQUESTS // 2][None].astype(np.int64),
                            device=dev)

    def last_logits(c, dtype=torch.bfloat16, decode_timing=None):
        """Last-token prefill logits of the probe (the prefill timed alone);
        with ``decode_timing`` (a dict), its decode timed and profiled."""
        cache = fam.init_cache(c, 1, SERVE_MAX_LEN, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = fam.prefill(eng.params, c, {"tokens": probe}, cache)
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

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    timing, logits = {}, {}
    with torch.no_grad():
        # as served (bf16), each path timed alone
        for use_flash in (True, False):
            logits[use_flash], t = last_logits(
                cfg.replace(use_flash=use_flash),
                decode_timing=timing if use_flash else None)
            timing[f"prefill_{PROBE_LEN}_s_{'flash' if use_flash else 'plain'}"] = t
        # the same weights in float32, where rounding-order differences stay
        # small through the model's depth
        eng.params.float()
        before = build.launch_counts([kernel])[kernel]
        logits32 = {uf: last_logits(cfg.replace(use_flash=uf, dtype="float32"),
                                    dtype=torch.float32)[0] for uf in (True, False)}
        f32_launches = build.launch_counts([kernel])[kernel] - before
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

    ttfts = sorted(r.t_first - r.t_submit for r in reqs)
    tokens = sum(len(r.out_tokens) for r in reqs)
    pct = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))]  # noqa: E731
    row = {"phase": "serve", "arch": arch, "use_flash": True,
           "params": n_params, "param_bytes": param_bytes,
           "init_s": init_s, "requests": N_REQUESTS, "prompt_lens": lens.tolist(),
           "prompt_tokens": int(lens.sum()), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "ttft_p50_s": pct(ttfts, .5),
           "ttft_p95_s": pct(ttfts, .95), "launches": launches,
           **agree, "logits_finite": finite, "float32_gate_launches": f32_launches,
           **timing,
           "max_memory_allocated": peak_mem}
    del eng, logits, logits32
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches, problems


# --------------------------------------------------------------- phase 7
def time_model_kernels(ref, fa, ssd, dev, rates, launches, errs):
    """K3 and K4 at the serving shape (S = 2048), cold L2."""
    bw, bf16_rate, f32_rate = rates
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = []

    # K3 in bf16 (tensor cores, the served path) and float32 (CUDA cores)
    b, s, h, kv, d = 1, TIME_S, 24, 8, 128
    flops = 4 * b * h * d * s * (s + 1) / 2
    for dt, rate in ((torch.bfloat16, bf16_rate), (torch.float32, f32_rate)):
        q, k, v = fa_inputs(dev, b, s, h, kv, d, dt, 7)
        moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        name = str(dt).removeprefix("torch.")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, True, 0), flush)
        bound = max(flops / rate, moved / bw) * 1e3
        out.append({
            "name": "flash_attention", "dtype": name, "route": "cuda",
            "source": source("flash_attention"),
            "replaces": REPLACES["flash_attention"],
            "launches": launches["flash_attention" if dt == torch.bfloat16
                                 else "flash_attention:float32"],
            "max_abs_err": errs["flash_attention"]["serving_shape"][name],
            "shape": f"q (1, 2048, 24, 128), k/v (1, 2048, 8, 128) {name}, causal",
            "ms": ms,
            "plain_ms": time_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=True), flush),
            "bound_ms": bound,
            "bound_by": "operations" if flops / rate > moved / bw else "bytes",
            "share_of_bound": bound / ms,
            "flops": flops, "bytes": moved, "peak_flops": rate,
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True), flush),
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True) on BHSD views",
            "tflops": flops / ms / 1e9,
        })

    b, h, p, g_, n, chunk = 1, 80, 64, 1, 128, 256
    args = ssd_inputs(dev, b, TIME_S, h, p, g_, n, chunk, 8)
    nc, qq = args[0].shape[1], args[0].shape[2]
    tri = qq * (qq + 1) / 2
    flops = 2 * b * nc * (g_ * tri * n + h * tri * p + h * qq * n * p)
    moved = 4 * (2 * args[0].numel() + args[1].numel() + args[2].numel()
                 + args[3].numel() + b * nc * h * n * p)
    ms = time_ms(lambda: ssd.ssd_intra_chunk(*args), flush)
    bound = max(flops / f32_rate, moved / bw) * 1e3
    out.append({
        "name": "ssd_intra_chunk", "dtype": "float32", "route": "cuda",
        "source": source("ssd_intra_chunk"),
        "replaces": REPLACES["ssd_intra_chunk"],
        "launches": launches["ssd_intra_chunk"],
        "max_abs_err": errs["ssd_intra_chunk"]["max_abs_err_serving_shape"],
        "shape": "x (1, 8, 256, 80, 64), dA (1, 8, 256, 80), B/C (1, 8, 256, 1, 128) f32",
        "ms": ms,
        "plain_ms": time_ms(lambda: ref.ssd_intra_chunk_ref(*args), flush),
        "bound_ms": bound,
        "bound_by": "operations" if flops / f32_rate > moved / bw else "bytes",
        "share_of_bound": bound / ms,
        "flops": flops, "bytes": moved, "peak_flops": f32_rate,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD intra-chunk step",
        "tflops": flops / ms / 1e9,
    })
    return out


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

    for arch, kernel in SERVE_ARCHS:
        row, served, problems = serve_model(arch, kernel, build, dev, args.seed,
                                            args.profile)
        launches[kernel] = served.get(kernel, 0)
        launches[f"{kernel}:float32"] = row["float32_gate_launches"]
        emit(row)
        if problems:
            raise RuntimeError("; ".join(problems))

    kernels = time_kernels(pack, ops, ref, dev, rates[0], launches, STEPS, worst)
    kernels += time_model_kernels(ref, fa, ssd, dev, rates, launches, errs)
    emit({"phase": "run", "run_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
