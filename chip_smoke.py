"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA pack kernels from ``src/repro_torch/kernels/csrc`` and then,
each phase printing one JSON line and any failure exiting non-zero:

1. device -- the card (``nvidia-smi`` name and power limit) and the build time
   (near zero when a build of the same source and flags is already there);
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
4. times -- each kernel at the shapes of phase 3 (CUDA events, cold L2) beside
   its bandwidth bound, its plain version and ``torch.index_select`` on the
   tiled view, plus the workflow's wall time per timestep.

The second-to-last lines are the per-kernel summary and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Without
CUDA, or without the repository beside it, the script exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
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
# peak memory bandwidth, bytes/s (NVIDIA data sheets), by device name
PEAK_BW = (("H100 80GB HBM3", 3.35e12), ("H100 SXM", 3.35e12),
           ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H200", 4.8e12))
REPLACES = {"pack_blocks": "src/repro/kernels/pack.py:37",
            "pack_cols": "src/repro/kernels/pack.py:74"}
KERNEL_SRC = "src/repro_torch/kernels/csrc/pack.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def peak_bandwidth(name: str) -> float:
    for key, bw in PEAK_BW:
        if key in name:
            return bw
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


# --------------------------------------------------------------- phase 2
def check_kernels(ops, ref, pack, dev) -> float:
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
        before = pack.launch_counts()[name]
        got = fn(src, offs, tile)
        torch.cuda.synchronize()
        if pack.launch_counts()[name] != before + 1:
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
    each (the main path finds its slab cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
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
            "name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_step": launches[name] / steps,
            "max_abs_err": worst,
            "ms": ms,
            "wrapper_ms": time_ms(lambda: wrapper(src, offs_host, tile), flush),
            "plain_ms": time_ms(lambda: plain(src, offs, tile), flush),
            "bound_ms": bound, "bound_by": "bytes", "bytes": moved,
            "library_ms": time_ms(library, flush),
            "bandwidth_gbs": moved / ms / 1e6,
        })
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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
    from repro_torch.kernels import ops, pack, ref

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = smi()
    cached = pack.library_path().exists()
    t0 = time.perf_counter()
    pack.build()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "build_cached": cached})

    worst = check_kernels(ops, ref, pack, dev)
    emit({"phase": "kernels", "equal_to_plain": ["pack_blocks", "pack_cols"],
          "max_abs_err": worst})

    reset_plan_cache()
    reset_transport_stats()
    pack.reset_launch_counts()
    report, calls, failures, wall = workflow(core, dev, args.seed, verify=True)
    launches = pack.launch_counts()
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
    if min(launches.values()) <= 0:
        problems.append(f"a kernel never launched on the main path: {launches}")
    emit({"phase": "main_path", "served": report.total_served,
          "reshard_calls": calls, "reshard_pack": stats["reshard_pack"],
          "reshard_numpy": stats["reshard_numpy"], "launches": launches,
          "plan_cache": plan_cache().snapshot(), "wall_s": wall,
          "blocks_equal": not failures})
    if problems:
        raise RuntimeError("; ".join(problems))

    _, _, _, wall_timed = workflow(core, dev, args.seed + 1, verify=False)
    kernels = time_kernels(pack, ops, ref, dev, peak_bandwidth(name), launches,
                           STEPS, worst)
    emit({"phase": "times", "workflow_s_per_step": wall_timed / STEPS,
          "workflow_wall_s": wall_timed, "steps": STEPS,
          "field_bytes": 4 * SHAPE[0] * SHAPE[1] * SHAPE[2], "producers": N_PROD})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
