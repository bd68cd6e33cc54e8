"""Where K4's time goes on the card: a traced build and variants of
``csrc/ssd_scan.cu`` with one part changed, timed in turns.

    python3 tools/k4_probe.py             # on a machine with the card

Builds, beside the kernel of this checkout (``base``), copies of its
source with textual edits (``VARIANTS``; each edit must match the source
once or more, or the script stops), and prints:

- ``ident``: S = C B^T alone, through y with x the identity and dA = 0
  (y = the lower triangle of S), against float64, at N = 64 and 128;
- ``trace``: per block kind at mamba2-2.7b's serving shape, the mean
  microseconds of each phase from ``%globaltimer`` stamps (start, S or
  B^T built, the sums ready, the units done, the end, the time consumer 0
  waited for x tiles) and the SMs' busy share of the kernel's span;
- ``time``: each variant's median time (cold L2, as ``chip_smoke.py``'s
  phase 7) at that shape, in turns.  Variants with parts removed compute
  wrong results; they only time.

A tool for reworking the kernel, not a check: ``chip_smoke.py`` holds the
kernel to its plain version.  It needs ``nvcc`` and one card.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

SHAPE = (1, 2048, 80, 64, 1, 128, 256)   # mamba2-2.7b serving: (B, S, H, P, G, N, chunk)
ONLY_STATE = [("  const int tid = threadIdx.x;\n",
               "  const int tid = threadIdx.x;\n  if (is_y) return;\n")]
VARIANTS = {
    # the state blocks alone, then without their wgmma
    "state blocks": ONLY_STATE,
    "state blocks, no wgmma": ONLY_STATE + [
        ("        mma3<4>(d, ah[0], al[0], bh, bl, 0);\n",
         "        d[0] = __uint_as_float(ah[0][0][0] ^ al[0][3][3]);\n"),
        ("        mma3<4, false>(d, ah[1], al[1], bh, bl, 4);\n",
         "        d[1] = __uint_as_float(ah[1][0][0] ^ al[1][3][3]);\n")],
    # y blocks without forming (S o L)
    "no (S o L)": [("        if (is_y) form(0);", "        if (false) form(0);"),
                   ("          form(1);\n", "          if (false) form(1);\n")],
    # the split by cvt.rna.tf32.f32 instead of two integer operations
    "cvt.rna": [('#include "hopper.cuh"\n', '#include "hopper.cuh"\n'
                 '__device__ __forceinline__ float cvt_rna(float a) { uint32_t r; '
                 'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a)); return __uint_as_float(r); }\n'),
                ("wlk::split_tf32(", "split_cvt(")] + [
                ("namespace {\n", "namespace {\n__device__ __forceinline__ void split_cvt(float a, uint32_t& hi, "
                 "uint32_t& lo) { const float h = cvt_rna(a); hi = __float_as_uint(h); "
                 "lo = __float_as_uint(cvt_rna(a - h)); }\n")],
    # no register moves between the warpgroups: 168 each
    "168 registers each": [("kProducerRegs = 56, kConsumerRegs = 224",
                            "kProducerRegs = 168, kConsumerRegs = 168")],
}
TRACE = [
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n'
     '__device__ unsigned long long g_trace[8192][8];\n'
     '__device__ __forceinline__ unsigned long long gt() { unsigned long long t; '
     'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }\n'),
    ("  const int mrow = 16 * wq + 2 * (lane / 4);       // fragment row pair\n",
     "  const int mrow = 16 * wq + 2 * (lane / 4);       // fragment row pair\n"
     "  unsigned long long xw = 0;\n  if (t256 == 0) { g_trace[blockIdx.x][0] = gt(); "
     "unsigned smid; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid)); "
     "g_trace[blockIdx.x][7] = smid; }\n"),
    ("    wlk::named_sync(1, 256);  // S or B^T complete\n",
     "    wlk::named_sync(1, 256);  // S or B^T complete\n"
     "    if (t256 == 0 && wi == 0) g_trace[blockIdx.x][1] = gt();\n"),
    ("    wlk::named_sync(4, 352);  // the window's sums complete\n",
     "    wlk::named_sync(4, 352);  // the window's sums complete\n"
     "    if (t256 == 0 && wi == 0) g_trace[blockIdx.x][2] = gt();\n"),
    ("        wlk::mbar_wait(&bar[kXFull + slot], (sx / kXStages) & 1);\n",
     "        { unsigned long long t0_ = gt(); wlk::mbar_wait(&bar[kXFull + slot], "
     "(sx / kXStages) & 1); xw += gt() - t0_; }\n"),
    ("    xseq += nu * nj;\n", "    if (t256 == 0) g_trace[blockIdx.x][3] = gt();\n"
     "    if (t256 == 128) g_trace[blockIdx.x][4] = gt();\n    xseq += nu * nj;\n"),
    ("    if (wi + 1 < nwin) wlk::named_arrive(5, 352);\n  }\n}\n",
     "    if (wi + 1 < nwin) wlk::named_arrive(5, 352);\n  }\n"
     "  if (t256 == 0) { g_trace[blockIdx.x][5] = gt(); g_trace[blockIdx.x][6] = xw; }\n}\n"),
    ('extern "C" {\n', 'extern "C" {\nint wlk_trace(void* host) { return (int)'
     'cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)); }\n'),
]


def build_variants(tmp):
    """Every variant and the traced build, one nvcc each, started together:
    {name: ctypes library}."""
    src = build.source_path("ssd_scan").read_text()
    procs = {}
    for name, edits in {**VARIANTS, "trace": TRACE}.items():
        d = os.path.join(tmp, re.sub(r"\W+", "_", name))
        os.makedirs(d)
        shutil.copy(build.CSRC / "hopper.cuh", d)
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"k4_probe: variant {name!r} no longer matches the source: {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, "ssd_scan.cu"), "w") as f:
            f.write(text)
        procs[name] = (d, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "ssd_scan.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    ours = ssd._library()
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k4_probe: variant {name!r} does not build:\n{out}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        lib.wlk_ssd_intra_chunk.argtypes = ours.wlk_ssd_intra_chunk.argtypes
        lib.wlk_ssd_intra_chunk.restype = ours.wlk_ssd_intra_chunk.restype
        libs[name] = lib
    return libs


def run(lib, args):
    ours = ssd._library()
    ssd._lib = lib
    try:
        return ssd.ssd_intra_chunk(*args)
    finally:
        ssd._lib = ours


def ident(dev):
    """S alone, through y: x the identity on 64 rows, dA = 0."""
    for n in (64, 128):
        x = torch.zeros((1, 1, 64, 1, 64), device=dev)
        x[0, 0, torch.arange(64), 0, torch.arange(64)] = 1.0
        dA = torch.zeros((1, 1, 64, 1), device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        Bm, Cm = (torch.randn((1, 1, 64, 1, n), generator=g, device=dev)
                  for _ in range(2))
        y, _ = ssd.ssd_intra_chunk(x, dA, Bm, Cm)
        S = torch.tril(Cm[0, 0, :, 0].double() @ Bm[0, 0, :, 0].double().T)
        print(f"ident N = {n}: S's largest error {(y[0, 0, :, 0].double() - S).abs().max().item():.3e}",
              flush=True)


def trace(lib, dev):
    lib.wlk_trace.argtypes = [ctypes.c_void_p]
    args = chip_smoke.ssd_inputs(dev, *SHAPE, 5)
    for _ in range(3):
        run(lib, args)
    torch.cuda.synchronize()
    buf = np.zeros((8192, 8), np.uint64)
    if lib.wlk_trace(buf.ctypes.data_as(ctypes.c_void_p)):
        sys.exit("k4_probe: could not read the trace")
    blocks = ssd.work_list(8, 1, 80, 256, 128, 64)
    t = buf[:len(blocks)].astype(np.int64)
    t0, span = t[:, 0].min(), t[:, 5].max() - t[:, 0].min()
    busy = np.zeros(t[:, 7].max() + 1)
    np.add.at(busy, t[:, 7], t[:, 5] - t[:, 0])
    print(f"trace: span {span / 1e3:.1f} us, SMs busy {busy.sum() / (len(busy) * span):.3f}")
    kinds = sorted({(k, tile) for k, tile, *_ in blocks}, key=lambda kt: [
        (k, tile) for k, tile, *_ in blocks].index(kt))
    for kind, tile in kinds:
        rows = [i for i, b in enumerate(blocks) if b[:2] == (kind, tile)]
        b = t[rows]
        us = lambda a: round(float(np.mean(a)) / 1e3, 2)  # noqa: E731
        print(f"  {kind} {tile}: blocks {len(rows)}, S/B^T {us(b[:, 1] - b[:, 0])}, "
              f"sums wait {us(b[:, 2] - b[:, 1])}, units {us(b[:, 3] - b[:, 2])} / "
              f"{us(b[:, 4] - b[:, 2])}, total {us(b[:, 5] - b[:, 0])}, "
              f"x wait {us(b[:, 6])}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k4_probe: CUDA is not available")
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi(), flush=True)
    build.build_all(["ssd_scan"])
    ident(dev)
    with tempfile.TemporaryDirectory(prefix="k4_probe_") as tmp:
        libs = build_variants(tmp)
        trace(libs["trace"], dev)
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        args = chip_smoke.ssd_inputs(dev, *SHAPE, 5)
        order = [("base", ssd._library())] + [(n, libs[n]) for n in VARIANTS]
        ms = {n: [] for n, _ in order}
        for n, lib in order + order[::-1]:
            ms[n].append(chip_smoke.time_ms(lambda: run(lib, args), flush))
        for n, v in ms.items():
            print(f"time {n}: {v[0]:.5f} / {v[1]:.5f} ms", flush=True)


if __name__ == "__main__":
    main()
