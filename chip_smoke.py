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
   phi3.5-moe's 32/8, whisper's decoder at 448, and phase 9's training
   shapes of those four at batch 2); K4 with 1, 2 and 4
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
   run of phase 8 (``launches_faults``), K3 and K4 in phase 9 by part and
   model (``launches_train``: the bf16 steps, the float32 gates, the
   accumulation runs, the resume), K3 float32 in phase 14 (b)'s forward
   (``launches_parallel``) and in phase 16 (``launches_insitu``);
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
9. train -- six models trained one after the other with
   ``repro_torch.train`` on ``cuda:0`` (``TRAIN_ARCHS``): llama3.2-3b,
   mamba2-2.7b, zamba2-2.7b (K3 with its 4096 window and K4 in one step),
   whisper-base (K3 in the decoder; ``frames`` from the seed),
   phi3.5-moe-42b-a6.6b and internvl2-76b (256 seeded ``vision_embeds``),
   the last two cut to 4 of their 32 and 80 layers; K3 and K4 under
   autograd (their forward the kernel, their backward a plain
   recompute).  (a) A gradient gate at full width on float32 weights,
   batch 1: 2 layers (zamba2 6, one whole shared-block group; whisper 448
   tokens, the others 2048), and for zamba2 (a') the same at 6144 tokens,
   past its window: the kernel path's loss within 1e-5 and every
   parameter's gradient within 1e-4 (relative L2) of the plain path's,
   each kernel launched as ``step_launches`` counts it from the config
   (twice per layer under ``remat``: the forward and the recompute;
   zamba2's K3 once per shared-block group, which runs outside
   ``remat``; whisper's decoder only) and none on the plain path.  (b) The
   layers kept, bf16, remat and moment dtype as configured, ``use_flash``:
   4 steps of ``make_train_step`` on batch 2 of ``SyntheticCorpus(seed)``
   and the family's stub input, ``AdamWConfig(lr=1e-3, warmup_steps=1,
   total_steps=4)`` (lr 0.1 / d_model for phi3.5-moe and internvl2,
   ``TRAIN_LR``);
   every loss finite, the 4th below the 1st, each kernel
   launched exactly 4 x ``step_launches`` (counts set to 0 just before the
   4 steps and read just after), no plain K3 (causal) or K4 call, peak
   memory below 80 GB.  Printed per model: seconds per step, tokens/s,
   peak device memory, and, from a fifth step taken under
   ``torch.profiler``, the device time per step by kernel kind and its
   share of the unprofiled step's wall time (the busy share), and the
   wall time of one more AdamW update (on zero gradients).  (d) For
   mamba2 (``accum_steps=2``, and with ``compress_grads``) and llama
   (``accum_steps=2``; compression would need about 80 GB): one plain step
   and one step of each variant from the same seeded state on the same
   batch, in float32 at full width and the gate's depth against the
   tolerances of ``tests/test_train.py`` (accumulation: loss 1e-4, every
   weight within 5e-4 + 5e-3 |w| of the plain step's; compression: within
   0.05 x max(global norm, 1) of accumulation's), and in bf16 at full
   depth with its seconds, peak memory and the same differences recorded;
   ``train_accum`` lines.  (e) ``repro_torch.launch.train``'s checkpoint
   resume, llama3.2-3b at full width and 2 layers, 4 steps of 2 x 2048
   (``RESUME_ARGS``): (A) uninterrupted, (B) with a checkpoint every 2
   steps, stopped after step 2 as a preempted job is, (C) on (B)'s
   directory (about 10 GB a checkpoint, so (A) writes none and (C) only
   its last); (C) restores (B)'s step-2 state bit for bit
   and its losses of steps 3-4 equal (A)'s within 1e-5; every
   ``train_state_to_reference`` copy timed (``train_resume``).  (c) Each
   autograd Function's gradients of sum(out^2) against autograd through
   the plain op on the card at 2e-4 in float32 (``FN_CASES``): K3 at the
   serving shape and at zamba2's window gate (1 x 6144 x 32/32 x 80,
   window 4096; its forward and its backward recompute timed), K4 at
   mamba's and zamba2's SSD shapes;
10. ensemble -- ``examples/torch_nucleation_ensemble.py``'s own ``run`` on
   ``cuda:0``: 8 ``freeze`` x 8 ``detector`` instances (``nwriters: 1``,
   stateless detectors relaunched per snapshot) of 4096 atoms for 10
   steps, then 1 instance at the same size.  Gates: every (instance, step)
   reached its own instance's detector exactly once, every nucleated count
   equals a plain recount (the same generators replayed through
   ``md_step`` in a loop on the card, compared exactly), every detector
   input on the card.  Printed: wall per step at 8 and at 1 instance, their
   ratio (recorded, not gated: the instances share one card and one
   interpreter) and peak memory;
11. scheduler -- ``examples/torch_cosmology_scheduler.py``'s ``run`` on
   ``cuda:0`` at the 256^3 field of phase 3, 12 snapshots (``policy:
   fair``, reeber ``weight: 3`` with ``autotune: {min: 1, max: 4}``,
   spectrum ``weight: 1``).  Gates: both consumers analysed 12 of 12,
   every halo count and mean density equal to a plain recount of the same
   field on the card, a telemetry timeline with at least one sample,
   reeber's final depth in [1, 4], every payload on the card.  Printed:
   wall per snapshot, each edge's prefetch hits and misses (its preps) and
   blocked seconds, the final depths and ``transport_stats()`` copies and
   bytes;
12. analysis -- in fresh interpreters that import no JAX: ``python -m
   repro_torch.analysis check`` on the workflow documents of phases 3, 8,
   10 and 11 (no error-level finding), ``lint`` on the port's core, and
   ``plancheck.verify_plan`` over every plan the plan cache held after
   phases 3 and 11 (the plans whose tiles K1/K2 ran), rebuilt from their
   keys and held to the same transfers: zero findings on the dst ranks each
   plan ran.  A plan that reshards a received slab runs only the ranks
   inside the slab, so its other ranks are left out of the gate (the
   verifier reports them as never written, in both packages) and their
   findings are printed as ``findings_unrun_ranks``;
13. explore -- three fresh interpreters at once: ``python -m
   repro_torch.analysis explore --json`` with the scenarios' payloads
   (``torch.int32`` tensors adopted in place) on ``cuda:0``, the same with
   ``--device cpu``, and the port's seeded races
   (``tests/analysis_fixtures/races_torch/``, the tensor-view race on the
   card).  Gates: every scenario's (schedules, pruned, steps) equal on
   both devices and to ``EXPLORE_COUNTS``, the JAX package's counts for
   its corpus with device payloads adopted in place; zero findings; each
   race found with its code and schedule ID (``RACE_IDS``, the JAX
   package's for the five races both carry).  Printed: each run's wall;
14. parallel -- a world-size-1 NCCL group and a (1, 1) ``("data",
   "model")`` host mesh on ``cuda:0`` under ``RULE_VARIANTS["moe_a2a"]``:
   (a) one phi3.5-moe MoE layer at full width (d 4096, 16 experts, top-2,
   f 6400), float32 weights (5.0 GB), ``capacity_factor`` 8.0 (nothing
   dropped), 2 x 2048 tokens through the expert-parallel schedule: one
   call of it, its output within 2e-4 and its gradients within 5e-4 /
   5e-3 of ``moe_dense``'s; (b) phi3.5-moe at full width and 2 of 32
   layers, float32, ``use_flash``, ``moe_dispatch="a2a"``: logits within
   1e-4 relative L2 of ``"dense"``'s, 2 schedule calls and 2 K3 launches
   in the forward (counts set to 0 just before it, read just after);
   (c) ``repro_torch.launch.train``'s ``main``, 2 steps of llama3.2-3b at
   full width and 2 layers, batch 2 x 2048, through the host mesh and
   ``shard_batch``: its losses within 1e-5 of the same steps of the
   trainer with no mesh.  Printed: each part's seconds and peak memory;
15. dryrun -- the sharded dry run (``repro_torch.launch.dryrun``).  (a)
   Five production cells at once, one fresh interpreter each, with
   ``--device cuda`` (fake tensors on the card, a ``fake`` group of 256
   or 512 ranks): llama3.2-3b train_4k on the pod mesh, the same with
   ``--variant wg``, mamba2-2.7b prefill_32k on the multipod mesh,
   phi3.5-moe decode_32k with ``--variant moe_a2a`` and zamba2-2.7b
   long_500k (batch 1, replicated).  Gates: each exits 0 with ``ok``,
   records collectives, its roofline FLOPs and bytes equal the port's
   ``analytic_stats`` for the cell, and ``wg`` makes more all-gather calls
   than the baseline (a gather of each weight before its use).  Printed per cell: trace seconds, rank 0's
   peak bytes beside the card's 80 GB, collective bytes by kind, and the
   roofline times and bottleneck at the H100's rates.  (b) llama3.2-3b at
   full width and depth in bf16, one 2048-token prefill on a world-size-1
   NCCL group and a (1, 1) mesh, traced as (a) traces a cell and then run
   for real on the same placed arguments: predicted peak bytes over the
   measured ``max_memory_allocated`` within [0.5, 2.0], logits equal to
   the plain single-device prefill's bit for bit.  No kernel lies on the
   dry run's path (no config sets ``use_flash``), in the reference or here;
   (b)'s real run counts the launches (``launches_dryrun``);
16. insitu -- ``examples/torch_train_insitu_eval.py``'s ``run`` on
   ``cuda:0`` with ``--preset 100m`` (a 114M-parameter dense model in
   float32, 300 steps of 8 x 128 tokens, a snapshot of every weight each
   10 steps to an evaluator behind ``latest`` flow control; K3 under
   autograd in the trainer and its forward in the evaluator).  Gates: at
   least one snapshot scored, every scored snapshot's tensors equal bit
   for bit to the copy the trainer took at its write, the held-out loss
   not diverging, the report's dropped count equal to the snapshots
   written less those scored, K3 launched.  Printed: wall time, steps/s,
   written, scored and dropped snapshots, peak memory;
17. trace -- phase 3's workflow with the tracing layer on
   (``Wilkins.run(trace=PATH)``).  Untraced and traced runs alternate, 10
   of each (``verify=False``, as phase 4), for the wall per timestep and
   the host garbage collector's seconds in each run; the untraced ones
   must create no ``SpanRecorder`` (``obs.recorder.created_count()``), and
   none may be alive after them.  Then one traced run with ``verify=True``: every
   block equal to the field, K1 and K2 launched exactly as in phase 3
   (counts set to 0 just before it, read just after), spans covering
   ``vol``, ``channel`` and ``reshard``, each instance's attribution
   buckets summing to its window within 1e-9 s, exporting the loaded trace
   giving the same document, and ``python -m repro_torch.obs report PATH
   --json`` in a fresh interpreter (``-X importtime``: no JAX and no JAX
   package imported) giving the attribution of the trace it reads, which
   is the run's own within the export's 1 ns rounding.  Printed: the walls
   and their medians' ratio (recorded, not gated), each instance's buckets,
   the critical instance's per-step buckets, each edge's blocked and prep
   seconds.  The spans carry host timestamps: a ``reshard`` span holds K1's
   or K2's launch, not its run on the card;
18. traced_example -- ``examples/torch_cosmology_traced.py``'s ``run`` at
   256^3 float64 (a seeded field) and 6 snapshots, crash-free and traced
   with ``reeber[1]`` crashing at recv step 2: the example's acceptance
   (one restart; ``vol``, ``channel``, ``prefetch``, ``reshard``,
   ``checkpoint`` and ``recovery`` spans), halo counts equal to the
   crash-free run's and to a plain recount, K1 launched once per rank block
   reeber's ``comm.reshard`` returned;
19. examples_faults -- the fault-tolerant and elastic examples' ``run`` at
   256^3 float64 and 8 snapshots: crash-free and faulted (two restarts and
   viz dropped; a policy rescale 2->1; a stall the watchdog declares at the
   example's own ``stall_timeout_s: 0.3``), every run's counts equal to a
   plain recount;
20. flowcontrol -- ``examples/torch_cosmology_flowcontrol.py``'s ``run`` at
   256^3 float32, 10 snapshots, ``io_freq: 2``, the paper's action script
   (Listing 5) written to a temporary ``action_dirs`` entry: served at
   every second close and only there, 5 served and 5 skipped, reeber
   analysing the JAX example's snapshots (``FLOW_ANALYSED``), each count
   equal to a plain recount, every payload nyx's own tensor on the card and
   no byte copied;
21. quickstart -- ``examples/torch_quickstart.py``'s ``run`` (Listing 1,
   N = 1,000,000, 5 timesteps): consumer1's total 10, consumer2 run with
   data once per timestep (a stateless consumer, relaunched), every
   received tensor sharing the producer's storage, no byte copied, the
   particle means equal to a plain recount of the reference's draw.
   Phases 18-21 print wall times and the kernels' launches; the per-kernel
   line carries phase 17's as ``launches_trace`` and theirs as
   ``launches_examples``.

The lines before the last are the whole run's wall time (builds included),
the per-kernel summary and the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero before printing any
result.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
SHAPE = (256, 256, 256)      # one 64 MiB float32 density field
STEPS = 8
N_PROD = 4
TILE = 8                     # tile extent along the decomposed axis
REPS = 30                    # timed launches per measurement
SPIN_CYCLES = 1_000_000      # about half a millisecond of the card's clock
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
# phase 9: training at full width, one model after the other: (arch, layers
# kept of the config's (None: all), the float32 gate's layers, tokens a
# sequence).  zamba2's gate holds one whole shared-block group (attn_every
# 6); whisper's decoder context is 448 tokens; phi3.5-moe and internvl2 keep
# 4 of their 32 and 80 layers: 5.46 and 5.52 B parameters, whose bf16
# weights and gradients and bf16 moments (their configs' opt_state_dtype)
# take about 44 GB, and about 65 GB at 6 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
GATE_LAYERS, GATE_BATCH = 2, 1
TRAIN_ARCHS = (
    ("llama3.2-3b", None, GATE_LAYERS, TRAIN_SEQ),
    ("mamba2-2.7b", None, GATE_LAYERS, TRAIN_SEQ),
    ("zamba2-2.7b", None, 6, TRAIN_SEQ),
    ("whisper-base", None, GATE_LAYERS, 448),
    ("phi3.5-moe-42b-a6.6b", 4, GATE_LAYERS, TRAIN_SEQ),
    ("internvl2-76b", 4, GATE_LAYERS, TRAIN_SEQ),
)
TRAIN_WINDOW_GATE = ("zamba2-2.7b", 6, 6144)   # (a'): past its 4096 window
# (b)'s learning rate (1 warmup step).  AdamW's first step moves every
# weight by about lr along its gradient's sign, which shifts a d-wide
# layer's outputs by about lr x d: at lr 1e-3 and 1e-4 phi3.5-moe's losses
# went 11.5, 23.3, 14.8, 35.7 and 11.5, 22.6, 14.2, 13.7 on the H100, and
# internvl2's 13.0, 60.6, 31.3, 14.7 and 13.0, 29.4, 21.6, 20.4, their
# float32 gates within 1e-7 all the while; the JAX package does the same
# (d_model 4096, 2 layers, float32, on the CPU: 11.23 then 30.68 at 1e-3
# and 18.21 at 1e-4, the port within 1e-6; at 3e-5 the loss falls).  The
# wide models take lr x d_model = 0.1
TRAIN_LR = {"phi3.5-moe-42b-a6.6b": 0.1 / 4096, "internvl2-76b": 0.1 / 8192}
TRAIN_LR_DEFAULT = 1e-3
# (d): one step with gradient accumulation (and int8 compression) after a
# plain step on the same batch.  llama's compressed step is left out: its
# float32 error buffer would take the card to about 80 GB
TRAIN_ACCUM = {"llama3.2-3b": ({"accum_steps": 2},),
               "mamba2-2.7b": ({"accum_steps": 2},
                               {"accum_steps": 2, "compress_grads": True})}
ACCUM_LOSS_RTOL = 1e-4       # tests/test_train.py::test_accum_equivalent_to_full_batch
ACCUM_TOL = (5e-4, 5e-3)     # its parameters' atol, rtol
COMPRESS_SHARE = 0.05        # ::test_compressed_grads_close_to_exact: of max(norm, 1)
# (e): launch.train's checkpoint resume, as phase 14 (c) sizes llama
RESUME_ARGS = ["--arch", "llama3.2-3b", "--n-layers", str(GATE_LAYERS),
               "--steps", "4", "--seq-len", str(TRAIN_SEQ),
               "--global-batch", str(TRAIN_BATCH), "--log-every", "1"]
# (c): the autograd Functions' gradients: K3 (B, S, H, KV, D, window), K4
# (B, S, H, P, G, N, chunk), float32
FN_CASES = {"flash_attention": {"serving": (1, TIME_S, 24, 8, 128, 0),
                                "zamba2 window": (1, 6144, 32, 32, 80, 4096)},
            "ssd_intra_chunk": {"mamba": (1, TIME_S, 80, 64, 1, 128, 256),
                                "zamba2": (1, TIME_S, 80, 64, 1, 64, 256)}}
# phase 16: the in situ train/eval example's preset
INSITU_PRESET = "100m"
LOSS_LIMIT = 1e-5            # kernel vs plain path, float32, relative
GRAD_LIMIT = 1e-4            # relative L2, every parameter
FN_GRAD_TOL = 2e-4           # each Function vs the plain op (test_kernels.py)
# phases 10 and 11: the two use cases at the field size of phase 3
ENS_INSTANCES, ENS_ATOMS, ENS_STEPS = 8, 4096, 10
SCHED_SNAPSHOTS = 12
# phase 17: untraced and traced runs of phase 3's workflow, alternated
TRACE_RUNS = 10
TRACE_LAYERS = {"vol", "channel", "reshard"}
# phases 18-21: the five example workflows at phase 3's field size
TRACED_SNAPSHOTS = 6
FT_SNAPSHOTS = 8
FLOW_SNAPSHOTS = 10
FLOW_ANALYSED = [1, 3, 5, 7, 9]   # io_freq 2: the JAX example's, tests hold it
# phase 13: the explorer's clean corpus at the CLI's budget (256 schedules)
# -- [schedules, pruned, steps] per scenario, which the JAX package's
# explorer gives for its corpus with device payloads adopted in place
# (``tests/test_torch_explore.py`` holds the port and these numbers to it)
EXPLORE_COUNTS = {
    "rendezvous_depth1": [256, 79, 22193], "latest_fanin": [171, 64, 8728],
    "crash_replay": [256, 117, 30814], "traced_rendezvous": [256, 130, 28011],
    "rescale_window": [256, 189, 17854], "sem_resize": [256, 90, 6326],
    "cow_share": [20, 13, 285]}
# phase 13: each seeded race of the port: its code and the schedule ID that
# finds it (the JAX package's, for the five races both packages carry)
RACE_IDS = {
    "wlk320_tensor_view": ("WLK320", "wlk320_tensor_view@s1.0"),
    "wlk320_torn_capture": ("WLK320", "wlk320_torn_capture@s1.0"),
    "wlk320_torn_stats": ("WLK320", "wlk320_torn_stats@s1.0-s2.0"),
    "wlk321_lock_order": ("WLK321", "wlk321_lock_order@s1.0-s2.1-s3.1-s4.1"),
    "wlk322_notify_outside_lock": (
        "WLK322", "wlk322_notify_outside_lock@s1.0-s2.0-s3.1-s4.1"),
    "wlk323_missed_epoch_dedup": (
        "WLK323", "wlk323_missed_epoch_dedup@s1.0-s2.0-s3.0-s4.0-s5.0-s6.0-"
        "s7.1-s8.1-s9.1-s10.1-s11.1-s12.1-s13.1-s18.0-s19.0-s21.0-s22.0-"
        "s24.0-s25.0-s27.0")}
# phase 14: the parallel layer on a world-size-1 NCCL group, (1, 1) mesh
PAR_ARCH = "phi3.5-moe-42b-a6.6b"
PAR_BATCH, PAR_SEQ = 2, 2048          # (a): the MoE layer's tokens
PAR_LAYERS = 2                        # (b): 2 of phi3.5-moe's 32 layers
PAR_CAPACITY = 8.0                    # drops nothing at 16 experts, top-2
PAR_OUT_TOL = 2e-4                    # (a) output, as tests/test_moe_a2a.py
PAR_GRAD_TOL = (5e-4, 5e-3)           # (a) gradients: atol, rtol
PAR_LOGITS_LIMIT = 1e-4               # (b) relative L2
PAR_TRAIN_ARCH, PAR_TRAIN_STEPS = "llama3.2-3b", 2
PAR_LOSS_LIMIT = 1e-5                 # (c) relative
# phase 15: the sharded dry run, one fresh interpreter per production cell
# (arch, shape, mesh, variant), all started together
DRY_CELLS = (("llama3.2-3b", "train_4k", "pod", None),
             ("llama3.2-3b", "train_4k", "pod", "wg"),
             ("mamba2-2.7b", "prefill_32k", "multipod", None),
             ("phi3.5-moe-42b-a6.6b", "decode_32k", "pod", "moe_a2a"),
             ("zamba2-2.7b", "long_500k", "pod", None))
DRY_CALIB = ("llama3.2-3b", 2048, 1)  # (b): arch, prompt, batch (bf16, full size)
DRY_RATIO = (0.5, 2.0)                # (b): predicted / measured peak bytes
# (a): the traced FLOPs (``FlopLog``, rank 0's local ops) over the analytic
# count, within one mesh axis (16) either way: a count at the wrong scale
# (global work, or one axis's share missed) falls outside.  The ratio is
# not 1: plain attention computes the whole causal square, decode pads the
# MoE capacity buffers, DTensor splits a replicated batch's contractions
# over the data ranks (PERF.md, phase 15)
DRY_FLOPS_RATIO = (1 / 16, 16)
CARD_BYTES = 80e9
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
    """(bytes/s, bf16 FLOP/s, float32 FLOP/s) of the card: the port's one
    table of the cards' data-sheet rates (``repro_torch.launch.hlo.PEAKS``)."""
    from repro_torch.launch.hlo import peaks as card_peaks

    return list(card_peaks(name))


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
def workflow_doc():
    return {"tasks": [
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


def workflow(core, dev, seed: int, verify: bool, trace=None):
    from repro_torch.core.datamodel import BlockOwnership
    from repro_torch.core.redistribute import even_blocks

    own = BlockOwnership()
    for r, (s, sh) in enumerate(even_blocks(SHAPE, N_PROD)):
        own.add(r, s, sh)
    fields = {}
    calls = {"reeber": 0, "viz": 0}
    failures = []
    lock = threading.Lock()
    cfg = workflow_doc()

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
    report = w.run(timeout=600, trace=trace)
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
    # phase 9's training steps (batch 2)
    "zamba2 training": (2, TIME_S, 32, 32, 80, torch.bfloat16, True, 4096),
    "whisper training": (2, 448, 8, 8, 64, torch.bfloat16, True, 0),
    "phi3.5-moe training": (2, TIME_S, 32, 8, 128, torch.bfloat16, True, 0),
    "internvl2 training": (2, TIME_S + 256, 64, 8, 128, torch.bfloat16, True, 0),
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


def stub_inputs(cfg, dev, seed, batch=1):
    """The frontends' stand-ins of the vlm and encdec families for the
    logits gates and for training: vision embeddings (B, V, d) and frames
    (B, S_src, d), N(0, 0.02^2) from the seed (the engine serves zeros, as
    the reference engine does)."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    if cfg.family == "vlm":
        return {"vision_embeds": 0.02 * torch.randn(
            (batch, cfg.vision_tokens, cfg.d_model), generator=g, device=dev)}
    if cfg.family == "encdec":
        return {"frames": 0.02 * torch.randn(
            (batch, cfg.source_len, cfg.d_model), generator=g, device=dev)}
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


def initial_density(dev, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return 1.0 + 0.05 * torch.randn(SHAPE, generator=g, device=dev, dtype=dtype)


def plain_recount(dev, seed):
    """The counts of phase 8 without Wilkins: the same steps in a loop."""
    rho = initial_density(dev, seed)
    counts = torch.zeros((SHAPE[0], FAULT_SNAPSHOTS), dtype=torch.int64,
                         device=dev)
    for t in range(FAULT_SNAPSHOTS):
        rho = evolve(rho, t)
        counts[:, t] = (rho > THRESHOLD).sum(dim=(1, 2))
    return counts


def fault_doc():
    port = [{"filename": "plt*.h5", "dsets": [{"name": "/density", "memory": 1}]}]
    return {"tasks": [
        {"func": "nyx", "nprocs": 1,
         "on_failure": {"restart": {"max_retries": 3}}, "outports": port},
        {"func": "reeber", "taskCount": 2, "nprocs": 2,
         "stall_timeout_s": STALL_TIMEOUT_S,
         "on_failure": {"rescale": {"nslots": 1, "max_retries": 3}},
         "inports": [dict(port[0], redistribute=1)]},
        {"func": "viz", "nprocs": 2, "on_failure": "drop",
         "inports": [dict(port[0], io_freq=2, redistribute={"axis": 1})]},
    ]}


def fault_run(core, build, dev, seed, faults, spill_dir):
    """One run of phase 8's workflow; returns its report, reeber's counts
    (rows x snapshots, concatenated over the final instances) and what the
    tasks measured."""
    from repro_torch.core.redistribute import even_blocks

    cfg = fault_doc()
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


def step_launches(cfg) -> dict:
    """Each kernel's launches in one loss and its gradients of ``cfg``
    under ``use_flash``.  A kernel inside a layer run under ``remat``
    launches twice (the forward and the checkpoint's recompute); zamba2's
    shared block runs outside ``remat`` (``models/hybrid.py``'s
    ``forward``, as the reference's), so K3 launches once per group there;
    whisper's encoder attention is non-causal and plain, so K3 runs in its
    decoder only (``n_layers`` counts the decoder's)."""
    twice = 2 if cfg.remat in ("full", "dots") else 1
    if cfg.family == "ssm":
        return {"ssd_intra_chunk": twice * cfg.n_layers}
    if cfg.family == "hybrid":
        return {"ssd_intra_chunk": twice * cfg.n_layers,
                "flash_attention": cfg.n_layers // cfg.attn_every}
    return {"flash_attention": twice * cfg.n_layers}


def train_config(arch, n_layers=None, **over):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.replace(n_layers=n_layers or cfg.n_layers, **over)


def train_batches(cfg, seq, batch, n, dev, seed):
    """``n`` batches of ``SyntheticCorpus(seed)`` on the card, each with the
    family's stub input (``stub_inputs``) drawn from the seed and the step."""
    from repro_torch.train import DataConfig, SyntheticCorpus

    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch, seed=seed))
    out = []
    for i in range(n):
        b = {k: torch.as_tensor(v).to(dev) for k, v in corpus.batch(i).items()}
        b.update(stub_inputs(cfg, dev, seed + 10 * i, batch))
        out.append(b)
    return out


def train_gate(arch, n_layers, seq, build, dev, seed):
    """Phase 9 (a): the kernel path against the plain path at full width
    and ``n_layers`` layers on float32 weights, one sequence of ``seq``
    tokens: the loss and every parameter's gradient, and each kernel's
    launches on the kernel path against ``step_launches``."""
    from repro_torch.models.registry import get_family

    base = train_config(arch, n_layers, dtype="float32")
    fam = get_family(base)
    model = fam.init(base, torch.Generator(device=dev).manual_seed(seed), dev)
    (batch,) = train_batches(base, seq, GATE_BATCH, 1, dev, seed)
    names, params = zip(*model.named_parameters())
    out, launched = {}, {}
    for use_flash in (True, False):
        before = build.launch_counts()
        t0 = time.perf_counter()
        loss = fam.loss_fn(model, base.replace(use_flash=use_flash), batch)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        out[f"s_{use_flash}"] = time.perf_counter() - t0
        launched[use_flash] = launches_since(build, before)
        out[use_flash] = (loss.detach(), grads)
    (lk, gk), (lp, gp) = out[True], out[False]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    errs = {n: rel_l2(a, b) for n, a, b in zip(names, gk, gp)}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in (*gk, *gp))
    want = step_launches(base)
    row = {"layers": n_layers, "batch": GATE_BATCH, "seq": seq,
           "loss_kernel": float(lk), "loss_plain": float(lp), "loss_rel": loss_rel,
           "grad_rel_l2_max": errs[worst], "grad_rel_l2_worst_param": worst,
           "grads_finite": finite, "gate_launches": launched[True],
           "gate_launches_expected": want, "kernel_s": out["s_True"],
           "plain_s": out["s_False"],
           "limits": {"loss": LOSS_LIMIT, "grad": GRAD_LIMIT}}
    problems = []
    if not (finite and loss_rel <= LOSS_LIMIT and errs[worst] <= GRAD_LIMIT):
        problems.append(f"{arch}: kernel vs plain path at {n_layers} layers, "
                        f"{seq} tokens, in float32: {row}")
    if launched[True] != want or launched[False]:
        problems.append(f"{arch}: the gate launched {launched[True]} on the "
                        f"kernel path and {launched[False]} on the plain one, "
                        f"expected {want} and none")
    del model, out, gk, gp, grads
    gc.collect()
    torch.cuda.empty_cache()
    return row, launched[True], problems


def count_plain_calls(ref):
    """Count calls of K3's and K4's plain versions until the returned
    ``restore()``: on the training path they must not run where the
    kernel runs.  ``attend`` sends non-causal attention (whisper's encoder
    and cross-attention, as the reference does) to K3's plain version by
    design: those calls are counted apart, as ``flash_attention_ref
    non-causal``."""
    calls = {"flash_attention_ref": 0, "ssd_intra_chunk_ref": 0}
    originals = {n: getattr(ref, n) for n in calls}

    def counting(n):
        def fn(*a, **kw):
            key = n
            if n == "flash_attention_ref" and not kw.get(
                    "causal", a[3] if len(a) > 3 else True):
                key = f"{n} non-causal"
            calls[key] = calls.get(key, 0) + 1
            return originals[n](*a, **kw)
        return fn

    for n in originals:
        setattr(ref, n, counting(n))

    def restore():
        for n, f in originals.items():
            setattr(ref, n, f)

    return calls, restore


def train_model(arch, n_layers, seq, build, ref, dev, seed):
    """Phase 9 (b): full width, ``n_layers`` layers (None: the config's),
    bf16, remat and moments as configured, use_flash: 4 steps of
    make_train_step, then a fifth under the profiler."""
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optim import adamw_update

    cfg = train_config(arch, n_layers, use_flash=True)
    ocfg = AdamWConfig(lr=TRAIN_LR.get(arch, TRAIN_LR_DEFAULT), warmup_steps=1,
                       total_steps=TRAIN_STEPS, state_dtype=cfg.opt_state_dtype)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device=dev).manual_seed(seed), cfg, ocfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, ocfg)
    batches = train_batches(cfg, seq, TRAIN_BATCH, TRAIN_STEPS + 1, dev, seed)

    plain_calls, restore = count_plain_calls(ref)
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
        restore()
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
    tokens = TRAIN_BATCH * seq
    want = {k: TRAIN_STEPS * n for k, n in step_launches(cfg).items()}
    got = {k: n for k, n in launches.items() if n}
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"{arch}: losses {losses}: not all finite, or the "
                        f"{TRAIN_STEPS}th not below the first")
    if got != want:
        problems.append(f"{arch}: kernels launched {got} in {TRAIN_STEPS} "
                        f"steps, expected {want} (step_launches)")
    if plain_calls["flash_attention_ref"] or plain_calls["ssd_intra_chunk_ref"]:
        problems.append(f"{arch}: plain versions {plain_calls} ran on the "
                        f"training path")
    if peak_mem >= CARD_BYTES:
        problems.append(f"{arch}: peak memory {peak_mem} bytes")
    row = {"phase": "train", "arch": arch, "family": cfg.family,
           "dtype": cfg.dtype, "remat": cfg.remat, "use_flash": True,
           "layers": cfg.n_layers, "layers_of_config": train_config(arch).n_layers,
           "params": n_params,
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "moment_dtype": ocfg.state_dtype,
           "moment_bytes": sum(t.numel() * t.element_size()
                               for t in (*state.opt.m.values(), *state.opt.v.values())),
           "batch": TRAIN_BATCH, "seq": seq, "steps": TRAIN_STEPS,
           "stub": sorted(k for k in batches[0] if k not in ("tokens", "labels")),
           "lr": ocfg.lr, "init_s": init_s, "losses": losses, "grad_norms": gnorms,
           "step_s": step_s, "s_per_step": steady, "tokens_per_s": tokens / steady,
           "first_step_s": step_s[0], "optimizer_s": optimizer_s,
           "launches": got, "launches_expected": want, "plain_calls": plain_calls,
           "max_memory_allocated": peak_mem, **prof}
    del state, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    return row, got, problems


def _leaf_diffs(params, want, atol, rtol):
    """``params`` (name -> tensor on the card) against ``want`` (name ->
    host tensor): the largest absolute difference, the largest share of
    ``atol + rtol |want|``, the elements beyond it, and ``want``'s global
    norm."""
    worst = share = 0.0
    over, sq = 0, 0.0
    for n, p in params.items():
        w = want[n].to(p.device).float()
        d = (p.float() - w).abs()
        lim = atol + rtol * w.abs()
        worst = max(worst, d.max().item())
        share = max(share, (d / lim).max().item())
        over += int((d > lim).sum())
        sq += float(torch.sum(w.double() ** 2))
    return {"param_max_abs_diff": worst, "param_share_of_tol": share,
            "param_elements_over_tol": over, "norm_of_compared": sq ** 0.5}


def variant_steps(cfg, seq, variants, build, dev, seed):
    """One plain step and then one step of each of ``variants``
    (``make_train_step``'s keywords), each from the seed's initial state
    on the first batch the plain steps take: per run the loss, seconds,
    peak memory and launches, and its parameters and loss against the run
    before it (accumulation against the plain step, compression against
    accumulation)."""
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    ocfg = AdamWConfig(lr=TRAIN_LR_DEFAULT, warmup_steps=1,
                       total_steps=TRAIN_STEPS, state_dtype=cfg.opt_state_dtype)
    (batch,) = train_batches(cfg, seq, TRAIN_BATCH, 1, dev, seed)
    rows, prev = [], None
    for kw in ({},) + tuple(variants):
        gc.collect()
        torch.cuda.empty_cache()
        state = init_state(torch.Generator(device=dev).manual_seed(seed), cfg,
                           ocfg, dev)
        step = make_train_step(cfg, ocfg, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = build.launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        row = {"accum_steps": kw.get("accum_steps", 1),
               "compress_grads": kw.get("compress_grads", False),
               "loss": loss, "s": time.perf_counter() - t0,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "launches": launches_since(build, before)}
        params = {n: p.detach() for n, p in state.params.named_parameters()}
        if prev is not None:
            row["loss_rel"] = abs(loss - prev[0]) / abs(prev[0])
            row.update(_leaf_diffs(params, prev[1], *ACCUM_TOL))
        prev = (loss, {n: p.cpu() for n, p in params.items()})
        rows.append(row)
        del state, step, params, m
    del prev
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def accum_runs(arch, gate_layers, seq, build, dev, seed):
    """Phase 9 (d): ``TRAIN_ACCUM[arch]`` after a plain step, (1) in
    float32 at full width and the gate's depth, held to the tolerances of
    ``tests/test_train.py`` (accumulation: the loss within 1e-4 relative
    and every parameter within 5e-4 + 5e-3 |p| of the plain step's;
    compression: every parameter within 0.05 x max(global norm, 1) of
    accumulation's), and (2) in bf16 at full width and depth, recorded:
    seconds, peak memory, and the same differences.  In bf16 AdamW's first
    step moves each weight by about lr times the sign of its gradient, and
    that sign differs between a bf16 full-batch gradient and the float32
    sum of two bf16 microbatch gradients wherever they nearly cancel, so
    there the elementwise tolerance holds nothing; launches, finite losses
    and the memory are gated."""
    variants = TRAIN_ACCUM[arch]
    gate_cfg = train_config(arch, gate_layers, dtype="float32", use_flash=True)
    full_cfg = train_config(arch, use_flash=True)
    gate = variant_steps(gate_cfg, seq, variants, build, dev, seed)
    full = variant_steps(full_cfg, seq, variants, build, dev, seed)
    problems = []
    launched = {}
    for what, rows, cfg in (("float32 gate", gate, gate_cfg),
                            ("bf16", full, full_cfg)):
        per = step_launches(cfg)
        for r in rows:
            want = {k: r["accum_steps"] * n for k, n in per.items()}
            if r["launches"] != want or not np.isfinite(r["loss"]) or \
                    r["max_memory_allocated"] >= CARD_BYTES:
                problems.append(f"{arch} {what} {r}: expected launches {want}, "
                                f"a finite loss and memory below the card's")
            for k, n in kernel_keys(r["launches"], cfg.dtype).items():
                launched[k] = launched.get(k, 0) + n
    for r in gate[1:]:
        if r["compress_grads"]:
            ok = r["param_max_abs_diff"] < COMPRESS_SHARE * max(r["norm_of_compared"], 1.0)
        else:
            ok = r["loss_rel"] <= ACCUM_LOSS_RTOL and r["param_share_of_tol"] <= 1
        if not ok:
            problems.append(f"{arch}: the float32 {'compressed' if r['compress_grads'] else 'accumulated'} "
                            f"step is beyond its tolerance: {r}")
    row = {"phase": "train_accum", "arch": arch, "batch": TRAIN_BATCH, "seq": seq,
           "gate_layers": gate_layers, "float32_gate": gate,
           "bf16_layers": full_cfg.n_layers, "bf16": full,
           "tolerances": {"accum_loss_rtol": ACCUM_LOSS_RTOL,
                          "accum_params_atol_rtol": ACCUM_TOL,
                          "compress_share_of_norm": COMPRESS_SHARE}}
    return row, launched, problems


def _host_leaves(tree):
    """(path, host array, bfloat16 tag) of each leaf, flattened as the
    checkpoint container flattens a tree."""
    from repro_torch.train.checkpoint import _flatten_with_paths, _host_leaf

    return [(p, *_host_leaf(x)) for p, x in _flatten_with_paths(tree)]


def _same_tree(a, b) -> bool:
    """The same paths, dtypes, shapes and bytes, leaf by leaf."""
    la, lb = _host_leaves(a), _host_leaves(b)
    return len(la) == len(lb) and all(
        pa == pb and ta == tb and x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(np.ascontiguousarray(x).view(np.uint8),
                           np.ascontiguousarray(y).view(np.uint8))
        for (pa, x, ta), (pb, y, tb) in zip(la, lb))


def resume_runs(dev):
    """Phase 9 (e): ``launch.train``'s checkpoints on the card, RESUME_ARGS
    (llama3.2-3b at full width, 2 layers, 4 steps of 2 x 2048).  (A) runs
    uninterrupted, with no checkpoint directory; (B) runs with a checkpoint
    every 2 steps and is stopped after step 2 as a preempted job is (its
    step 3 raises; the checkpoint of step 2 lands); (C) runs on (B)'s
    directory, resumes at step 2 and saves once at its end.  Each
    checkpoint of this model is about 10 GB (two 128256 x 3072 vocabulary
    matrices with float32 moments), so (A) writes none: a machine may cap
    what one run writes to its disk.  Gates: the state (C) restores equals
    what (B) saved at step 2 bit for bit, and (C)'s losses of steps 3-4
    equal (A)'s within LOSS_LIMIT.  Every ``train_state_to_reference``
    copy is timed."""
    import contextlib
    import io
    import shutil

    from repro_torch.launch import train as launch

    to_ref, from_ref = launch.train_state_to_reference, launch.train_state_from_reference
    make_step, checkpointer = launch.make_train_step, launch.AsyncCheckpointer
    run, copies, saved, restored, made = ["A"], [], {}, {}, []

    def timed_to_ref(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = to_ref(state)
        copies.append({"run": run[0], "s": time.perf_counter() - t0,
                       "bytes": sum(x.nbytes for _, x, _ in _host_leaves(tree))})
        if run[0] == "B":
            saved["B"] = tree
        return tree

    def checked_from_ref(cfg, host, device=None):
        t0 = time.perf_counter()
        state = from_ref(cfg, host, device)
        torch.cuda.synchronize()
        restored["s"] = time.perf_counter() - t0
        restored["equal_to_saved"] = _same_tree(to_ref(state), saved.pop("B"))
        return state

    class Preempted(Exception):
        pass

    def preempted_after_two(*a, **kw):
        fn = make_step(*a, **kw)
        taken = [0]

        def step(state, batch):
            if taken[0] == 2:
                raise Preempted("stopped after step 2")
            taken[0] += 1
            return fn(state, batch)
        return step

    class Kept(checkpointer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    root = tempfile.mkdtemp(prefix="smoke_resume_")
    ckdir = os.path.join(root, "b")
    runs = (("A", []), ("B", ["--ckpt-dir", ckdir, "--ckpt-every", "2"]),
            ("C", ["--ckpt-dir", ckdir]))
    losses, walls, logs, files = {}, {}, {}, {}
    launch.train_state_to_reference = timed_to_ref
    launch.train_state_from_reference = checked_from_ref
    launch.AsyncCheckpointer = Kept
    try:
        for tag, extra in runs:
            run[0] = tag
            launch.make_train_step = preempted_after_two if tag == "B" else make_step
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                try:
                    losses[tag] = launch.main(RESUME_ARGS + extra + ["--device", str(dev)])
                except Preempted:
                    for ck in made:
                        ck.wait()
            walls[tag] = time.perf_counter() - t0
            logs[tag] = [l for l in out.getvalue().splitlines()
                         if l.startswith(("[resume]", "done"))]
            if os.path.isdir(ckdir):
                files[tag] = {f: os.path.getsize(os.path.join(ckdir, f))
                              for f in sorted(os.listdir(ckdir)) if f.endswith(".ckpt")}
    finally:
        launch.train_state_to_reference, launch.train_state_from_reference = to_ref, from_ref
        launch.make_train_step, launch.AsyncCheckpointer = make_step, checkpointer
        shutil.rmtree(root, ignore_errors=True)
    a, c = losses["A"], losses.get("C", [])
    rel = [abs(x - y) / abs(y) for x, y in zip(c, a[2:])]
    moved = sum(x["bytes"] for x in copies)
    row = {"phase": "train_resume", "args": RESUME_ARGS,
           "runs": {t: e for t, e in runs}, "losses": losses,
           "loss_rel_c_vs_a": rel, "limit": LOSS_LIMIT,
           "restored_equal_to_saved": restored.get("equal_to_saved"),
           "restore_s": restored.get("s"), "wall_s": walls, "log": logs,
           "checkpoint_files": files, "to_reference_copies": copies,
           "to_reference_gb_per_s": moved / sum(x["s"] for x in copies) / 1e9
           if copies else None}
    problems = []
    if not (len(a) == 4 and len(c) == 2 and restored.get("equal_to_saved")
            and all(r <= LOSS_LIMIT for r in rel)
            and "B" not in losses and any("restored step 2" in l for l in logs["C"])):
        problems.append(f"launch.train's resume: {row}")
    return row, problems


def function_grads(ops, dev):
    """Phase 9 (c): each autograd Function against autograd through the
    plain op on the card, gradients of sum(out^2), float32: the largest
    error over each gradient's tolerance (2e-4 relative, and absolute on
    the scale of its largest entry), at the shapes in ``FN_CASES``; K3's
    windowed case also times the Function's forward (the kernel) and its
    backward (the plain blockwise recompute)."""
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

    res, times = {}, {}
    for label, (b, s, h, kv, d, window) in FN_CASES["flash_attention"].items():
        q, k, v = fa_inputs(dev, b, s, h, kv, d, torch.float32, 31)
        fn = lambda *a, w=window: ops.flash_attention(*a, causal=True, window=w)  # noqa: E731
        res[label] = share(
            grads(fn, (q, k, v)),
            grads(lambda *a, w=window: ref.flash_attention_ref(
                *a, causal=True, window=w), (q, k, v)))
        if window:
            xs = [t.clone().requires_grad_() for t in (q, k, v)]
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            e[0].record()
            out = fn(*xs)
            e[1].record()
            torch.autograd.grad((out ** 2).sum(), xs)
            e[2].record()
            e[2].synchronize()
            times[label] = {"forward_kernel_ms": e[0].elapsed_time(e[1]),
                            "backward_recompute_ms": e[1].elapsed_time(e[2])}
            del xs, out
        del q, k, v
    for label, (b, s, h, p, g_, n, chunk) in FN_CASES["ssd_intra_chunk"].items():
        gen = torch.Generator(device=dev).manual_seed(32)
        ins = (torch.randn((b, s, h, p), generator=gen, device=dev),
               -torch.randn((b, s, h), generator=gen, device=dev).abs() * 0.1,
               torch.randn((b, s, g_, n), generator=gen, device=dev),
               torch.randn((b, s, g_, n), generator=gen, device=dev))
        res[label] = share(
            grads(lambda *a, c=chunk: ops.ssd_chunked_kernel(*a, chunk=c), ins),
            grads(lambda *a, c=chunk: ssd_chunked(*a, chunk=c), ins))
    torch.cuda.synchronize()
    bad = {k: v for k, v in res.items() if not v <= 1.0}
    if bad:
        raise RuntimeError(f"autograd Function gradients differ from the plain "
                           f"op's beyond {FN_GRAD_TOL}: {bad} (share of limit)")
    return {"share_of_limit": res, "tolerance": FN_GRAD_TOL,
            "windowed_times": times,
            "shapes": {"flash_attention": {k: f"(B, S, H, KV, D, window) {v}, f32"
                                           for k, v in FN_CASES["flash_attention"].items()},
                       "ssd_intra_chunk": {k: f"(B, S, H, P, G, N, chunk) {v}, f32"
                                           for k, v in FN_CASES["ssd_intra_chunk"].items()}}}


def kernel_keys(launched, dtype):
    """``launched`` keyed as the per-kernel line's entries: K3 in float32
    is ``flash_attention:float32``."""
    return {(f"{k}:float32" if k == "flash_attention" and dtype == "float32"
             else k): n for k, n in launched.items()}


def train_phase(build, ops, ref, dev, seed):
    """Phase 9: for each model the gate(s), the 4 steps and their line,
    then the accumulation runs, the checkpoint resume and the Functions'
    gradients.  Returns each kernel's launches by part:
    {part: {kernel key (``kernel_keys``): {arch: n}}}."""
    t_phase = time.perf_counter()
    launches = {"steps": {}, "gates": {}, "accum": {}, "resume": {}}

    def add(part, arch, got, dtype):
        for k, n in kernel_keys(got, dtype).items():
            by_arch = launches[part].setdefault(k, {})
            by_arch[arch] = by_arch.get(arch, 0) + n

    for arch, n_layers, gate_layers, seq in TRAIN_ARCHS:
        t_arch = time.perf_counter()
        gate, got, problems = train_gate(arch, gate_layers, seq, build, dev, seed)
        add("gates", arch, got, "float32")
        window = None
        if arch == TRAIN_WINDOW_GATE[0]:
            window, got, more = train_gate(arch, *TRAIN_WINDOW_GATE[1:], build,
                                           dev, seed)
            add("gates", arch, got, "float32")
            problems += more
        row, got, more = train_model(arch, n_layers, seq, build, ref, dev, seed)
        add("steps", arch, got, row["dtype"])
        row["gate"] = gate
        if window is not None:
            row["window_gate"] = window
        row["arch_s"] = time.perf_counter() - t_arch
        emit(row)
        if problems + more:
            raise RuntimeError("; ".join(problems + more))
    for arch, _, gate_layers, seq in TRAIN_ARCHS:
        if arch not in TRAIN_ACCUM:
            continue
        t0 = time.perf_counter()
        row, got, problems = accum_runs(arch, gate_layers, seq, build, dev, seed)
        for k, n in got.items():
            launches["accum"].setdefault(k, {})[arch] = n
        row["phase_s"] = time.perf_counter() - t0
        emit(row)
        if problems:
            raise RuntimeError("; ".join(problems))
    t0 = time.perf_counter()
    before = build.launch_counts()
    row, problems = resume_runs(dev)
    row["launches"] = launches_since(build, before)
    row["phase_s"] = time.perf_counter() - t0
    add("resume", RESUME_ARGS[1], row["launches"], "bfloat16")
    emit(row)
    if problems:
        raise RuntimeError("; ".join(problems))
    emit({"phase": "train_functions", **function_grads(ops, dev),
          "phase_s": time.perf_counter() - t_phase})
    return launches


# --------------------------------------------------------------- phase 10
def example(name):
    """One of the port's examples, imported from ``examples/``."""
    import importlib.util

    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_smoke_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ensemble_phase(dev, seed):
    """Phase 10: the nucleation ensemble at ENS_INSTANCES and at 1 instance,
    each count held to a plain recount on the card."""
    ens = example("torch_nucleation_ensemble")
    t_phase = time.perf_counter()
    plain = {}
    t0 = time.perf_counter()
    for i in range(ENS_INSTANCES):
        for t, pos in ens.trajectory(i, ENS_ATOMS, ENS_STEPS, dev, seed):
            plain[(i, t)] = ens.diamond_detector(pos)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0    # the same work in one thread
    plain = {k: int(v) for k, v in plain.items()}
    rows, problems = {}, []
    for n in (ENS_INSTANCES, 1):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        detections, report = ens.run(instances=n, atoms=ENS_ATOMS,
                                     steps=ENS_STEPS, device=dev, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = {(i, t) for i in range(n) for t in range(ENS_STEPS)}
        if set(detections) != want:
            problems.append(f"{n} instances: delivered {sorted(detections)}")
        wrong = [k for k, (c, _) in detections.items() if c != plain[k]]
        if wrong:
            problems.append(f"{n} instances: counts differ from the plain "
                            f"recount at {wrong[:5]}")
        off = [k for k, (_, d) in detections.items() if not d.startswith("cuda")]
        if off:
            problems.append(f"{n} instances: detector inputs off the card {off[:5]}")
        rows[n] = {"instances": n, "wall_s": wall,
                   "wall_s_per_step": wall / ENS_STEPS,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "served": report.total_served,
                   "detector_launches": sum(
                       v for (task, _), v in report.task_launches.items()
                       if task == "detector"),
                   "nucleated": [detections[(i, ENS_STEPS - 1)][0]
                                 for i in range(n)]}
        emit({"phase": "ensemble_run", **rows[n]})
    emit({"phase": "ensemble", "atoms": ENS_ATOMS, "steps": ENS_STEPS,
          "plain_recount_equal": not any("recount" in p for p in problems),
          "wall_ratio_8_to_1": (rows[ENS_INSTANCES]["wall_s_per_step"]
                                / rows[1]["wall_s_per_step"]),
          "plain_loop_s_per_step": plain_s / ENS_STEPS,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
    return ens.workflow(ENS_INSTANCES)


# --------------------------------------------------------------- phase 11
def scheduler_phase(dev, seed):
    """Phase 11: the fair-scheduled cosmology workflow at 256^3, each
    analysis held to a plain recount of the same field on the card."""
    from repro_torch.core.datamodel import reset_transport_stats, transport_stats
    from repro_torch.core.redistribute import plan_cache, reset_plan_cache

    sched = example("torch_cosmology_scheduler")
    t_phase = time.perf_counter()
    grid = SHAPE[0]
    reset_plan_cache()
    reset_transport_stats()
    timeline = os.path.join(tempfile.gettempdir(), "smoke_timeline.json")
    t0 = time.perf_counter()
    analysed, report = sched.run(grid=grid, count=SCHED_SNAPSHOTS, device=dev,
                                 seed=seed, timeline=timeline, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = transport_stats().snapshot()
    plans = plan_descriptors(plan_cache())
    problems = []
    for t, field in sched.snapshots(grid, SCHED_SNAPSHOTS, dev, seed):
        want = {"reeber": sched.find_halos(field).item(),
                "spectrum": sched.mean_density(field).item()}
        for task, value in want.items():
            got = analysed.get((task, t))
            if got is None or got[0] != value:
                problems.append(f"{task} step {t}: {got} != plain {value}")
    off = [k for k, (_, d) in analysed.items() if not d.startswith("cuda")]
    if off:
        problems.append(f"payloads off the card: {off[:5]}")
    if len(report.timeline) < 1:
        problems.append("the telemetry timeline holds no sample")
    depths = report.scheduler["depths"]
    reeber = [d for e, d in depths.items() if "reeber" in e]
    if len(reeber) != 1 or not 1 <= reeber[0] <= 4:
        problems.append(f"reeber's final depth {depths}")
    edges = {}
    for ch in report.channels:
        s = ch.stats_snapshot()
        edges[ch.name] = {k: s[k] for k in (
            "served", "prefetch_hits", "prefetch_misses", "prefetch_blocked_s")}
        edges[ch.name]["weight"] = ch.weight
    emit({"phase": "scheduler", "grid": grid, "snapshots": SCHED_SNAPSHOTS,
          "analysed": {task: sum(1 for k in analysed if k[0] == task)
                       for task in ("reeber", "spectrum")},
          "plain_recount_equal": not any("plain" in p for p in problems),
          "wall_s": wall, "wall_s_per_snapshot": wall / SCHED_SNAPSHOTS,
          "edges": edges, "depths": depths,
          "decisions": len(report.scheduler["decisions"]),
          "timeline_samples": len(report.timeline),
          "copies": stats["copies"], "bytes_copied": stats["bytes_copied"],
          "redist_shipped_bytes": stats["redist_shipped_bytes"],
          "plans": len(plans), "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
    return sched.WORKFLOW, plans


# --------------------------------------------------------------- phase 12
def plan_descriptors(cache):
    """Every plan in the plan cache as JSON: its key and its transfers."""
    with cache._lock:
        plans = list(cache._plans.values())
    return [{"src": [list(map(list, b)) for b in p.src],
             "dst": [list(map(list, b)) for b in p.dst],
             "shape": list(p.shape), "dtype": str(p.dtype),
             "per_dst": [[[t.src_rank, t.dst_rank, list(t.global_starts),
                           list(t.shape)] for t in d] for d in p.per_dst]}
            for p in plans]


_ANALYSIS_PROBE = """
import json, math, sys, types
from repro_torch.analysis import plancheck
from repro_torch.core.redistribute import CompiledPlan, intersect
plans = json.load(open(sys.argv[1]))
out = []
for p in plans:
    box = lambda b: (tuple(b[0]), tuple(b[1]))
    plan = CompiledPlan([box(b) for b in p["src"]], [box(b) for b in p["dst"]],
                        tuple(p["shape"]), p["dtype"])
    same = [[[t.src_rank, t.dst_rank, list(t.global_starts), list(t.shape)]
             for t in d] for d in plan.per_dst] == p["per_dst"]
    # a reshard of a received slab plans from the slab alone and runs only
    # the dst ranks inside it (comm.reshard refuses any other): verify those
    ranks = range(len(plan.dst))
    vol = sum(math.prod(b[1]) for b in plan.src)
    if vol < math.prod(plan.shape):
        ranks = [r for r, d in enumerate(plan.dst)
                 if any(intersect(d, s) == d for s in plan.src)]
    ran = types.SimpleNamespace(shape=plan.shape, src=plan.src,
                                dst=[plan.dst[r] for r in ranks],
                                per_dst=[plan.per_dst[r] for r in ranks])
    out.append({"same_transfers": same, "ranks": len(plan.dst),
                "ranks_run": len(ranks),
                "findings": [d.code for d in plancheck.verify_plan(ran)],
                "findings_whole_plan": [d.code for d in
                                        plancheck.verify_plan(plan)]})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(json.dumps({"plans": out, "foreign_modules": bad}))
"""


def analysis_phase(docs, plans):
    """Phase 12: ``python -m repro_torch.analysis check`` on the workflow
    documents of phases 3, 8, 10 and 11, ``lint`` on the port's core, and
    ``plancheck.verify_plan`` over the plans K1/K2 ran, each in a fresh
    interpreter that imports no JAX."""
    import yaml

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    problems, results = [], {}
    with tempfile.TemporaryDirectory(prefix="smoke_analysis_") as d:
        paths = []
        for name, doc in docs.items():
            path = os.path.join(d, f"{name}.yaml")
            with open(path, "w") as f:
                f.write(doc if isinstance(doc, str) else yaml.safe_dump(doc))
            paths.append(path)
        plan_file = os.path.join(d, "plans.json")
        with open(plan_file, "w") as f:
            json.dump(plans, f)
        for tag, argv in (("check", ["-m", "repro_torch.analysis", "check",
                                     "--json", *paths]),
                          ("lint", ["-m", "repro_torch.analysis", "lint",
                                    "--json"]),
                          ("plancheck", ["-c", _ANALYSIS_PROBE, plan_file])):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, *argv], env=env, cwd=ROOT,
                                 capture_output=True, text=True, timeout=300)
            res = {"rc": out.returncode, "s": time.perf_counter() - t0}
            if tag == "plancheck":
                doc = json.loads(out.stdout.strip().splitlines()[-1]) \
                    if out.returncode == 0 else {}
                ps = doc.get("plans", [])
                res.update(plans=len(ps),
                           slab_plans=sum(p["ranks_run"] < p["ranks"] for p in ps),
                           ranks_verified=sum(p["ranks_run"] for p in ps),
                           findings=sum(len(p["findings"]) for p in ps),
                           findings_unrun_ranks=sum(len(p["findings_whole_plan"])
                                                    for p in ps))
                if (out.returncode or not doc["plans"] or res["findings"]
                        or not all(p["same_transfers"] for p in doc["plans"])
                        or doc["foreign_modules"]):
                    problems.append(f"plancheck: {out.stdout[-400:]} {out.stderr[-400:]}")
            else:
                doc = json.loads(out.stdout) if out.stdout.strip() else {}
                counts = doc.get("counts", {})
                res.update(findings=counts.get("total"), errors=counts.get("error"))
                if out.returncode or counts.get("error", 1):
                    problems.append(f"{tag}: rc {out.returncode}: "
                                    f"{out.stdout[-400:]} {out.stderr[-400:]}")
            results[tag] = res
    emit({"phase": "analysis", "documents": sorted(docs), **results,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))


# --------------------------------------------------------------- phase 13
_RACE_PROBE = """
import glob, importlib.util, json, os, sys, time
os.environ["WILKINS_EXPLORE"] = "1"
import torch
from repro_torch.analysis.explore import explore
out = {}
for path in sorted(glob.glob(os.path.join(sys.argv[1], "wlk*.py"))):
    stem = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location("_race_" + stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    build = mod.build
    if stem == "wlk320_tensor_view":   # its tensor and view on the card
        build = lambda: mod.build("tensor", torch.device("cuda", 0))
    t0 = time.perf_counter()
    rep = explore(build, scenario=stem, max_schedules=mod.BUDGET)
    out[stem] = {"codes": sorted({d.code for d in rep.findings}),
                 "schedule_id": rep.schedule_id, "schedules": rep.schedules,
                 "s": time.perf_counter() - t0}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(json.dumps({"races": out, "foreign_modules": bad}))
"""


def explore_phase():
    """Phase 13: ``python -m repro_torch.analysis explore --json`` with the
    payloads on ``cuda:0`` and again with ``--device cpu``, and the port's
    seeded races (the tensor-view race on the card), each in a fresh
    interpreter, the three at once."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("WILKINS_EXPLORE", None)
    races = os.path.join(ROOT, "tests", "analysis_fixtures", "races_torch")
    argv = {"cuda": ["-m", "repro_torch.analysis", "explore", "--json"],
            "cpu": ["-m", "repro_torch.analysis", "explore", "--json",
                    "--device", "cpu"],
            "races": ["-c", _RACE_PROBE, races]}
    procs, t0 = {}, {}
    for tag, a in argv.items():
        t0[tag] = time.perf_counter()
        procs[tag] = subprocess.Popen([sys.executable, *a], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
    res, wall, problems = {}, {}, []
    try:
        for tag, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            wall[tag] = time.perf_counter() - t0[tag]
            if proc.returncode:
                problems.append(f"{tag}: rc {proc.returncode}: {out[-400:]} "
                                f"{err[-1500:]}")
                continue
            res[tag] = json.loads(out.strip().splitlines()[-1]) \
                if tag == "races" else json.loads(out)
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    counts = {tag: {d["scenario"]: [d["schedules"], d["pruned"], d["steps_total"]]
                    for d in res.get(tag, [])} for tag in ("cuda", "cpu")}
    found = {tag: sorted(d["scenario"] for d in res.get(tag, []) if d["found"])
             for tag in ("cuda", "cpu")}
    races = res.get("races", {}).get("races", {})
    got_ids = {k: (tuple(v["codes"]), v["schedule_id"]) for k, v in races.items()}
    want_ids = {k: ((code,), sid) for k, (code, sid) in RACE_IDS.items()}
    emit({"phase": "explore", "counts_cuda": counts["cuda"],
          "counts_cpu": counts["cpu"], "findings_cuda": found["cuda"],
          "findings_cpu": found["cpu"], "races": races,
          "wall_s": wall, "phase_s": time.perf_counter() - t_phase})
    for tag in ("cuda", "cpu"):
        if counts[tag] != EXPLORE_COUNTS:
            problems.append(f"explore on {tag}: counts {counts[tag]}, "
                            f"expected {EXPLORE_COUNTS}")
        if found[tag]:
            problems.append(f"explore on {tag}: findings in {found[tag]}")
    if got_ids != want_ids:
        problems.append(f"races: {got_ids}, expected {want_ids}")
    if res.get("races", {}).get("foreign_modules"):
        problems.append(f"races: foreign modules {res['races']['foreign_modules']}")
    if problems:
        raise RuntimeError("; ".join(problems))


# --------------------------------------------------------------- phase 14
def _close(a, b, atol, rtol) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _part(t0) -> dict:
    torch.cuda.synchronize()
    return {"s": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def parallel_phase(build, dev, seed):
    """Phase 14: the parallel layer on ``cuda:0``: a world-size-1 NCCL
    group and a (1, 1) ``("data", "model")`` host mesh under
    ``RULE_VARIANTS["moe_a2a"]``.  (a) one phi3.5-moe MoE layer at full
    width, float32, through the EP schedule against ``moe_dense``: output
    and gradients; (b) phi3.5-moe at full width and ``PAR_LAYERS`` layers,
    float32, ``use_flash``, ``moe_dispatch="a2a"`` against ``"dense"``:
    logits, K3's launches; (c) ``launch.train``'s ``main`` on llama3.2-3b
    at full width and 2 layers through the mesh and ``shard_batch``
    against the trainer with no mesh.  Returns K3's launches in (b)'s a2a
    forward."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe_a2a
    from repro_torch.models import transformer
    from repro_torch.parallel.sharding import RULE_VARIANTS, use_mesh
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticCorpus,
                                   init_state, make_train_step)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_host_mesh(("data", "model"))
    rules = RULE_VARIANTS["moe_a2a"]
    row = {"phase": "parallel", "mesh": dict(zip(mesh.mesh_dim_names,
                                                 mesh.mesh.shape)),
           "backend": dist.get_backend(), "world": dist.get_world_size()}
    problems = []

    # (a) one MoE layer at full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(PAR_ARCH).replace(dtype="float32", moe_dispatch="a2a",
                                       capacity_factor=PAR_CAPACITY)
    moe = L.MoE(cfg, dev)
    moe.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    x = torch.randn((PAR_BATCH, PAR_SEQ, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 1))
    params = [moe.router, moe.gate, moe.up, moe.down]
    moe_a2a.reset_call_count()
    with use_mesh(mesh, rules):
        y, _ = L.moe(moe, cfg, x)
    calls = moe_a2a.call_count()
    g = torch.autograd.grad(torch.sum(y ** 2), params)
    y_dense, _ = L.moe_dense(moe, cfg, x)
    g_dense = torch.autograd.grad(torch.sum(y_dense ** 2), params)
    atol, rtol = PAR_GRAD_TOL
    names = ("router", "gate", "up", "down")
    row["a"] = {"tokens": PAR_BATCH * PAR_SEQ, "d_model": cfg.d_model,
                "experts": cfg.n_experts, "top_k": cfg.top_k,
                "d_ff": cfg.moe_ffn, "ep_calls": calls,
                "out_max_abs_err": float((y - y_dense).detach().abs().max()),
                "out_close": _close(y, y_dense, PAR_OUT_TOL, PAR_OUT_TOL),
                "grad_max_abs_err": {n: float((a - b).abs().max())
                                     for n, a, b in zip(names, g, g_dense)},
                "grads_close": all(_close(a, b, atol, rtol)
                                   for a, b in zip(g, g_dense)),
                "weights_gb": sum(p.numel() * 4 for p in params) / 1e9,
                **_part(t0)}
    if calls != 1 or not (row["a"]["out_close"] and row["a"]["grads_close"]):
        problems.append(f"(a) EP schedule vs moe_dense: {row['a']}")
    del moe, x, y, y_dense, g, g_dense, params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the whole model at PAR_LAYERS layers, a2a against dense
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(PAR_ARCH).replace(
        n_layers=PAR_LAYERS, dtype="float32", use_flash=True,
        moe_dispatch="a2a", capacity_factor=PAR_CAPACITY)
    model = transformer.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, PAR_SEQ)), device=dev)
    with torch.no_grad():
        moe_a2a.reset_call_count()
        build.reset_launch_counts()
        with use_mesh(mesh, rules):
            h, _, _ = transformer.forward(model, cfg, toks)
        torch.cuda.synchronize()
        k3 = build.launch_counts(["flash_attention"])["flash_attention"]
        calls = moe_a2a.call_count()
        logits = L.unembed(model.embed, h)
        h, _, _ = transformer.forward(model, cfg.replace(moe_dispatch="dense"), toks)
        dense = L.unembed(model.embed, h)
    err = rel_l2(logits.float(), dense.float())
    row["b"] = {"layers": PAR_LAYERS, "tokens": PAR_SEQ, "ep_calls": calls,
                "flash_attention_launches": k3, "logits_rel_l2": err,
                "finite": bool(torch.isfinite(logits).all()), **_part(t0)}
    if calls != PAR_LAYERS or k3 != PAR_LAYERS or not row["b"]["finite"] \
            or err > PAR_LOGITS_LIMIT:
        problems.append(f"(b) phi3.5-moe a2a vs dense: {row['b']}")
    del model, logits, dense
    gc.collect()
    torch.cuda.empty_cache()

    # (c) launch.train through the mesh and shard_batch vs the plain trainer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    argv = ["--arch", PAR_TRAIN_ARCH, "--n-layers", str(GATE_LAYERS),
            "--steps", str(PAR_TRAIN_STEPS), "--seq-len", str(TRAIN_SEQ),
            "--global-batch", str(TRAIN_BATCH), "--log-every", "1"]
    got = launch_train.main(argv)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(PAR_TRAIN_ARCH).replace(use_flash=True, n_layers=GATE_LAYERS)
    ocfg = AdamWConfig(lr=3e-4, total_steps=PAR_TRAIN_STEPS,
                       warmup_steps=max(1, PAR_TRAIN_STEPS // 20),
                       state_dtype=cfg.opt_state_dtype)
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, ocfg, dev)
    step = make_train_step(cfg, ocfg)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
    want = []
    for i in range(PAR_TRAIN_STEPS):
        state, m = step(state, corpus.batch(i))
        want.append(float(m["loss"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    row["c"] = {"arch": PAR_TRAIN_ARCH, "layers": GATE_LAYERS,
                "losses_mesh": got, "losses_plain": want, "loss_rel": rel,
                **_part(t0)}
    if len(got) != PAR_TRAIN_STEPS or max(rel) > PAR_LOSS_LIMIT:
        problems.append(f"(c) launch.train under the mesh vs the trainer: {row['c']}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    row["limits"] = {"out": PAR_OUT_TOL, "grad": PAR_GRAD_TOL,
                     "logits_rel_l2": PAR_LOGITS_LIMIT, "loss": PAR_LOSS_LIMIT}
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    if problems:
        raise RuntimeError("; ".join(problems))
    return k3


# --------------------------------------------------------------- phase 15
def dryrun_phase(build, dev, seed):
    """Phase 15: the sharded dry run.  (a) ``python -m
    repro_torch.launch.dryrun --device cuda`` on each of ``DRY_CELLS``, a
    fresh interpreter each (a fake group of 256 or 512 ranks cannot share
    a process with a real one), all at once; (b) llama3.2-3b at full width
    and depth in bf16, one 2048-token prefill, traced as the dry run traces
    a cell on a world-size-1 NCCL group and a (1, 1) mesh, then run for
    real on ``cuda:0`` on the same placed arguments: its predicted peak
    bytes against the measured ``max_memory_allocated``, its logits
    against the plain single-device prefill's bit for bit.  Returns the
    kernels' launches in (b)'s real run."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, Shape, get_config
    from repro_torch.launch import dryrun, hlo
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_cell, place_args
    from repro_torch.models.registry import get_family

    t_phase = time.perf_counter()
    problems = []
    env = dict(os.environ, PYTHONPATH=SRC)
    procs, t0, wall = {}, {}, {}
    results = {}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        for arch, shape, mesh, variant in DRY_CELLS:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                    arch, "--shape", shape, "--mesh", mesh, "--device", "cuda",
                    "--results-dir", out_dir] + (["--variant", variant]
                                                 if variant else [])
            key = (arch, shape, mesh, variant)
            t0[key] = time.perf_counter()
            procs[key] = subprocess.Popen(argv, env=env, cwd=ROOT,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)
        try:
            for key, proc in procs.items():
                out, err = proc.communicate(timeout=900)
                wall[key] = time.perf_counter() - t0[key]
                if proc.returncode:
                    problems.append(f"dryrun {key}: rc {proc.returncode}: "
                                    f"{out[-400:]} {err[-1500:]}")
                    continue
                arch, shape, mesh, variant = key
                tag = f"__{variant}" if variant else ""
                with open(os.path.join(out_dir,
                                       f"{arch}__{shape}__{mesh}{tag}.json")) as f:
                    results[key] = json.load(f)
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()
    cells = []
    for key, res in results.items():
        arch, shape_name, mesh, variant = key
        cfg = get_config(arch)
        shape = next(s for s in SHAPES if s.name == shape_name)
        n_data = res["n_devices"] // 16
        accum = 4 if shape.kind == "train" else 1
        ana = hlo.analytic_stats(cfg, shape, n_data, 16, accum_steps=accum)
        rf, coll = res["roofline"], res["collectives"]
        flops_ratio = res["raw_cost_analysis"]["flops"] / rf["flops"]
        row = {"phase": "dryrun_cell", "arch": arch, "shape": shape_name,
               "mesh": mesh, "variant": variant, "n_devices": res["n_devices"],
               "ok": res["ok"], "trace_s": res["t_lower_s"], "wall_s": wall[key],
               "memory": res["memory"], "peak_gb": res["memory"]["peak_bytes"] / 1e9,
               "card_gb": CARD_BYTES / 1e9,
               "fits": res["memory"]["peak_bytes"] <= CARD_BYTES,
               "collective_bytes": coll["bytes_by_kind"],
               "collective_calls": coll["count_by_kind"],
               "weight_gathers": coll["weight_gathers"],
               "weight_gather_bytes": coll["weight_gather_bytes"],
               "t_compute": rf["t_compute"], "t_memory": rf["t_memory"],
               "t_collective": rf["t_collective"], "bottleneck": rf["bottleneck"],
               "flops": rf["flops"], "hbm_bytes": rf["hbm_bytes"],
               "raw_flops": res["raw_cost_analysis"]["flops"],
               "raw_over_analytic": flops_ratio, "analytic": ana}
        cells.append(row)
        emit(row)
        if not res["ok"] or not coll["count_by_kind"]:
            problems.append(f"dryrun {key}: ok {res['ok']}, collectives {coll}")
        # the cell's mesh split (data ranks, pod included) as the phase reads it
        if (rf["flops"], rf["hbm_bytes"]) != (ana["flops"], ana["hbm_bytes"]):
            problems.append(f"dryrun {key}: roofline {rf['flops']}, "
                            f"{rf['hbm_bytes']} against analytic {ana}")
        if not DRY_FLOPS_RATIO[0] <= flops_ratio <= DRY_FLOPS_RATIO[1]:
            problems.append(f"dryrun {key}: traced FLOPs {flops_ratio:.3f} of the "
                            f"analytic count, outside {DRY_FLOPS_RATIO}")
    base = results.get(("llama3.2-3b", "train_4k", "pod", None))
    wg = results.get(("llama3.2-3b", "train_4k", "pod", "wg"))
    gathers = {}
    if base and wg:
        # wg gathers every fsdp-split weight at its access point; some
        # weight the baseline leaves split (no all-gather of its gathered
        # shard's shape in the baseline's trace) must be gathered at least
        # once per microbatch under wg
        per = 4
        b_w = base["collectives"]["weight_gathers"]
        w_w = wg["collectives"]["weight_gathers"]
        only = {k: n for k, n in w_w.items() if not b_w.get(k) and n >= per}
        gathers = {"baseline": b_w, "wg": w_w, "wg_only": only,
                   "microbatches": per,
                   "bytes": {t: r["collectives"]["weight_gather_bytes"]
                             for t, r in (("baseline", base), ("wg", wg))}}
        if not only:
            problems.append(f"wg gathers no weights the baseline does not: {gathers}")

    # (b) one cell traced and run for real, its memory estimate sized
    arch, s_len, batch = DRY_CALIB
    gc.collect()
    torch.cuda.empty_cache()
    t0b = time.perf_counter()
    cfg = get_config(arch)
    fam = get_family(cfg)
    shape = Shape("calib_prefill", s_len, batch, "prefill")
    mesh = make_host_mesh(("data", "model"))
    with dryrun.virtual_ranks(1):
        cell = make_cell(cfg, shape, mesh)
        tr = dryrun.trace_cell(cell, mesh, dev)
    predicted = tr["argument_bytes"] + tr["temp_bytes"]
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    model = fam.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, s_len)), dtype=torch.int32, device=dev)
    with torch.no_grad():
        plain, _ = fam.prefill(model, cfg, {"tokens": toks},
                               fam.init_cache(cfg, batch, s_len, device=dev))
    args = place_args(cell, mesh, (model, {"tokens": toks},
                                   fam.init_cache(cfg, batch, s_len, device=dev)))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = build.launch_counts()
    logits, _ = cell.fn(*args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - m0
    launches = launches_since(build, before)
    got = logits.full_tensor()
    equal = bool(torch.equal(got, plain))
    ratio = predicted / measured
    calib = {"phase": "dryrun_calib", "arch": arch, "dtype": cfg.dtype,
             "layers": cfg.n_layers, "prompt": s_len, "batch": batch,
             "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
             "backend": dist.get_backend(), "trace_s": tr["t_lower_s"],
             "predicted": {"argument_bytes": tr["argument_bytes"],
                           "temp_bytes": tr["temp_bytes"], "peak_bytes": predicted},
             "measured_peak_bytes": measured, "ratio": ratio,
             "ratio_limits": DRY_RATIO, "logits_equal": equal,
             "logits_max_abs_diff": float((got.float() - plain.float()).abs().max()),
             "launches": launches, "s": time.perf_counter() - t0b}
    emit(calib)
    if not DRY_RATIO[0] <= ratio <= DRY_RATIO[1]:
        problems.append(f"(b) predicted {predicted} against measured {measured} bytes")
    if not equal:
        problems.append(f"(b) placed logits differ from the plain prefill's: {calib}")
    del model, args, logits, plain, got
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    emit({"phase": "dryrun", "card": smi(), "cells": len(cells),
          "all_gathers": gathers,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
    return launches


# --------------------------------------------------------------- phase 16
def insitu_phase(build, dev):
    """Phase 16: ``examples/torch_train_insitu_eval.py``'s ``run`` on the
    card with ``--preset 100m`` (K3 under autograd in the trainer, K3's
    forward in the evaluator).  Gates: the evaluator scored at least one
    snapshot, every scored snapshot's tensors equal bit for bit the copy
    the trainer took when it wrote them, the held-out loss did not diverge
    (the example's own check), and the report's dropped count equals the
    snapshots written less those scored."""
    mod = example("torch_train_insitu_eval")
    lines = []
    torch.cuda.reset_peak_memory_stats(dev)
    before = build.launch_counts()
    t0 = time.perf_counter()
    report, evals, snaps = mod.run(INSITU_PRESET, device=str(dev), log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernel_keys(launches_since(build, before),
                           mod.PRESETS[INSITU_PRESET].dtype)
    written, scored = len(snaps["written"]), len(evals)
    row = {"phase": "insitu", "preset": INSITU_PRESET, "steps": snaps["steps"],
           "wall_s": wall, "train_s": snaps["train_s"],
           "steps_per_s": snaps["steps"] / snaps["train_s"],
           "written": written, "scored": scored,
           "dropped": report.total_dropped, "served": report.total_served,
           "bytes_moved": report.total_bytes_moved,
           "scored_steps": [s for s, _ in evals],
           "held_out_first_last": [evals[0][1], evals[-1][1]] if evals else None,
           "bits_equal": snaps["equal"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "launches": launched, "model": lines[0] if lines else None}
    problems = []
    if not evals:
        problems.append("the evaluator scored no snapshot")
    elif not evals[-1][1] < evals[0][1] + 0.5:
        problems.append(f"held-out loss diverged: {evals}")
    if not all(snaps["equal"].values()) or len(snaps["equal"]) != scored:
        problems.append(f"a scored snapshot differs from the trainer's copy: "
                        f"{snaps['equal']}")
    if report.total_dropped != written - scored:
        problems.append(f"dropped {report.total_dropped}, but {written} written "
                        f"and {scored} scored")
    if not launched.get("flash_attention:float32"):
        problems.append(f"K3 never launched in the in situ run: {launched}")
    row["phase_s"] = time.perf_counter() - t0
    emit(row)
    if problems:
        raise RuntimeError("; ".join(problems))
    return launched


# --------------------------------------------------------------- phase 17
def attribution_close(got, want, tol=1e-6) -> bool:
    """Two attribution reports alike: the same instances, critical instance,
    steps and edges, the same byte and plan-cache counts, and every second
    within ``tol`` (the export rounds each timestamp to 1 ns)."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and sorted(got) == sorted(want)
                and all(attribution_close(got[k], want[k], tol) for k in want))
    if isinstance(want, float) and isinstance(got, (int, float)):
        return abs(got - want) <= tol
    return got == want


def cli_report(path):
    """``python -m repro_torch.obs report PATH --json`` in a fresh
    interpreter: (its report, the modules it imported)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "repro_torch.obs", "report", path, "--json"],
                       capture_output=True, text=True, env=env, timeout=300)
    if p.returncode != 0:
        raise RuntimeError(f"obs report exited {p.returncode}: {p.stderr[-2000:]}")
    mods = {line.rsplit("|", 1)[1].strip() for line in p.stderr.splitlines()
            if line.startswith("import time:") and "|" in line}
    return json.loads(p.stdout), mods


class GcClock:
    """Seconds the host's garbage collector ran, and its collections by
    generation, while the ``with`` block ran."""

    def __enter__(self):
        self.seconds, self.collections, self._t0 = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self._tick)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)

    def _tick(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1


def live_recorders() -> int:
    from repro_torch.obs import SpanRecorder

    gc.collect()
    return sum(type(o) is SpanRecorder for o in gc.get_objects())


def trace_phase(core, build, dev, seed, untraced, tmp):
    """Phase 17: phase 3's workflow traced.  Untraced and traced runs
    alternate for the wall times (``verify=False``, as phase 4), each
    creating a recorder only when traced, and no recorder outlives them;
    then one traced run with ``verify=True`` is held to every gate: blocks
    equal to the field, K1 and K2 launched as in phase 3 (``untraced``),
    spans of every layer in ``TRACE_LAYERS``, each instance's buckets
    summing to its window, an exact export round trip and the offline
    CLI's attribution equal to the run's.  Traces go to ``tmp``.  Returns
    the gate run's launches."""
    from repro_torch.obs import attribute, load_trace, span_categories, to_chrome
    from repro_torch.obs.critical import PRECEDENCE
    from repro_torch.obs.recorder import created_count

    t_phase = time.perf_counter()
    walls = {"untraced": [], "traced": []}
    gc_s = {"untraced": [], "traced": []}
    gc_runs = {"untraced": [], "traced": []}
    problems = []
    for i in range(TRACE_RUNS):
        for mode in ("untraced", "traced"):
            n0 = created_count()
            trace = os.path.join(tmp, f"t{i}.json") if mode == "traced" else None
            with GcClock() as clock:
                report, _, _, wall = workflow(core, dev, seed + 1, verify=False,
                                              trace=trace)
            made = created_count() - n0
            if made != (1 if trace else 0):
                problems.append(f"{mode} run {i} created {made} recorders")
            walls[mode].append(wall / STEPS)
            gc_s[mode].append(clock.seconds)
            gc_runs[mode].append(clock.collections)
    del report
    alive = live_recorders()   # after the loop, so no run starts on a swept heap
    if alive:
        problems.append(f"{alive} recorders outlived their runs")
    path = os.path.join(tmp, "trace.json")
    build.reset_launch_counts()
    report, calls, failures, wall = workflow(core, dev, seed, verify=True,
                                             trace=path)
    launches = build.launch_counts(["pack_blocks", "pack_cols"])
    if failures:
        problems.append(f"blocks differ from the field: {failures[:5]}")
    if launches != {k: untraced[k] for k in launches}:
        problems.append(f"traced launches {launches}, untraced {untraced}")
    spans = load_trace(path)
    layers = span_categories(spans)
    if not TRACE_LAYERS <= set(layers):
        problems.append(f"spans cover {layers}, not {sorted(TRACE_LAYERS)}")
    att = report.critical_path
    buckets = PRECEDENCE + ("compute",)
    worst_sum = max(abs(sum(row[b] for b in buckets) - row["window_s"])
                    for row in att["instances"].values())
    if worst_sum > 1e-9:
        problems.append(f"buckets miss a window by {worst_sum} s")
    with open(path) as f:
        doc = json.load(f)
    if to_chrome(spans) != doc:
        problems.append("exporting the loaded trace gives another document")
    cli, mods = cli_report(path)
    banned = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                            "ml_dtypes", "repro"))
    if banned:
        problems.append(f"the CLI imported {banned[:5]}")
    if cli != json.loads(json.dumps(attribute(spans))):
        problems.append("the CLI's attribution differs from the loaded trace's")
    if not attribution_close(cli, json.loads(json.dumps(att))):
        problems.append("the CLI's attribution differs from the run's")
    crit = att["critical"]
    u, t = statistics.median(walls["untraced"]), statistics.median(walls["traced"])
    emit({"phase": "trace", "steps": STEPS, "runs": TRACE_RUNS,
          "wall_s_per_step_untraced": walls["untraced"],
          "wall_s_per_step_traced": walls["traced"],
          "median_untraced": u, "median_traced": t, "traced_over_untraced": t / u,
          "gc_s_untraced": gc_s["untraced"], "gc_s_traced": gc_s["traced"],
          "gc_collections_untraced": gc_runs["untraced"],
          "gc_collections_traced": gc_runs["traced"], "recorders_alive": alive,
          "gate_wall_s": wall, "spans": report.trace_spans, "layers": layers,
          "trace_bytes": os.path.getsize(path), "launches": launches,
          "reshard_calls": calls, "worst_bucket_sum_error_s": worst_sum,
          "critical": crit, "instances": att["instances"],
          "critical_steps": att["steps"],
          "edges": {e: {k: r[k] for k in ("blocked_s", "prep_s", "bytes")}
                    for e, r in att["edges"].items()},
          "cli_modules": len(mods), "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
    return launches


# --------------------------------------------------------------- phase 18
def quiet(fn, *args, **kw):
    """``fn`` with the example's prints kept out of the script's output."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def traced_recount(evolve_fn, rho, snapshots):
    """What the traced example's reeber counts, in a plain loop: each of
    its two instances raveled its slab, took it for the global field and
    counted its ranks' half."""
    out, grid = [], rho.shape[0]
    for t in range(snapshots):
        rho = evolve_fn(rho, t)
        n = 0
        for i in range(2):
            slab = rho[i * grid // 2:(i + 1) * grid // 2].reshape(-1)
            half = slab.numel() // 2
            n += int((slab[i * half:(i + 1) * half] > THRESHOLD).sum())
        out.append(n)
    return out


def spill_into(mod, tmp):
    """``mod`` with its workflows' checkpoints kept under ``tmp``."""
    mod.Wilkins = functools.partial(mod.Wilkins, spill_dir=tmp)
    return mod


def traced_example_phase(build, dev, seed, tmp):
    """Phase 18: ``examples/torch_cosmology_traced.py``'s ``run`` at 256^3
    float64 from a seeded field, crash-free and traced with reeber[1]
    crashing at recv step 2.  Gates: the example's own acceptance (one
    restart, every layer), halo counts equal to the crash-free run's and
    to a plain recount, K1 launched once per rank block reeber's reshard
    returned and K2 never.  The trace and the checkpoints go to ``tmp``."""
    mod = spill_into(example("torch_cosmology_traced"), tmp)
    t_phase = time.perf_counter()
    rho0 = initial_density(dev, seed, torch.float64)
    plain = traced_recount(mod.evolve, rho0, TRACED_SNAPSHOTS)
    path = os.path.join(tmp, "trace.json")
    rows, launches, problems = {}, {}, []
    for tag, faults, trace in (("crash_free", None, None),
                               ("faulted", mod.FAULT, path)):
        build.reset_launch_counts()
        t0 = time.perf_counter()
        report, counts, blocks = quiet(
            mod.run, dev, grid=SHAPE[0], snapshots=TRACED_SNAPSHOTS, rho0=rho0,
            faults=faults, trace=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[tag] = build.launch_counts(["pack_blocks", "pack_cols"])
        if launches[tag] != {"pack_blocks": blocks, "pack_cols": 0} or not blocks:
            problems.append(f"{tag}: launches {launches[tag]} for {blocks} blocks")
        if counts != plain:
            problems.append(f"{tag}: counts {counts} != plain {plain}")
        rows[tag] = {"wall_s": wall, "wall_s_per_snapshot": wall / TRACED_SNAPSHOTS,
                     "counts": counts, "rank_blocks": blocks,
                     "restarts": [e["task"] for e in report.restarts],
                     "spans": report.trace_spans}
        if trace:
            try:
                spans = mod.accept(report, trace)
                rows[tag]["layers"] = sorted({s["cat"] for s in spans})
                rows[tag]["critical"] = report.critical_path["critical"]
            except AssertionError as e:
                problems.append(f"{tag}: the example's acceptance failed: {e}")
    emit({"phase": "traced_example", "grid": SHAPE[0], "dtype": "float64",
          "snapshots": TRACED_SNAPSHOTS, "runs": rows, "launches": launches,
          "plain_recount_equal": not any("plain" in p for p in problems),
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
    return launches


# --------------------------------------------------------------- phase 19
def examples_faults_phase(build, dev, seed, tmp):
    """Phase 19: the fault-tolerant and elastic examples' ``run`` at 256^3
    float64 from a seeded field, 8 snapshots.  Gates: each faulted run's
    counts byte-identical to its crash-free run's, which equal a plain
    recount; two restarts and viz dropped, one (2, 1) rescale by policy,
    one by the stall watchdog (``stall_timeout_s: 0.3`` as the example
    sets it).  Neither example reshards, so no kernel launches.  The
    checkpoints go to ``tmp``."""
    ft = spill_into(example("torch_cosmology_faulttolerant"), tmp)
    el = spill_into(example("torch_cosmology_elastic"), tmp)
    t_phase = time.perf_counter()
    rho0 = initial_density(dev, seed, torch.float64)
    rho, per_snap, per_row = rho0, [], []
    for t in range(FT_SNAPSHOTS):
        rho = ft.evolve(rho, t)
        per_row.append((rho > THRESHOLD).sum(dim=(1, 2)))
        per_snap.append(int(per_row[-1].sum()))
    per_row = torch.stack(per_row, dim=1).cpu().numpy()
    rows, problems = {}, []
    build.reset_launch_counts()

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        out = quiet(fn, *args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for tag, faults in (("crash_free", None), ("faulted", ft.FAULTS)):
        (report, counts), wall = timed(ft.run, dev, grid=SHAPE[0],
                                       snapshots=FT_SNAPSHOTS, rho0=rho0,
                                       faults=faults)
        if counts != per_snap:
            problems.append(f"faulttolerant {tag}: {counts} != plain {per_snap}")
        restarts = sorted(e["task"] for e in report.restarts)
        want = (["nyx", "reeber"], [("viz", 0)]) if faults else ([], [])
        if (restarts, report.dropped_tasks) != want:
            problems.append(f"faulttolerant {tag}: restarts {restarts}, "
                            f"dropped {report.dropped_tasks}")
        rows[f"faulttolerant_{tag}"] = {
            "wall_s": wall, "wall_s_per_snapshot": wall / FT_SNAPSHOTS,
            "restarts": restarts, "dropped": report.dropped_tasks,
            "halo_cells_per_snapshot": counts}
    want = {"crash_free": [], "crash": [(2, 1, "policy")],
            "stall": [(2, 1, "stall")]}
    for tag in ("crash_free", "crash", "stall"):
        (report, counts), wall = timed(el.run, tag, dev, grid=SHAPE[0],
                                       snapshots=FT_SNAPSHOTS, rho0=rho0,
                                       faults=el.FAULTS.get(tag))
        rescales = [(e["old_nslots"], e["new_nslots"], e["trigger"])
                    for e in report.rescales]
        stalls = [{k: e[k] for k in ("instance", "silent_s", "action")}
                  for e in report.stalls]
        if not np.array_equal(counts, per_row):
            problems.append(f"elastic {tag}: counts differ from the plain recount")
        if rescales != want[tag]:
            problems.append(f"elastic {tag}: rescales {rescales}, expected "
                            f"{want[tag]} (stalls {stalls})")
        if tag == "stall" and [s["action"] for s in stalls] != ["rescale"]:
            problems.append(f"elastic stall: stalls {stalls}")
        rows[f"elastic_{tag}"] = {
            "wall_s": wall, "wall_s_per_snapshot": wall / FT_SNAPSHOTS,
            "rescales": [{k: e[k] for k in ("trigger", "cut_step", "latency_s")}
                         for e in report.rescales],
            "stalls": stalls,
            "final_instances": (report.rescales[-1]["new_nslots"]
                                if report.rescales else 2)}
    launches = build.launch_counts(["pack_blocks", "pack_cols"])
    emit({"phase": "examples_faults", "grid": SHAPE[0], "dtype": "float64",
          "snapshots": FT_SNAPSHOTS, "runs": rows, "launches": launches,
          "plain_recount_equal": not any("plain" in p for p in problems),
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
    return launches


# --------------------------------------------------------------- phase 20
def flowcontrol_phase(build, dev):
    """Phase 20: ``examples/torch_cosmology_flowcontrol.py``'s ``run`` at
    256^3 float32, 10 snapshots, ``io_freq: 2``, the paper's action script
    written to a temporary ``action_dirs`` entry.  Gates: the script's
    callback served at every second close and only there, reeber analysed
    ``FLOW_ANALYSED`` (the JAX example's set), each count equal to a plain
    recount of the same field on the card, every payload nyx's own tensor
    on the card with no byte copied."""
    from repro_torch.core.datamodel import reset_transport_stats, transport_stats

    mod = example("torch_cosmology_flowcontrol")
    t_phase = time.perf_counter()
    reset_transport_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    analysed, report, broadcasts = quiet(mod.run, dev, grid=SHAPE[0],
                                         count=FLOW_SNAPSHOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = transport_stats().snapshot()
    launches = build.launch_counts(["pack_blocks", "pack_cols"])
    problems = []
    closes = [int(b.split("=", 1)[1].split()[0]) for b in broadcasts]
    if closes != [2 * (t + 1) for t in range(FLOW_SNAPSHOTS)]:
        problems.append(f"served at closes {closes}")
    if (report.total_served, report.total_dropped) != (5, 5):
        problems.append(f"served {report.total_served}, skipped "
                        f"{report.total_dropped}, expected 5 and 5")
    if sorted(analysed) != FLOW_ANALYSED:
        problems.append(f"analysed {sorted(analysed)}, the JAX example {FLOW_ANALYSED}")
    plain = {t: int(mod.find_halos(rho)) for t, rho in
             mod.snapshots(SHAPE[0], FLOW_SNAPSHOTS, dev) if t in analysed}
    if {t: v[0] for t, v in analysed.items()} != plain:
        problems.append("halo counts differ from the plain recount")
    bad = [t for t, (_, d, shape, shared) in analysed.items()
           if d != str(dev) or shape != SHAPE or not shared]
    if bad or stats["bytes_copied"] != 0:
        problems.append(f"payloads off the card, cut or copied at {bad}; "
                        f"{stats['bytes_copied']} bytes copied")
    emit({"phase": "flowcontrol", "grid": SHAPE[0], "snapshots": FLOW_SNAPSHOTS,
          "wall_s": wall, "wall_s_per_snapshot": wall / FLOW_SNAPSHOTS,
          "served": report.total_served, "skipped": report.total_dropped,
          "analysed": sorted(analysed), "serve_closes": closes,
          "halo_cells": {t: v[0] for t, v in sorted(analysed.items())},
          "plain_recount_equal": not any("plain" in p for p in problems),
          "copies": stats["copies"], "bytes_copied": stats["bytes_copied"],
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
    return launches


# --------------------------------------------------------------- phase 21
def quickstart_phase(build, dev):
    """Phase 21: ``examples/torch_quickstart.py``'s ``run`` (Listing 1,
    N = 1,000,000, 5 timesteps) on the card.  Gates: consumer1's total 10,
    consumer2 launched once per timestep with data, every received tensor
    sharing the producer's storage, no byte copied, and the particle means
    equal to a plain recount of the reference's draw on the card."""
    mod = example("torch_quickstart")
    t_phase = time.perf_counter()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = quiet(mod.run, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launch_counts(["pack_blocks", "pack_cols"])
    report, stats = out["report"], out["stats"]
    plain = [mod.particles(t, mod.N, dev).mean(dim=0, dtype=torch.float64)
             for t in range(mod.STEPS)]
    problems = []
    if out["total"] != sum(range(mod.STEPS)):
        problems.append(f"consumer1's total {out['total']}")
    if len(out["means"]) != mod.STEPS:
        problems.append(f"consumer2 analysed {len(out['means'])} timesteps")
    elif not all(torch.equal(a, b) for a, b in zip(out["means"], plain)):
        problems.append("particle means differ from the plain recount")
    if len(out["shared"]) != 2 * mod.STEPS or not all(out["shared"]):
        problems.append(f"received tensors not the producer's: {out['shared']}")
    if stats["copies"] or stats["bytes_copied"]:
        problems.append(f"{stats['copies']} copies, {stats['bytes_copied']} bytes")
    emit({"phase": "quickstart", "n": mod.N, "steps": mod.STEPS, "wall_s": wall,
          "wall_s_per_step": wall / mod.STEPS, "total": out["total"],
          "consumer2_launches": report.task_launches.get(("consumer2", 0)),
          "means": [m.tolist() for m in out["means"]],
          "shared_storage": all(out["shared"]), "copies": stats["copies"],
          "bytes_copied": stats["bytes_copied"], "served": report.total_served,
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise RuntimeError("; ".join(problems))
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
    if not os.path.isdir(os.path.join(SRC, "repro_torch")) or not os.path.isdir(
            os.path.join(ROOT, "examples")):
        print(f"chip_smoke: no repro_torch package under {SRC} or no "
              f"examples beside it", file=sys.stderr)
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
    main_plans = plan_descriptors(plan_cache())
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
    ensemble_doc = ensemble_phase(dev, args.seed)
    scheduler_doc, scheduler_plans = scheduler_phase(dev, args.seed)
    analysis_phase({"main_path": workflow_doc(), "faults": fault_doc(),
                    "ensemble": ensemble_doc, "scheduler": scheduler_doc},
                   main_plans + scheduler_plans)

    explore_phase()
    parallel_k3 = parallel_phase(build, dev, args.seed)
    dryrun_launches = dryrun_phase(build, dev, args.seed)
    insitu_launches = insitu_phase(build, dev)
    def scratch(phase, *args):
        with tempfile.TemporaryDirectory(prefix="wilkins_smoke_") as tmp:
            return phase(*args, tmp)

    trace_launches = scratch(trace_phase, core, build, dev, args.seed,
                             {k: launches[k] for k in ("pack_blocks", "pack_cols")})
    example_launches = {f"traced_{run}": n for run, n in
                        scratch(traced_example_phase, build, dev, args.seed).items()}
    example_launches["faulttolerant_elastic"] = scratch(
        examples_faults_phase, build, dev, args.seed)
    example_launches["flowcontrol"] = flowcontrol_phase(build, dev)
    example_launches["quickstart"] = quickstart_phase(build, dev)

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
    for k in kernels:
        key = ("flash_attention:float32" if k["name"] == "flash_attention"
               and k["dtype"] == "float32" else k["name"])
        # phase 9 by part and arch: the bf16 steps, the float32 gates, the
        # accumulation runs, launch.train's resume; phase 16's in situ run
        k["launches_train"] = {part: by_key.get(key, {})
                               for part, by_key in train_launches.items()}
        k["launches_insitu"] = insitu_launches.get(key, 0)
        # phase 14 (b): phi3.5-moe's float32 forward through the EP schedule
        k["launches_parallel"] = (parallel_k3 if k["name"] == "flash_attention"
                                  and k["dtype"] == "float32" else 0)
        # phase 15 (b): the dry run's cell run for real takes the plain path
        k["launches_dryrun"] = dryrun_launches.get(k["name"], 0)
        # phase 17's traced gate run; phases 18-21, by example run
        k["launches_trace"] = trace_launches.get(k["name"], 0)
        k["launches_examples"] = {run: n.get(k["name"], 0)
                                  for run, n in example_launches.items()}
    emit({"phase": "run", "run_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
