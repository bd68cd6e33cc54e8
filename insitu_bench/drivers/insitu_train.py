"""Traffic driver ``insitu_train``: a Mamba-2 language model trained by the
port's training step while an in situ evaluator, coupled by
``repro_torch.core.Wilkins`` under ``io_freq: -1`` (latest), scores the
newest weights (the trainer/evaluator pattern of the repository's
``examples/torch_train_insitu_eval.py``, at the configuration's widths).

Set-up builds the model empty, fills it with the seed's weights
(``lib.inputs.mamba2_weights``), and drives the one training state through
its first ``checked_steps`` steps by the window's own call and feed; the
last of them writes a snapshot that the evaluator scores, which warms the
evaluator; each of these steps is waited for.  The window opens after that
score.  In it the trainer dispatches up to ``ahead_steps`` steps beyond the
newest one whose loss it has read, so that the card stays fed while the
host stands still; a step ends when its loss is read.  When the window's
seconds are up the trainer dispatches nothing more, reads every loss it
dispatched, waits for the card and closes the window.  Every
``snapshot_every`` steps the trainer writes every parameter (copies, as the
step updates them in place) as one h5 file, after reading the losses of the
steps before it; each snapshot is timed by the benchmark's own synchronised
span.

The comparison (run once the window has closed, the peak memory read and
the training state freed), against ``reference.mamba2`` from the same
weights and batches: the first gradient by leaf (the optimizer's first
moment after step 1 over 1 - b1) and the change of each leaf over the
checked steps; every scored snapshot's bits against the trainer's at that
step (a checksum per leaf).  Reported beside them, not compared, since no
control or fault separates them from sound runs (PERF.md): the checked
steps' losses, and the evaluator's held-out loss of the warm snapshot
against the reference's on the weights it was handed (kept on the host
meanwhile).
"""

from __future__ import annotations

import collections
import gc
import math
import os
import statistics
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from insitu_bench import roofline
from insitu_bench.lib import devtrace, inputs
from insitu_bench.lib.host import HostSpans
from insitu_bench.reference import mamba2 as ref

WORKFLOW = {"tasks": [
    {"func": "trainer", "nprocs": 1,
     "outports": [{"filename": "ckpt*.h5",
                   "dsets": [{"name": "/model/*", "memory": 1},
                             {"name": "/meta/*", "memory": 1}]}]},
    {"func": "evaluator", "nprocs": 1,
     "inports": [{"filename": "ckpt*.h5", "io_freq": -1,
                  "dsets": [{"name": "/model/*", "memory": 1},
                            {"name": "/meta/*", "memory": 1}]}]},
]}


def widths(cfg: Dict[str, Any]) -> Dict[str, Any]:
    m = cfg["mamba2_defaults"]
    return {"d_model": cfg["d_model"], "n_layer": cfg["n_layer"],
            "vocab": cfg["run"]["vocab"], "d_state": m["d_state"],
            "headdim": m["headdim"], "expand": m["expand"], "ngroups": m["ngroups"],
            "d_conv": m["d_conv"], "chunk_size": m["chunk_size"],
            "norm_eps": cfg["run"]["norm_eps"]}


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` of the configuration."""
    from repro_torch.models.config import ModelConfig

    w, r = widths(cfg), cfg["run"]
    return ModelConfig(
        name=cfg["name"], family="ssm", n_layers=w["n_layer"], d_model=w["d_model"],
        d_ff=0, vocab=w["vocab"], ssm_state=w["d_state"], ssm_head_dim=w["headdim"],
        ssm_expand=w["expand"], ssm_groups=w["ngroups"], conv_width=w["d_conv"],
        ssd_chunk=w["chunk_size"], tie_embeddings=cfg["tie_embeddings"],
        norm_eps=w["norm_eps"], dtype=r["dtype"], opt_state_dtype=r["opt_state_dtype"],
        remat=r["remat"], use_flash=r["use_flash"], loss_chunk=r["loss_chunk"],
        subquadratic=True)


def checksums(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Each tensor's bit patterns summed as integers (int64, on its device)."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.stack([t.detach().contiguous().view(ints[t.element_size()])
                        .sum(dtype=torch.int64) for t in tensors])


def worst_leaf_gap(got: List[float], want: List[float], keep=None) -> float:
    """max over leaves of |got - want| / max(want, the median leaf's want)."""
    floor = statistics.median(want)
    idx = range(len(want)) if keep is None else keep
    return max((abs(got[i] - want[i]) / max(want[i], floor) for i in idx),
               default=0.0)


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def moved_leaves(first: List[float]) -> List[int]:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's; the others move under Adam by round-off
    alone and are left out of the change."""
    floor = 1e-3 * statistics.median(first)
    return [i for i, g in enumerate(first) if g >= floor]


def compare(got: Dict[str, List[float]], want: Dict[str, List[float]]
            ) -> Dict[str, float]:
    """The cell's numbers of the training step: the first gradient and the
    change over the checked steps of ``got`` (the program's, or a control's)
    against the reference's ``want``, each by worst leaf."""
    return {"grad_gap": worst_leaf_gap(got["first"], want["first"]),
            "change_gap": worst_leaf_gap(got["change"], want["change"],
                                         moved_leaves(want["first"]))}


def train_batch(cell, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    tr = cell.traffic
    return inputs.token_batch(seed, "train", step, tr["batch"], tr["seq"],
                              tr["token_vocab"], device)


def held_out(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    tr = cell.traffic
    return inputs.token_batch(seed, "eval", 0, tr["eval_batch"], tr["eval_seq"],
                              tr["token_vocab"], device)


def reference_readings(cell, seed: int, device, names: List[str],
                       precision: str = "fp32", rows: Optional[int] = None,
                       grad_hook: Optional[ref.GradHook] = None) -> Dict[str, Any]:
    """The plain reference over the checked steps from the seed's weights and
    batches (their first ``rows`` rows, where given): each step's loss, the
    first gradient and the change by leaf in ``names``' order, and its
    weights after the steps (``params``)."""
    cfg = cell.config
    w = widths(cfg)
    p = {n: t.float() for n, t in inputs.mamba2_weights(seed, w, device)}
    bf16 = [n for n, _, dt, _, _ in inputs.mamba2_leaves(w) if dt == "bfloat16"]
    batches = [train_batch(cell, seed, s, device)
               for s in range(1, cell.traffic["checked_steps"] + 1)]
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
    losses, first = ref.train(p, batches, w, cfg["optimizer"], bf16, precision, grad_hook)
    change = {n: float((p[n] - t.float()).norm())
              for n, t in inputs.mamba2_weights(seed, w, device)}
    return {"losses": losses, "first": [first[n] for n in names],
            "change": [change[n] for n in names], "params": p}


def run(ctx) -> Dict[str, Any]:
    from repro_torch.core import Wilkins, h5
    from repro_torch.models.registry import get_family
    from repro_torch.models.ssm import MambaLM
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.optim import adamw_init

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    w, o = widths(cfg), cfg["optimizer"]
    mcfg = port_config(cfg)
    ocfg = AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                       weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                       warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                       min_lr_ratio=o["min_lr_ratio"], state_dtype=mcfg.opt_state_dtype)
    batch, seq = tr["batch"], tr["seq"]
    checked, every = tr["checked_steps"], tr["snapshot_every"]
    cuda = dev.type == "cuda"

    parts = {"start": time.monotonic() - ctx.t_start}
    model = MambaLM(mcfg, dev)
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    made = set()
    with torch.no_grad():
        for name, t in inputs.mamba2_weights(ctx.seed, w, dev):
            params[name].copy_(t)
            made.add(name)
    if made != set(names):
        raise RuntimeError(f"weights made for {sorted(made ^ set(names))[:5]} "
                           f"do not match the model's parameters")
    del params
    box = {"state": TrainState(model, adamw_init(model, ocfg), np.zeros(2, np.uint32))}
    step_fn = make_train_step(mcfg, ocfg)
    eval_model = MambaLM(mcfg, dev)
    eval_params = list(eval_model.parameters())
    fam = get_family(mcfg)
    held = held_out(ctx.cell, ctx.seed, dev)
    host = HostSpans(ctx.trace)
    prof = devtrace.Profiler() if ctx.trace else None
    warm_eval = threading.Event()
    rec: Dict[str, Any] = {"losses": [], "first": None, "change": None, "sums": {},
                           "snap_ms": [], "evals": [], "nonfinite": 0, "ends": [],
                           "parts": parts}
    parts["built"] = time.monotonic() - ctx.t_start

    def sync():
        if cuda:
            torch.cuda.current_stream(dev).synchronize()

    def snapshot(step: int) -> None:
        sync()
        t_a = time.monotonic()
        with host.span("trainer.snapshot"):
            snap = [p.detach().clone() for p in model.parameters()]
            rec["sums"][step] = checksums(snap)
            with h5.File(f"ckpt{step:06d}.h5", "w") as f:
                for i, p in enumerate(snap):
                    f.create_dataset(f"/model/p{i}", data=p, copy=False)
                f.create_dataset("/meta/step", data=np.array([step], np.int64))
            sync()
        rec["snap_ms"].append((step, 1e3 * (time.monotonic() - t_a)))

    pending: collections.deque = collections.deque()   # losses not yet read
    rec["waited_s"] = 0.0

    def settle(keep: int) -> None:
        """Read the losses of the window's dispatched steps, oldest first,
        until ``keep`` are left unread; a step ends when its loss is read."""
        while len(pending) > keep:
            t_a = time.monotonic()
            with host.span("trainer.wait"):
                loss = float(pending.popleft())
            rec["ends"].append(time.monotonic())
            rec["waited_s"] += rec["ends"][-1] - t_a
            rec["nonfinite"] += not math.isfinite(loss)

    def trainer():
        step = 0
        while True:
            step += 1
            if step == checked + 1:
                if not warm_eval.wait(timeout=600):
                    raise TimeoutError("the evaluator never scored the warm snapshot")
                rec["t0"] = time.monotonic()
                parts["warm_eval"] = rec["t0"] - ctx.t_start
                if prof is not None:
                    prof.schedule(ctx.profile_start(rec["t0"]))
            data = train_batch(ctx.cell, ctx.seed, step, dev)
            with host.span("trainer.step"):
                box["state"], metrics = step_fn(box["state"], data)
            if step <= checked:
                rec["losses"].append(float(metrics["loss"]))   # waits for the step
                parts[f"step{step}"] = time.monotonic() - ctx.t_start
            else:
                pending.append(metrics["loss"])
            del metrics, data
            if step == 1:
                m = box["state"].opt.m
                rec["first"] = torch.stack([(m[n].float() / (1 - o["b1"])).norm()
                                            for n in names]).tolist()
            if step == checked:
                live = dict(model.named_parameters())
                with torch.no_grad():    # no graph keeps each leaf's difference
                    change = {n: (live[n].float() - t.float()).norm()
                              for n, t in inputs.mamba2_weights(ctx.seed, w, dev)}
                rec["change"] = torch.stack([change[n] for n in names]).tolist()
                snapshot(step)
            elif step > checked and step % every == 0:
                settle(0)
                snapshot(step)
            if step > checked and time.monotonic() >= rec["t0"] + ctx.seconds:
                settle(0)
                sync()
                rec["t_end"] = time.monotonic()
                rec["steps"] = step - checked
                return
            settle(tr["ahead_steps"])

    def evaluator():
        while True:
            with host.span("evaluator.wait"):
                f = h5.File("ckpt*.h5", "r")
            if f is None:
                return
            step = int(np.asarray(f["/meta/step"][:]).reshape(-1)[0])
            with torch.no_grad():
                with host.span("evaluator.load"):
                    for i, p in enumerate(eval_params):
                        p.copy_(f[f"/model/p{i}"][:])
                    sums = checksums(eval_params)
                with host.span("evaluator.score"):
                    loss = float(fam.loss_fn(eval_model, mcfg, held))
            rec["evals"].append((step, loss, sums))
            if step == checked:
                # the warm snapshot as the evaluator scored it, kept on the
                # host for the comparison after the window
                rec["warm_snap"] = [p.detach().to("cpu", copy=True) for p in eval_params]
                warm_eval.set()

    trace_path = os.path.join(ctx.tmpdir, "train_trace.json") if ctx.trace else None
    wf = Wilkins(WORKFLOW, {"trainer": trainer, "evaluator": evaluator},
                 devices=[dev], spill_dir=os.path.join(ctx.tmpdir, "spill"))
    try:
        wf.run(timeout=ctx.seconds + 900, trace=trace_path)
    finally:
        sync()
        trace = prof.finish(rec.get("t_end", 0.0)) if prof is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the program's state goes before the reference runs
    sums = {s: v.cpu() for s, v in rec["sums"].items()}
    evals = [(s, loss, v.cpu()) for s, loss, v in rec["evals"]]
    box.clear()
    del wf, step_fn, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref.no_tf32()
    warm_loss = next(loss for st, loss, _ in evals if st == checked)
    del eval_params, eval_model
    with torch.no_grad():
        snap = {n: t.to(dev).float() for n, t in zip(names, rec.pop("warm_snap"))}
        want_eval = float(ref.loss(snap, held, w))
    del snap
    gc.collect()
    want = reference_readings(ctx.cell, ctx.seed, dev, names)
    del want["params"]
    gaps = compare({"first": rec["first"], "change": rec["change"]}, want)
    mismatched = 0
    for s, _, got in evals:
        mismatched += (int((got != sums[s]).sum()) if s in sums else got.numel())
    limits = ctx.cell.workload["limits"]
    tokens = batch * seq
    nc = -(-seq // w["chunk_size"])
    h = w["expand"] * w["d_model"] // w["headdim"]
    return {
        "t0": rec["t0"], "t_end": rec["t_end"], "window_s": rec["t_end"] - rec["t0"],
        "setup_s": rec["t0"] - ctx.t_start,
        "steps": rec["steps"], "tokens_per_step": tokens, "step_ends": rec["ends"],
        "attempted": rec["steps"], "failed": rec["nonfinite"],
        "memory_peak_bytes": peak,
        "snapshot_ms": [ms for s, ms in rec["snap_ms"] if s > checked],
        "scored": [s for s, _, _ in evals],
        "model_flops_per_step": roofline.mamba2_step_flops(w, batch, seq, w["vocab"]),
        "kernel_work": {"ssd_tc_kernel": roofline.ssd_work(
            batch, nc, w["chunk_size"], h, w["headdim"], w["ngroups"], w["d_state"])},
        "trace": trace, "host_spans": host.items,
        "readings": {"losses": rec["losses"], "ref_losses": want["losses"],
                     "loss_gaps": [rel_gap(a, b) for a, b in
                                   zip(rec["losses"], want["losses"])],
                     "eval_loss": warm_loss, "ref_eval_loss": want_eval,
                     "eval_loss_gap": rel_gap(warm_loss, want_eval),
                     "leaves_left_out": len(names) - len(moved_leaves(want["first"])),
                     "dispatch": {"ahead_steps": tr["ahead_steps"],
                                  "waited_s": rec["waited_s"]},
                     "setup_parts_s": rec["parts"]},
        "checks": [
            {"name": "grad_gap", "value": gaps["grad_gap"], "limit": limits["grad_gap"]},
            {"name": "change_gap", "value": gaps["change_gap"],
             "limit": limits["change_gap"]},
            {"name": "snapshot_mismatches", "value": mismatched,
             "limit": limits["snapshot_mismatches"]},
        ],
    }
