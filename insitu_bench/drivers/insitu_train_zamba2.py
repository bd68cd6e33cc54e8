"""Traffic mix runner ``insitu_train_zamba2``: the ``insitu_train`` loop (a model
trained by the port's training step while an in situ evaluator, coupled by
``repro_torch.core.Wilkins`` under ``io_freq: -1``, scores the newest
weights) with the Zamba2 configuration of the port's ``zamba2`` family in
the place of Mamba-2.

Set-up, window, snapshots and the comparison are ``insitu_train``'s,
which see: the weights come from ``zamba2_weights``,
the plain reference is ``reference.zamba2``, and the model's operations
come from ``roofline.zamba2``.  The raw result holds every key of
``insitu_train``'s, with K4's work in ``kernel_work`` (the SSD scan at
Zamba2's shape), and its own: ``attn_work``, the work of one K3 launch
(the bf16 ``fa_wgmma_kernel`` at head dim 224), which ``attn_roofline``
reads.  In a traced run the device trace's session opens at the first
step boundary past the sub-window's start, not mid-step, while the
evaluator launches nothing (``start_profiler``).
"""

from __future__ import annotations

import collections
import gc
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from insitu_bench import roofline
from insitu_bench.drivers.insitu_train import (WORKFLOW, checksums, compare,
                                               held_out, moved_leaves, rel_gap,
                                               train_batch)
from insitu_bench.lib import devtrace, inputs
from insitu_bench.lib.host import HostSpans
from insitu_bench.reference import zamba2 as ref
from insitu_bench.roofline import zamba2 as rz

K3 = "fa_wgmma_kernel"
K4 = "ssd_tc_kernel"


def widths(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration file's widths under the reference's names."""
    d = cfg["hidden_size"]
    return {"d_model": d, "n_layer": cfg["num_hidden_layers"],
            "vocab": cfg["run"]["vocab"], "d_state": cfg["mamba_d_state"],
            "headdim": cfg["mamba_headdim"], "expand": cfg["mamba_expand"],
            "ngroups": cfg["mamba_ngroups"], "d_conv": cfg["mamba_d_conv"],
            "chunk_size": cfg["chunk_size"], "norm_eps": cfg["rms_norm_eps"],
            "heads": cfg["num_attention_heads"],
            "head_dim": cfg["attention_head_dim"],
            "d_ff": cfg["intermediate_size"], "adapter_rank": cfg["adapter_rank"],
            "hybrid_layers": list(cfg["hybrid_layer_ids"]),
            "shared_blocks": cfg["num_mem_blocks"], "rope_theta": cfg["rope_theta"],
            "dt_min": cfg["time_step_min"], "dt_max": cfg["time_step_max"],
            "dt_floor": cfg["time_step_floor"]}


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` of the configuration (family ``zamba2``)."""
    from repro_torch.models.config import ModelConfig

    w, r = widths(cfg), cfg["run"]
    return ModelConfig(
        name=cfg["name"], family="zamba2", n_layers=w["n_layer"],
        d_model=w["d_model"], n_heads=w["heads"], n_kv_heads=w["heads"],
        head_dim=w["head_dim"], d_ff=w["d_ff"], vocab=w["vocab"],
        ssm_state=w["d_state"], ssm_head_dim=w["headdim"],
        ssm_expand=w["expand"], ssm_groups=w["ngroups"], conv_width=w["d_conv"],
        ssd_chunk=w["chunk_size"], hybrid_layers=tuple(w["hybrid_layers"]),
        shared_blocks=w["shared_blocks"], adapter_rank=w["adapter_rank"],
        rope_theta=float(w["rope_theta"]), tie_embeddings=cfg["run"]["tie_embeddings"],
        norm_eps=w["norm_eps"], dtype=r["dtype"], opt_state_dtype=r["opt_state_dtype"],
        remat=r["remat"], use_flash=r["use_flash"], loss_chunk=r["loss_chunk"])


def zamba2_leaves(w: Dict[str, Any]) -> List[Tuple[str, tuple, str, str, float]]:
    """``(name, shape, dtype, init, std)`` of every parameter of the port's
    ``Zamba2LM`` of widths ``w``, in its ``named_parameters`` order, with
    ``lib.inputs.mamba2_leaves``' initialisation: ``init`` is ``normal``
    (N(0, std^2) in bf16; the embedding 0.02, every other matrix and the
    convolution 1/sqrt(3 fan_in), PyTorch's default standard deviation, the
    Mamba out-projection's over sqrt(n_layer)), ``one``, ``a_log`` or
    ``dt_bias`` (float32)."""
    d, n_layer = w["d_model"], w["n_layer"]
    di = w["expand"] * d
    g, n, hd, width = w["ngroups"], w["d_state"], w["headdim"], w["d_conv"]
    h = di // hd
    conv_dim = di + 2 * g * n
    f, r = w["d_ff"], w["adapter_rank"]
    qkv = w["heads"] * w["head_dim"]

    def std(fan_in):
        return 1 / math.sqrt(3 * fan_in)

    out: List[Tuple[str, tuple, str, str, float]] = [
        ("embed.tok", (inputs.padded_rows(w["vocab"]), d), "bfloat16", "normal", 0.02)]
    for i in range(n_layer):
        p = f"layers.{i}."
        out += [
            (p + "ln.scale", (d,), "float32", "one", 0.0),
            (p + "mamba.in_proj", (d, 2 * di + 2 * g * n + h), "bfloat16",
             "normal", std(d)),
            (p + "mamba.conv_w", (width, conv_dim), "bfloat16", "normal", std(width)),
            (p + "mamba.conv_b", (conv_dim,), "bfloat16", "normal", std(width)),
            (p + "mamba.A_log", (h,), "float32", "a_log", 0.0),
            (p + "mamba.D", (h,), "float32", "one", 0.0),
            (p + "mamba.dt_bias", (h,), "float32", "dt_bias", 0.0),
            (p + "mamba.norm.scale", (di,), "float32", "one", 0.0),
            (p + "mamba.out_proj", (di, d), "bfloat16", "normal",
             std(di) / math.sqrt(n_layer)),
        ]
    for b in range(w["shared_blocks"]):
        p = f"blocks.{b}."
        out += [(p + "wq", (2 * d, qkv), "bfloat16", "normal", std(2 * d)),
                (p + "wk", (2 * d, qkv), "bfloat16", "normal", std(2 * d)),
                (p + "wv", (2 * d, qkv), "bfloat16", "normal", std(2 * d)),
                (p + "wo", (qkv, d), "bfloat16", "normal", std(qkv)),
                (p + "gate_up", (d, 2 * f), "bfloat16", "normal", std(d)),
                (p + "down", (f, d), "bfloat16", "normal", std(f)),
                (p + "ln_in.scale", (2 * d,), "float32", "one", 0.0),
                (p + "ln_ff.scale", (d,), "float32", "one", 0.0)]
    for c in range(len(w["hybrid_layers"])):
        p = f"calls.{c}."
        out += [(p + "adapter_in", (d, r), "bfloat16", "normal", std(d)),
                (p + "adapter_out", (r, 2 * f), "bfloat16", "normal", std(r)),
                (p + "linear", (d, d), "bfloat16", "normal", std(d))]
    out.append(("ln_f.scale", (d,), "float32", "one", 0.0))
    return out


def zamba2_weights(seed: int, w: Dict[str, Any], device
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter's initial value, in ``zamba2_leaves`` order, drawn as
    ``lib.inputs.mamba2_weights`` draws Mamba-2's: one bf16 N(0, 1) draw
    for all the matrices and biases, scaled per leaf, and one float32
    U(0, 1) draw for A (U(1, 16), its log kept) and dt (log-uniform in
    [time_step_min, time_step_max], floored at time_step_floor, kept as the
    softplus inverse).  Leaves are made one at a time."""
    leaves = zamba2_leaves(w)
    g = inputs.generator(device, seed, "zamba2-weights")
    n_normal = sum(math.prod(s) for _, s, _, init, _ in leaves if init == "normal")
    heads = [s[0] for _, s, _, init, _ in leaves if init == "a_log"]
    normal = torch.randn(n_normal, generator=g, device=device, dtype=torch.bfloat16)
    uni = torch.rand(2 * sum(heads), generator=g, device=device, dtype=torch.float32)
    o_n = o_a = 0
    o_dt = sum(heads)
    lo, hi = math.log(w["dt_min"]), math.log(w["dt_max"])
    for name, shape, dtype, init, std in leaves:
        n = math.prod(shape)
        if init == "normal":
            t = normal[o_n:o_n + n].view(shape) * std
            o_n += n
        elif init == "one":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        elif init == "a_log":
            t = torch.log(1.0 + 15.0 * uni[o_a:o_a + n])
            o_a += n
        else:  # dt_bias
            dt = torch.exp(lo + (hi - lo) * uni[o_dt:o_dt + n]).clamp(min=w["dt_floor"])
            t = dt + torch.log(-torch.expm1(-dt))
            o_dt += n
        yield name, t.to(getattr(torch, dtype))


def reference_readings(cell, seed: int, device, names: List[str],
                       precision: str = "fp32", rows: Optional[int] = None,
                       grad_hook: Optional[ref.GradHook] = None,
                       positions: Optional[int] = None) -> Dict[str, Any]:
    """``insitu_train.reference_readings`` for this model: the plain
    reference over the checked steps from the seed's weights and batches
    (their first ``rows`` rows, or their first ``positions`` tokens, where
    given): each step's loss, the first gradient and the change by leaf in
    ``names``' order, and the weights after the steps (``params``)."""
    cfg = cell.config
    w = widths(cfg)
    p = {n: t.float() for n, t in zamba2_weights(seed, w, device)}
    bf16 = [n for n, _, dt, _, _ in zamba2_leaves(w) if dt == "bfloat16"]
    batches = [train_batch(cell, seed, s, device)
               for s in range(1, cell.traffic["checked_steps"] + 1)]
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
    if positions is not None:
        batches = [{k: v[:, :positions] for k, v in b.items()} for b in batches]
    losses, first = ref.train(p, batches, w, cfg["optimizer"], bf16, precision, grad_hook)
    change = {n: float((p[n] - t.float()).norm())
              for n, t in zamba2_weights(seed, w, device)}
    return {"losses": losses, "first": [first[n] for n in names],
            "change": [change[n] for n in names], "params": p}


def run(ctx) -> Dict[str, Any]:
    from repro_torch.core import Wilkins, h5
    from repro_torch.models.registry import get_family
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
    fam = get_family(mcfg)
    model = fam.model(mcfg, dev)
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    made = set()
    with torch.no_grad():
        for name, t in zamba2_weights(ctx.seed, w, dev):
            params[name].copy_(t)
            made.add(name)
    if made != set(names):
        raise RuntimeError(f"weights made for {sorted(made ^ set(names))[:5]} "
                           f"do not match the model's parameters")
    del params
    box = {"state": TrainState(model, adamw_init(model, ocfg), np.zeros(2, np.uint32))}
    step_fn = make_train_step(mcfg, ocfg)
    eval_model = fam.model(mcfg, dev)
    eval_params = list(eval_model.parameters())
    held = held_out(ctx.cell, ctx.seed, dev)
    host = HostSpans(ctx.trace)
    prof = devtrace.Profiler() if ctx.trace else None
    warm_eval = threading.Event()
    gate = threading.Lock()      # held while the evaluator launches work
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

    def start_profiler() -> None:
        """Open the device trace's session at a step boundary, with the
        evaluator held back: no thread launches work on the card while it
        opens (a traced run crashed, SIGSEGV in a native thread, within a
        second of the session opening while a backward was launching)."""
        with gate:
            prof.schedule(time.monotonic())
            deadline = time.monotonic() + 10.0
            while prof._anchor[1] == 0.0 and time.monotonic() < deadline:
                time.sleep(0.001)
        rec["profiling"] = True

    pending: collections.deque = collections.deque()   # losses not yet read
    rec["waited_s"] = 0.0

    def settle(keep: int) -> None:
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
                rec["t_prof"] = ctx.profile_start(rec["t0"])
            if (prof is not None and step > checked and "profiling" not in rec
                    and time.monotonic() >= rec["t_prof"]):
                start_profiler()
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
                with torch.no_grad():
                    change = {n: (live[n].float() - t.float()).norm()
                              for n, t in zamba2_weights(ctx.seed, w, dev)}
                rec["change"] = torch.stack([change[n] for n in names]).tolist()
                snapshot(step)
            elif step > checked and step % every == 0:
                settle(0)
                snapshot(step)
            # a traced window also waits for a step under the open session
            if (step > checked and time.monotonic() >= rec["t0"] + ctx.seconds
                    and (prof is None or "profiling" in rec)):
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
                with gate, host.span("evaluator.load"):
                    for i, p in enumerate(eval_params):
                        p.copy_(f[f"/model/p{i}"][:])
                    sums = checksums(eval_params)
                with host.span("evaluator.score"):
                    with gate:      # the launches; the wait for the loss after
                        loss_t = fam.loss_fn(eval_model, mcfg, held)
                    loss = float(loss_t)
            rec["evals"].append((step, loss, sums))
            if step == checked:
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
    nc = -(-seq // w["chunk_size"])
    h = w["expand"] * w["d_model"] // w["headdim"]
    return {
        "t0": rec["t0"], "t_end": rec["t_end"], "window_s": rec["t_end"] - rec["t0"],
        "setup_s": rec["t0"] - ctx.t_start,
        "steps": rec["steps"], "tokens_per_step": batch * seq, "step_ends": rec["ends"],
        "attempted": rec["steps"], "failed": rec["nonfinite"],
        "memory_peak_bytes": peak,
        "snapshot_ms": [ms for s, ms in rec["snap_ms"] if s > checked],
        "scored": [s for s, _, _ in evals],
        "model_flops_per_step": rz.step_flops(w, batch, seq, w["vocab"]),
        "kernel_work": {K4: roofline.ssd_work(
            batch, nc, w["chunk_size"], h, w["headdim"], w["ngroups"], w["d_state"])},
        "attn_work": {K3: rz.attn_work(batch, seq, w["heads"], w["head_dim"])},
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
