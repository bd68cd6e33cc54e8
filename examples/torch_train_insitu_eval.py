"""Train an LM on the PyTorch port while an in situ evaluator consumes its
weights over the port's Wilkins transport: ``examples/train_insitu_eval.py``
on ``cuda:0`` (the paper's in situ coupling applied to an ML producer).

The trainer is the "simulation": every ``eval_every`` steps it writes the
model parameters and step metadata as an HDF5-style file (no workflow API
in the train loop: ordinary h5 writes of tensors on the card).  The
evaluator is a slower consumer that scores a held-out batch; flow control
``latest`` (``io_freq: -1``) means the trainer never blocks on it: stale
snapshots are dropped and the evaluator always scores the freshest
weights.  The YAML is byte for byte the reference example's.

``run(...)`` returns the report, the evaluations and the snapshots: each
snapshot the evaluator scored is held bit for bit against a second copy
the trainer took when it wrote it (the step updates its weights in place
right after the write, so a payload that aliased them would show here).

    PYTHONPATH=src python examples/torch_train_insitu_eval.py [--device cpu]
    PYTHONPATH=src python examples/torch_train_insitu_eval.py --preset 100m
"""

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core import Wilkins, h5
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_family
from repro_torch.serve.engine import default_device
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticCorpus,
                               init_state, make_train_step)

PRESETS = {
    # family-faithful llama-style configs
    "demo": ModelConfig(name="demo-8m", family="dense", n_layers=4,
                        d_model=192, n_heads=4, n_kv_heads=2, d_ff=512,
                        vocab=4096, dtype="float32", loss_chunk=128),
    "100m": ModelConfig(name="lm-114m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                        vocab=32000, dtype="float32", loss_chunk=256),
}

WORKFLOW = """
tasks:
  - func: trainer
    nprocs: 8
    outports:
      - filename: ckpt*.h5
        dsets:
          - {name: /model/*, memory: 1}
          - {name: /meta/*, memory: 1}
  - func: evaluator
    nprocs: 2
    inports:
      - filename: ckpt*.h5
        io_freq: -1   # 'latest': never block training on a slow evaluator
        dsets:
          - {name: /model/*, memory: 1}
          - {name: /meta/*, memory: 1}
"""


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def run(preset="demo", steps=None, batch=8, seq=128, eval_every=10,
        device=None, log=print):
    """Train and evaluate in situ.  Returns ``(report, evals, snapshots)``:
    ``evals`` lists ``(step, held-out loss)`` for each snapshot scored,
    ``snapshots`` holds ``written`` (the steps the trainer wrote),
    ``equal`` (for each scored step, whether every tensor the evaluator
    loaded had the bits of the trainer's copy) and the trainer's wall
    seconds and steps."""
    dev = default_device(device)
    cfg = PRESETS[preset].replace(use_flash=True)
    steps = steps or (120 if preset == "demo" else 300)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=max(1, steps // 20),
                       total_steps=steps)
    log(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params), "
        f"{steps} steps, batch {batch} x seq {seq}, on {dev}")

    train_data = DataConfig(vocab=cfg.vocab, seq_len=seq,
                            global_batch=batch, seed=0)
    eval_data = DataConfig(vocab=cfg.vocab, seq_len=seq,
                           global_batch=batch, seed=10_000)  # held out
    lock = threading.Lock()
    kept = {}      # step -> the trainer's own copy of what it wrote
    snapshots = {"written": [], "equal": {}}

    def trainer():
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           ocfg, dev)
        step_fn = make_train_step(cfg, ocfg)
        corpus = SyntheticCorpus(train_data)
        t0 = time.monotonic()
        for step in range(steps):
            state, metrics = step_fn(state, corpus.batch(step))
            if (step + 1) % eval_every == 0:
                # ordinary h5 write; 'latest' flow control decides delivery.
                # The step updates the weights in place, so hand over copies.
                params = [p.detach().clone() for p in state.params.parameters()]
                with lock:
                    kept[step + 1] = [p.clone() for p in params]
                    snapshots["written"].append(step + 1)
                with h5.File(f"ckpt{step + 1:06d}.h5", "w") as f:
                    for i, p in enumerate(params):
                        f.create_dataset(f"/model/p{i}", copy=False, data=p)
                    f.create_dataset(
                        "/meta/info",
                        data=np.array([step + 1, float(metrics["loss"])],
                                      np.float64))
            if (step + 1) % 20 == 0:
                tput = (step + 1) * batch * seq / (time.monotonic() - t0)
                log(f"[trainer] step {step + 1:4d} "
                    f"loss {float(metrics['loss']):.4f} tok/s {tput:,.0f}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        snapshots["train_s"] = time.monotonic() - t0
        snapshots["steps"] = steps

    evals = []

    def evaluator():
        corpus = SyntheticCorpus(eval_data)
        fam = get_family(cfg)
        model = fam.model(cfg, dev)
        held_out = {k: torch.as_tensor(v).to(dev)
                    for k, v in corpus.batch(0).items()}
        while True:
            f = h5.File("ckpt*.h5", "r")
            if f is None:
                break
            with torch.no_grad():
                step, train_loss = f["/meta/info"][:]
                with lock:   # this step's copy; older ones were dropped
                    want = kept.pop(int(step))
                    for s_ in [s_ for s_ in kept if s_ < step]:
                        del kept[s_]
                same = True
                for i, p in enumerate(model.parameters()):
                    got = f[f"/model/p{i}"][:]
                    same = same and _same_bits(got, want[i])
                    p.copy_(got)
                ev = float(fam.loss_fn(model, cfg, held_out))
            snapshots["equal"][int(step)] = same
            evals.append((int(step), ev))
            log(f"[eval]    step {int(step):4d} "
                f"train {train_loss:.4f} held-out {ev:.4f}")

    w = Wilkins(WORKFLOW, {"trainer": trainer, "evaluator": evaluator},
                devices=[dev])
    report = w.run(timeout=3600)
    return report, evals, snapshots


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="demo")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0, raising without CUDA)")
    args = ap.parse_args()
    report, evals, snapshots = run(args.preset, args.steps, args.batch,
                                   args.seq, args.eval_every, args.device)
    print(report.summary())
    assert evals, "evaluator never ran"
    assert all(snapshots["equal"].values()), \
        f"a snapshot's bits changed in transit: {snapshots['equal']}"
    assert evals[-1][1] < evals[0][1] + 0.5, "eval loss diverged"
    dropped = report.total_dropped
    print(f"in-situ evals: {len(evals)}; checkpoints dropped by 'latest' "
          f"flow control: {dropped} (training never blocked)")


if __name__ == "__main__":
    main()
