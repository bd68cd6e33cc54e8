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

    PYTHONPATH=src python examples/torch_train_insitu_eval.py [--device cpu]
    PYTHONPATH=src python examples/torch_train_insitu_eval.py --preset 100m
"""

import argparse
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

    dev = default_device(args.device)
    cfg = PRESETS[args.preset].replace(use_flash=True)
    steps = args.steps or (120 if args.preset == "demo" else 300)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=max(1, steps // 20),
                       total_steps=steps)
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params), "
          f"{steps} steps, batch {args.batch} x seq {args.seq}, on {dev}")

    train_data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                            global_batch=args.batch, seed=0)
    eval_data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=10_000)  # held out

    def trainer():
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           ocfg, dev)
        step_fn = make_train_step(cfg, ocfg)
        corpus = SyntheticCorpus(train_data)
        t0 = time.monotonic()
        for step in range(steps):
            state, metrics = step_fn(state, corpus.batch(step))
            if (step + 1) % args.eval_every == 0:
                # ordinary h5 write; 'latest' flow control decides delivery.
                # The step updates the weights in place, so hand over copies.
                with h5.File(f"ckpt{step + 1:06d}.h5", "w") as f:
                    for i, p in enumerate(state.params.parameters()):
                        f.create_dataset(f"/model/p{i}", copy=False,
                                         data=p.detach().clone())
                    f.create_dataset(
                        "/meta/info",
                        data=np.array([step + 1, float(metrics["loss"])],
                                      np.float64))
            if (step + 1) % 20 == 0:
                tput = (step + 1) * args.batch * args.seq / (time.monotonic() - t0)
                print(f"[trainer] step {step + 1:4d} "
                      f"loss {float(metrics['loss']):.4f} tok/s {tput:,.0f}")

    evals = []

    def evaluator():
        corpus = SyntheticCorpus(eval_data)
        fam = get_family(cfg)
        model = fam.model(cfg, dev)
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in corpus.batch(0).items()}
        while True:
            f = h5.File("ckpt*.h5", "r")
            if f is None:
                break
            with torch.no_grad():
                for i, p in enumerate(model.parameters()):
                    p.copy_(f[f"/model/p{i}"][:])
                step, train_loss = f["/meta/info"][:]
                ev = float(fam.loss_fn(model, cfg, batch))
            evals.append((int(step), ev))
            print(f"[eval]    step {int(step):4d} "
                  f"train {train_loss:.4f} held-out {ev:.4f}")

    w = Wilkins(WORKFLOW, {"trainer": trainer, "evaluator": evaluator},
                devices=[dev])
    report = w.run(timeout=3600)
    print(report.summary())
    assert evals, "evaluator never ran"
    assert evals[-1][1] < evals[0][1] + 0.5, "eval loss diverged"
    dropped = report.total_dropped
    print(f"in-situ evals: {len(evals)}; checkpoints dropped by 'latest' "
          f"flow control: {dropped} (training never blocked)")


if __name__ == "__main__":
    main()
