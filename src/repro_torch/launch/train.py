"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's production loop on one device: config -> init (weights
from ``torch.Generator`` seed 0) -> data pipeline (prefetched) -> train
step -> async checkpoints -> auto-resume, with the same flags and printed
lines as ``python -m repro.launch.train``.  It runs on ``cuda:0`` (raising
without CUDA) unless given ``--device cpu``; use ``--reduced`` (the smoke
config) on the CPU.  Attention and the SSD scan take the kernel route
(``use_flash``): K3 and K4 on the card, their plain versions on the CPU.

Fault tolerance: the driver always tries ``restore_latest`` first, so a
killed run resumes from the newest atomic checkpoint with the data
iterator fast-forwarded to the right step (the corpus is pure in (seed,
step)).  Checkpoints hold the training state in the reference's layout
(``convert.train_state_to_reference``), so either package resumes the
other's; saving one needs host memory for the whole state.

``--weight-gather`` is accepted and is the identity on one device, as in
the reference; ``--production-mesh`` needs 256 devices and the mesh
module, which is not ported yet, and raises.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_config
from ..convert import train_state_from_reference, train_state_to_reference
from ..serve.engine import default_device
from ..train import (AdamWConfig, AsyncCheckpointer, DataConfig, init_state,
                     make_batch_iter, make_train_step, restore_latest)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU smoke scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--weight-gather", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the (16,16) pod mesh (needs 256 devices)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0, raising without CUDA)")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh needs 256 devices and launch/mesh.py, which "
            "is not ported yet (ROADMAP Queue 1 item 12)")
    dev = default_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced).replace(use_flash=True)
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20),
                       state_dtype=cfg.opt_state_dtype)
    step_fn = make_train_step(cfg, ocfg, accum_steps=args.accum_steps,
                              compress_grads=args.compress_grads)
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, ocfg, dev)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
        if ckpt.latest_step() is not None:
            got = restore_latest(args.ckpt_dir, train_state_to_reference(state))
            start_step, host_state = got
            state = train_state_from_reference(cfg, host_state, dev)
            print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    it = make_batch_iter(dcfg, start_step=start_step,
                         num_steps=args.steps - start_step)
    t0 = time.monotonic()
    tokens_done = 0
    for step, batch in it:
        state, metrics = step_fn(state, batch)
        tokens_done += args.global_batch * args.seq_len
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            print(f"step {step + 1:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"tok/s {tokens_done / max(dt, 1e-9):,.0f}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, train_state_to_reference(state))
    if ckpt:
        ckpt.save(args.steps, train_state_to_reference(state), block=True)
    print(f"done: {args.steps} steps in {time.monotonic() - t0:.1f}s")


if __name__ == "__main__":
    main()
