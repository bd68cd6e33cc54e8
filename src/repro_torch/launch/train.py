"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's production loop: config -> mesh -> init (weights from
``torch.Generator`` seed 0) -> data pipeline (prefetched, each batch placed
on the mesh by ``shard_batch``) -> train step -> async checkpoints ->
auto-resume, with the same flags and printed lines as ``python -m
repro.launch.train``.  It runs on ``cuda:0`` (raising without CUDA)
unless given ``--device cpu``; use ``--reduced`` (the smoke config) on the
CPU.  Attention and the SSD scan take the kernel route (``use_flash``): K3
and K4 on the card, their plain versions on the CPU.  ``--n-layers`` cuts
the config's depth.

The mesh is ``make_host_mesh(("data", "model"))`` over the default process
group (world size 1 when none is running; ``--mesh 2x2`` gives its shape),
or with ``--production-mesh`` the (16, 16) pod mesh, which raises for want
of 256 ranks as the reference does.  ``--weight-gather`` sets the rules.
On one rank the parameters stay plain tensors and the step takes each
batch's local shard.  On more, each rank draws the whole initial state
from the same seeded generator and keeps its shard of every leaf
(``parallel.sharding.place``: the ranks agree without a broadcast), the
parameters and moments become ``DTensor``s laid out by ``state_specs``,
and the step is the sharded one (``train.trainer``): the gradients are
reduced across the data ranks by DTensor's redistribution.  The process
group is the caller's (``torch.distributed.init_process_group`` with its
address, world size and rank); on the card rank r runs on ``cuda:r``
modulo the cards present.  A checkpoint gathers every leaf on every rank
and rank 0 writes it.

``main`` destroys at its end the group it started; a group the caller
started is left running.

Fault tolerance: the driver always tries ``restore_latest`` first, so a
killed run resumes from the newest atomic checkpoint with the data
iterator fast-forwarded to the right step (the corpus is pure in (seed,
step)).  Checkpoints hold the training state in the reference's layout
(``convert.train_state_to_reference``), so either package resumes the
other's; saving one needs host memory for the whole state.

``main`` returns the loss of every step it ran.
"""

from __future__ import annotations

import argparse
import time
from typing import List

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..convert import train_state_from_reference, train_state_to_reference
from ..serve.engine import default_device
from ..parallel.sharding import (DEFAULT_RULES, logical_to_spec,
                                 tree_shardings, use_mesh)
from ..train import (AdamWConfig, AsyncCheckpointer, DataConfig, init_state,
                     make_batch_iter, make_train_step, place_state,
                     restore_latest, state_specs)
from .mesh import make_host_mesh, make_production_mesh


def main(argv=None) -> List[float]:
    owned = not dist.is_initialized()
    try:
        return _train(argv)
    finally:
        # the world-size-1 group ``make_host_mesh`` starts when none is
        # running belongs to this run: a later mesh or dry run in the same
        # process must not find it
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _train(argv) -> List[float]:
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
                    help="use the (16,16) pod mesh (needs 256 ranks)")
    ap.add_argument("--mesh", default=None,
                    help="the host mesh's (data, model) shape, e.g. 2x2 "
                         "(default: every rank on the data axis)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0, raising without CUDA)")
    args = ap.parse_args(argv)

    dev = default_device(args.device)
    if dev.type == "cuda" and dist.is_initialized() and dist.get_world_size() > 1:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    cfg = get_config(args.arch, reduced=args.reduced).replace(use_flash=True)
    if args.n_layers is not None:
        cfg = cfg.replace(n_layers=args.n_layers)
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20),
                       state_dtype=cfg.opt_state_dtype)
    shape = tuple(int(n) for n in args.mesh.split("x")) if args.mesh else None
    mesh = (make_production_mesh(device_type=dev.type) if args.production_mesh
            else make_host_mesh(("data", "model"), device_type=dev.type,
                                shape=shape))
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    rules = DEFAULT_RULES.with_(weight_gather=args.weight_gather)
    step_fn = make_train_step(cfg, ocfg, accum_steps=args.accum_steps,
                              compress_grads=args.compress_grads)
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, ocfg, dev)

    losses: List[float] = []
    with use_mesh(mesh, rules):
        start_step = 0
        ckpt = None
        if args.ckpt_dir:
            ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
            if ckpt.latest_step() is not None:
                got = restore_latest(args.ckpt_dir, train_state_to_reference(state))
                start_step, host_state = got
                state = train_state_from_reference(cfg, host_state, dev)
                print(f"[resume] restored step {start_step} from {args.ckpt_dir}")
        if mesh.size() > 1:  # every rank keeps its shard of each leaf
            state = place_state(state, tree_shardings(mesh, state_specs(cfg),
                                                      rules), mesh)

        dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch)
        bspec = logical_to_spec(("batch", None), mesh, rules)
        it = make_batch_iter(dcfg, start_step=start_step,
                             num_steps=args.steps - start_step,
                             mesh=mesh, batch_spec=bspec)
        t0 = time.monotonic()
        tokens_done = 0
        for step, batch in it:
            state, metrics = step_fn(state, batch)
            metrics = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                       for k, v in metrics.items()}
            losses.append(float(metrics["loss"]))
            tokens_done += args.global_batch * args.seq_len
            if (step + 1) % args.log_every == 0 or step == start_step:
                dt = time.monotonic() - t0
                print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"tok/s {tokens_done / max(dt, 1e-9):,.0f}")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                host = train_state_to_reference(state)
                if rank0:
                    ckpt.save(step + 1, host)
        if ckpt:
            host = train_state_to_reference(state)
            if rank0:
                ckpt.save(args.steps, host, block=True)
    print(f"done: {args.steps} steps in {time.monotonic() - t0:.1f}s")
    return losses


if __name__ == "__main__":
    main()
