"""How far rounding alone moves the first gradient of the ``zamba2-7b``
cell's model, at the cell's weight init and at Zamba2's own.

    python3 tools/zamba2_init_probe.py --seeds 3 --out init_probe.json

For each seed and each init, on the card, from the same weights and the
cell's first batch (1 x 4096 tokens), three first gradients by leaf:

- ``fp32``: ``insitu_bench/reference/zamba2.py`` in float32, TF32 off;
- ``bf16``: the same reference with every projection a bf16 GEMM (both
  operands and the product rounded to bf16; norms, the scan, the softmax
  and the residual stream stay float32): what bf16 rounding of the
  projections alone does at these weights;
- ``port``: the port's ``zamba2`` family in bf16, as the cell trains it.

Inits: ``file``, the cell's (``drivers/insitu_train_zamba2.zamba2_weights``);
``published``, ``Zamba2PreTrainedModel._init_weights`` (``transformers``
4.57.6, ``modeling_zamba2.py`` l. 1191-1205, and ``PreTrainedModel.
_init_weights``): every linear, the embedding and the conv weight N(0,
0.02^2), the conv bias 0, A = 1 .. heads, D and the norms 1, dt as the
file draws it.  For each pair of gradients: ``rel_l2`` of the whole
gradient, the worst and median leaf's relative L2, and ``grad_gap`` (the
cell's number, on the gradients' norms by leaf).  One JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "zamba2-7b.insitu_train_4k"


def published(name, t, g):
    """Leaf ``name`` at Zamba2's own init (``t``: the file's value)."""
    import torch

    if name.endswith("conv_b"):
        return torch.zeros_like(t)
    if name.endswith("A_log"):
        return torch.log(torch.arange(1, t.numel() + 1, dtype=t.dtype, device=t.device))
    if t.dtype == torch.bfloat16:
        return (torch.randn(t.shape, generator=g, device=t.device,
                            dtype=torch.float32) * 0.02).to(t.dtype)
    return t


def pair(a, b, names):
    """``a`` against ``b`` (dicts of float32 gradients by leaf)."""
    import torch

    from insitu_bench.drivers.insitu_train import worst_leaf_gap

    a = {n: a[n].float() for n in names}
    diff = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
    base = sum(float((b[n] ** 2).sum()) for n in names)
    leaf = [float((a[n] - b[n]).norm() / b[n].norm()) for n in names
            if float(b[n].norm()) > 0]
    return {"rel_l2": math.sqrt(diff / base), "leaf_rel_l2_max": max(leaf),
            "leaf_rel_l2_median": statistics.median(leaf),
            "grad_gap": worst_leaf_gap([float(a[n].norm()) for n in names],
                                       [float(b[n].norm()) for n in names]),
            "finite": all(bool(torch.isfinite(a[n]).all()) for n in names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_301_000_001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from insitu_bench.drivers import insitu_train_zamba2 as drv
    from insitu_bench.lib import spec
    from insitu_bench.reference import zamba2 as ref
    from repro_torch.models.registry import get_family

    dev = torch.device(args.device)
    cell = spec.load_cell(CELL)
    w = drv.widths(cell.config)
    mcfg = drv.port_config(cell.config)
    fam = get_family(mcfg)
    model = fam.model(mcfg, dev)
    names = [n for n, _ in model.named_parameters()]
    live = dict(model.named_parameters())
    fp32_mm = ref._mm

    def bf16_mm(a, b, precision):
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()

    out = open(args.out, "w") if args.out else None
    for k in range(args.seeds):
        seed = args.first_seed + k
        batch = drv.train_batch(cell, seed, 1, dev)
        for init in ("file", "published"):
            g = torch.Generator(device=dev).manual_seed(seed)
            with torch.no_grad():
                for name, t in drv.zamba2_weights(seed, w, dev):
                    live[name].copy_(t if init == "file" else published(name, t, g))
            loss = fam.loss_fn(model, mcfg, batch)
            grads = {"port": dict(zip(names, torch.autograd.grad(
                loss, [live[n] for n in names])))}
            port_loss = float(loss.detach())
            del loss
            ref.no_tf32()
            p = {n: live[n].detach().float().requires_grad_(True) for n in names}
            losses = {}
            for tag, mm in (("fp32", fp32_mm), ("bf16", bf16_mm)):
                ref._mm = mm
                try:
                    value = ref.loss(p, batch, w)
                    grads[tag] = dict(zip(names, torch.autograd.grad(
                        value, [p[n] for n in names])))
                    losses[tag] = float(value)
                finally:
                    ref._mm = fp32_mm
                del value
            del p
            row = {"seed": seed, "init": init, "loss": {"port": port_loss, **losses},
                   "bf16_vs_fp32": pair(grads["bf16"], grads["fp32"], names),
                   "port_vs_fp32": pair(grads["port"], grads["fp32"], names),
                   "port_vs_bf16": pair(grads["port"], grads["bf16"], names)}
            if out is not None:
                out.write(json.dumps(row) + "\n")
                out.flush()
            print(json.dumps(row), flush=True)
            del grads
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(dev), "peak",
              torch.cuda.max_memory_allocated(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
