"""The ``zamba2-7b`` cell's control and faults, read at the cell's own size.

    python3 insitu_bench/controls/train_control_zamba2.py --seeds 11,12,13 [--out FILE]

``controls/train_control.py`` for this cell, through the traffic module
``insitu_train_zamba2``: for each seed the cell's checked steps with the
plain reference in float32 (the readings a sound program is held to), then
in the program's place, each by the same ``reference_readings`` call:

* ``control``: the reference in float8 e4m3 (``reference.zamba2``'s
  ``precision="fp8"``), the precision below the configuration's bf16;
* ``half_batch``: the reference on the first half of each batch's tokens
  (the batch has one row, so half of it is half of its positions);
* ``zero_grad``: the reference with one leaf's gradient (the middle
  layer's in-projection) zeroed where it is produced.

It prints, per seed and variant, the numbers the cell compares, by the
cell's own ``compare``, and the control's held-out loss gap, as JSON
lines.  A state left unchanged reads 1 on the change by construction.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT]

import torch  # noqa: E402

from insitu_bench.drivers import insitu_train_zamba2 as drv  # noqa: E402
from insitu_bench.lib import spec  # noqa: E402
from insitu_bench.reference import zamba2 as ref  # noqa: E402

CELL = "zamba2-7b.insitu_train_4k"


def variants(cell):
    """The keyword arguments of ``reference_readings`` that put each
    variant in the program's place."""
    zeroed = f"layers.{cell.config['num_hidden_layers'] // 2}.mamba.in_proj"

    def zero_grad(step, grads):
        return {**grads, zeroed: torch.zeros_like(grads[zeroed])}

    return {"control": {"precision": "fp8"},
            "half_batch": {"positions": cell.traffic["seq"] // 2},
            "zero_grad": {"grad_hook": zero_grad}}


def readings(cell, seed: int, dev):
    """One seed's rows: the control's held-out loss gap, then each variant's
    numbers against the sound reference's."""
    w = drv.widths(cell.config)
    leaves = [n for n, *_ in drv.zamba2_leaves(w)]
    want = drv.reference_readings(cell, seed, dev, leaves)
    held = drv.held_out(cell, seed, dev)
    with torch.no_grad():
        got_eval = float(ref.loss(want["params"], held, w, "fp8"))
        want_eval = float(ref.loss(want["params"], held, w))
    del want["params"]
    rows = [{"seed": seed, "variant": "control",
             "eval_loss_gap": drv.rel_gap(got_eval, want_eval)}]
    for name, kwargs in variants(cell).items():
        got = drv.reference_readings(cell, seed, dev, leaves, **kwargs)
        del got["params"]
        loss_gaps = [drv.rel_gap(a, b) for a, b in zip(got["losses"], want["losses"])]
        rows.append({"seed": seed, "variant": name, "loss1_gap": loss_gaps[0],
                     "loss_gap": max(loss_gaps), **drv.compare(got, want)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    ref.no_tf32()
    cell = spec.load_cell(CELL)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(cell, seed, dev):
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
