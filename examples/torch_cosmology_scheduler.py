"""Cosmology use case, adaptive-scheduler variant, on the PyTorch port: Nyx
feeding TWO analysis consumers with disparate data rates, arbitrated at
runtime instead of by hand-tuned static knobs.

The port of ``examples/cosmology_scheduler.py``, with the same workflow
YAML: the density update, the halo count and the mean density are torch
on the task's device (``cuda:0`` unless ``--device`` says otherwise) in
place of the reference's ``jax.jit`` functions; the noise comes from one
``torch.Generator`` seeded with ``--seed``, and the field is handed over in
place (``create_dataset(..., copy=False)``), so each consumer receives it
on the device.

Wilkins features exercised:
  * top-level ``scheduler:`` block -- ``policy: fair`` (deficit-weighted
    round-robin prep arbitration) with a telemetry timeline,
  * per-inport ``weight:`` -- the halo finder (3) outweighs the spectrum
    probe (1) for prefetch-pool service under contention,
  * per-inport ``autotune:`` -- the halo finder's prefetch depth floats in
    [1, 4], widened while its consumer blocks and narrowed when preps idle,
  * telemetry export -- the per-edge timeline ring lands in a JSON file.

    PYTHONPATH=src python examples/torch_cosmology_scheduler.py \\
        [--device cpu] [--grid 32] [--snapshots 12] [--timeline PATH]
"""

import argparse
import os
import tempfile
import threading
import time

import torch

from repro_torch.core import Wilkins, h5

WORKFLOW = """
scheduler:
  policy: fair       # DWRR over per-edge prep queues (fifo = legacy order)
  tick_every: 2      # autotuner/telemetry tick period, in step events
  telemetry: 512     # timeline ring capacity (samples)
tasks:
  - func: nyx
    nprocs: 4
    outports:
      - filename: plt*.h5
        ownership: {axis: 0}
        dsets:
          - {name: /level_0/density, memory: 1}
  - func: reeber
    nprocs: 2
    inports:
      - filename: plt*.h5
        redistribute: 1
        weight: 3              # halo finding outweighs the spectrum probe
        autotune: {min: 1, max: 4}
        queue_depth: 4
        dsets:
          - {name: /level_0/density, memory: 1}
  - func: spectrum
    nprocs: 2
    inports:
      - filename: plt*.h5
        redistribute: 1
        weight: 1
        prefetch: 1
        dsets:
          - {name: /level_0/density, memory: 1}
"""


def nyx_step(rho, gen):
    lap = sum(torch.roll(rho, s, a) for a in range(3) for s in (1, -1)) - 6 * rho
    noise = torch.randn(rho.shape, generator=gen, device=rho.device)
    return torch.clamp(rho + 0.1 * lap + 0.06 * noise * rho, min=0.0)


def find_halos(rho, cutoff=1.05):
    return torch.sum(rho > cutoff)


def mean_density(rho):
    return torch.mean(rho)


def snapshots(grid: int, count: int, device, seed: int = 0):
    """Nyx's density after each snapshot, as written: (grid, grid * grid)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rho = torch.ones((grid, grid, grid), device=device)
    for t in range(count):
        rho = nyx_step(rho, gen)
        yield t, rho.reshape(grid, -1)


def run(grid=32, count=12, device="cuda:0", seed=0, timeline=None,
        timeout=300, verbose=True):
    """Run the workflow.  Returns ``(analysed, report)``: analysed maps
    ``("reeber", t)`` to (halo cells, device of the slab) and
    ``("spectrum", t)`` to (mean density, device); both consumers must see
    every snapshot.  The telemetry timeline is exported to ``timeline``."""
    lock = threading.Lock()
    analysed = {}

    def nyx(comm):
        for t, field in snapshots(grid, count, comm.device, seed):
            with h5.File(f"plt{t:05d}.h5", "w") as f:
                f.attrs["step"] = t
                ds = f.create_dataset("/level_0/density", data=field, copy=False)
                ds.attrs["a"] = 1.0 / (1.0 + count - t)

    def consume(task, fn, slow):
        def body():
            while True:
                f = h5.File("plt*.h5", "r")
                if f is None:
                    break
                rho = f["/level_0/density"][:]
                value = fn(rho).item()
                time.sleep(slow)
                with lock:
                    analysed[(task, int(f.attrs["step"]))] = (value, str(rho.device))
                if verbose:
                    print(f"[{task}] {f.filename}: {value}")
        return body

    w = Wilkins(WORKFLOW, {"nyx": nyx,
                           "reeber": consume("reeber", find_halos, 0.02),
                           "spectrum": consume("spectrum", mean_density, 0.0)},
                devices=[torch.device(device)])
    report = w.run(timeout=timeout)
    for task in ("reeber", "spectrum"):
        done = sum(1 for (k, _) in analysed if k == task)
        if done != count:
            raise AssertionError(f"{task} analysed {done}/{count} snapshots")
    if timeline is not None:
        report.timeline.export(timeline)
    return analysed, report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--snapshots", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeline", default=os.path.join(
        tempfile.gettempdir(), "cosmology_timeline.json"))
    args = ap.parse_args()
    analysed, report = run(args.grid, args.snapshots, args.device, args.seed,
                           timeline=args.timeline)
    print(f"[reeber] analyzed {args.snapshots}/{args.snapshots} snapshots, "
          f"final prefetch depths {report.scheduler['depths']}")
    print(report.summary())
    print(f"telemetry timeline ({len(report.timeline)} samples) -> "
          f"{args.timeline}")
