"""Traced cosmology pipeline on the PyTorch port: the fault-tolerant
Nyx+Reeber workflow with run-wide span tracing ON, exporting a Perfetto
timeline and printing the critical-path attribution.

The port of ``examples/cosmology_traced.py``: the density is a tensor on
the task's device (``cuda:0`` unless ``--device`` says otherwise), and the
halo finder cuts each received slab into per-rank blocks with
``comm.reshard`` (the pack kernels on the card, their plain versions on the
CPU).  Tracing is on for the run (``run(trace=...)``, the same as a
``tracing:`` block in the YAML): every layer records spans into the run's
``SpanRecorder`` -- VOL open/close rendezvous, channel offer/get, prefetch
preps and waits, reshard executes, checkpoint save/restore and the restart
surgery.

    PYTHONPATH=src python examples/torch_cosmology_traced.py [--device cpu] [--trace PATH]
    PYTHONPATH=src python -m repro_torch.obs report PATH
"""

import argparse
import os
import tempfile

import torch

from repro_torch.core import FaultSpec, Wilkins, h5
from repro_torch.obs import load_trace, span_categories

GRID = 24
SNAPSHOTS = 6
SEED = 0

WORKFLOW = """
tasks:
  - func: nyx
    nprocs: 4
    on_failure:
      restart: {max_retries: 3, backoff_s: 0.02}
    outports:
      - filename: plt*.h5
        dsets:
          - {name: /level_0/density, memory: 1}
  - func: reeber
    taskCount: 2
    nprocs: 2
    on_failure:
      restart: {max_retries: 3}
    inports:
      - filename: plt*.h5
        redistribute: 1
        prefetch: 2
        dsets:
          - {name: /level_0/density, memory: 1}
"""


def evolve(rho, t):
    lap = sum(torch.roll(rho, s, a) for a in range(3) for s in (1, -1)) - 6 * rho
    return torch.clamp(rho + 0.1 * lap + 0.01 * torch.sin(t + rho), min=0.0)


def nyx(comm):
    g = torch.Generator(device="cpu").manual_seed(SEED)
    state = {"rho": (1.0 + 0.05 * torch.randn((GRID,) * 3, generator=g,
                                              dtype=torch.float64)
                     ).to(comm.device),
             "t": torch.zeros((), dtype=torch.int64)}
    restored = comm.restore(state)
    if restored is not None:
        state = restored[1]
    for t in range(int(state["t"]), SNAPSHOTS):
        rho = evolve(state["rho"], t)
        with h5.File(f"plt{t:05d}.h5", "w") as f:
            f.create_dataset("/level_0/density", data=rho, copy=False)
        state = {"rho": rho, "t": torch.tensor(t + 1)}
        comm.checkpoint(state)


def reeber(comm):
    state = {"n": torch.zeros((), dtype=torch.int64)}
    restored = comm.restore(state)
    if restored is not None:
        state = restored[1]
    n = int(state["n"])
    while True:
        f = h5.File("plt*.h5", "r")
        if f is None:
            break
        # this instance's slab, cut into its ranks' blocks (M->N)
        blocks = comm.reshard(f["/level_0/density"])
        halo_cells = sum(int((b > 1.01).sum()) for b in blocks)
        n += 1
        comm.checkpoint({"n": torch.tensor(n)})
    print(f"[reeber{comm.instance}] last snapshot: {halo_cells} halo cells")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--trace", default=os.path.join(
        tempfile.gettempdir(), "wilkins_torch_trace.json"))
    args = ap.parse_args(argv)
    funcs = {"nyx": nyx, "reeber": reeber}
    print("=== traced faulted run: reeber[1] dies in the delivered-but-"
          "unseen window at snapshot 2 ===")
    report = Wilkins(WORKFLOW, funcs, devices=[torch.device(args.device)]).run(
        timeout=300, trace={"path": args.trace, "flight_len": 128},
        faults=FaultSpec(task="reeber", point="recv", step=2, instance=1))
    print("\n" + report.summary())

    spans = load_trace(args.trace)
    layers = span_categories(spans)
    print(f"\nexported {args.trace}: {report.trace_spans} spans, "
          f"layers={layers}")
    aborted = [s for s in spans if (s["args"] or {}).get("aborted")]
    print(f"recovered crash left {len(aborted)} aborted interval(s) and "
          f"{sum(1 for s in spans if s['cat'] == 'recovery')} recovery "
          f"span(s); flight dumps (terminal failures only): "
          f"{len(report.flight_recorder)}")
    assert report.trace_path == args.trace
    assert len(report.restarts) == 1
    assert {"vol", "channel", "prefetch", "reshard", "checkpoint",
            "recovery"} <= set(layers), layers
    print("\nre-run the analysis offline:\n    PYTHONPATH=src python -m "
          f"repro_torch.obs report {args.trace}")


if __name__ == "__main__":
    main()
