"""Traced cosmology pipeline on the PyTorch port: the fault-tolerant
Nyx+Reeber workflow with run-wide span tracing ON, exporting a Perfetto
timeline and printing the critical-path attribution.

The port of ``examples/cosmology_traced.py``: the density is a tensor on
the task's device (``cuda:0`` unless ``--device`` says otherwise), and the
halo finder cuts its share of the flattened field into per-rank blocks
with ``comm.reshard`` (the pack kernels on the card, their plain versions
on the CPU).  As in the reference, that share is the received slab raveled
and taken for the global field, so each instance counts the halo cells of
half its slab.  Tracing is on for the run (``run(trace=...)``, the same as a
``tracing:`` block in the YAML): every layer records spans into the run's
``SpanRecorder`` -- VOL open/close rendezvous, channel offer/get, prefetch
preps and waits, reshard executes, checkpoint save/restore and the restart
surgery.  Nyx starts from the reference's uniform float64 field unless
``run`` is handed another (``rho0``).

    PYTHONPATH=src python examples/torch_cosmology_traced.py [--device cpu] [--trace PATH]
    PYTHONPATH=src python -m repro_torch.obs report PATH
"""

import argparse
import os
import tempfile
import threading

import torch

from repro_torch.core import FaultSpec, Wilkins, h5
from repro_torch.obs import load_trace, span_categories

GRID = 24
SNAPSHOTS = 6

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


def uniform_density(grid, device):
    """The reference's initial field: uniform, float64."""
    return torch.ones((grid,) * 3, dtype=torch.float64, device=device)


#: the layers a traced faulted run must cover
LAYERS = {"vol", "channel", "prefetch", "reshard", "checkpoint", "recovery"}
#: reeber[1] dies in the delivered-but-unseen window at snapshot 2
FAULT = FaultSpec(task="reeber", point="recv", step=2, instance=1)


def run(device="cuda:0", grid=GRID, snapshots=SNAPSHOTS, rho0=None,
        faults=FAULT, trace=None):
    """Run the workflow from ``rho0`` (the reference's uniform field unless
    given) with ``faults`` injected, traced into ``trace`` (a path; no
    tracing when ``None``).  Returns ``(report, counts, blocks)``: the halo
    cells of each snapshot summed over reeber's instances, and the
    non-empty rank blocks its ``comm.reshard`` calls returned."""
    device = torch.device(device)
    rho0 = uniform_density(grid, device) if rho0 is None else rho0.to(device)
    lock = threading.Lock()
    halos = {}
    blocks_out = [0]

    def nyx(comm):
        state = {"rho": rho0, "t": torch.zeros((), dtype=torch.int64)}
        restored = comm.restore(state)
        if restored is not None:
            state = restored[1]
        for t in range(int(state["t"]), snapshots):
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
        n, halo_cells = int(state["n"]), 0
        while True:
            f = h5.File("plt*.h5", "r")
            if f is None:
                break
            # this instance's share of the flattened density field (M->N),
            # cut as the reference cuts it: the raveled slab taken for the
            # global field, so its ranks' blocks hold half of the slab.  A
            # column view of it, (n, 1), reshards along axis 0 on the pack
            # kernels, where the reference's 1-D array takes numpy
            blocks = comm.reshard(f["/level_0/density"][...].reshape(-1, 1))
            halo_cells = sum(int((b > 1.01).sum()) for b in blocks)
            with lock:
                halos[(comm.instance, n)] = halo_cells
                blocks_out[0] += sum(1 for b in blocks if b.numel())
            n += 1
            comm.checkpoint({"n": torch.tensor(n)})
        print(f"[reeber{comm.instance}] last snapshot: {halo_cells} halo cells")

    tcfg = None if trace is None else {"path": trace, "flight_len": 128}
    report = Wilkins(WORKFLOW, {"nyx": nyx, "reeber": reeber},
                     devices=[device]).run(timeout=300, trace=tcfg,
                                           faults=faults)
    counts = [sum(v for (_, t), v in halos.items() if t == step)
              for step in range(snapshots)]
    return report, counts, blocks_out[0]


def accept(report, trace):
    """The example's acceptance property for the traced faulted run: one
    restart, and the exported trace covers every layer of ``LAYERS``.
    Returns the trace's spans."""
    spans = load_trace(trace)
    layers = span_categories(spans)
    assert report.trace_path == trace
    assert len(report.restarts) == 1, report.restarts
    assert LAYERS <= set(layers), layers
    return spans


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--trace", default=os.path.join(
        tempfile.gettempdir(), "wilkins_torch_trace.json"))
    args = ap.parse_args(argv)
    print("=== traced faulted run: reeber[1] dies in the delivered-but-"
          "unseen window at snapshot 2 ===")
    report, counts, _ = run(args.device, trace=args.trace)
    print("\n" + report.summary())
    spans = accept(report, args.trace)
    print(f"\nexported {args.trace}: {report.trace_spans} spans, "
          f"layers={span_categories(spans)}; halo cells per snapshot {counts}")
    aborted = [s for s in spans if (s["args"] or {}).get("aborted")]
    print(f"recovered crash left {len(aborted)} aborted interval(s) and "
          f"{sum(1 for s in spans if s['cat'] == 'recovery')} recovery "
          f"span(s); flight dumps (terminal failures only): "
          f"{len(report.flight_recorder)}")
    print("\nre-run the analysis offline:\n    PYTHONPATH=src python -m "
          f"repro_torch.obs report {args.trace}")


if __name__ == "__main__":
    main()
