"""Fault-tolerant cosmology pipeline on the PyTorch port: a simulation and
its halo finder both survive mid-run crashes, and an optional visualization
task degrades to a no-op instead of killing the run.

The port of ``examples/cosmology_faulttolerant.py``: the density lives on
the task's device (``comm.device``, ``cuda:0`` unless ``--device`` says
otherwise) as a tensor, the diffusion step is torch, and the checkpoints
hold tensors, which ``comm.restore`` puts back on the device.  Nyx starts
from the reference's uniform float64 field unless ``run`` is handed
another (``rho0``).

Wilkins features exercised:
  * per-task YAML ``on_failure:`` policies -- ``restart`` for the tasks
    whose output matters, ``drop`` for the optional rider,
  * ``comm.checkpoint()`` / ``comm.restore()`` -- per-snapshot state through
    the run's checkpointer; a restarted incarnation resumes instead of
    recomputing, and the channel acks make the replay exact,
  * deterministic fault injection via ``Wilkins.run(faults=...)``,
  * RESTART / DROPPED lines in ``report.summary()``.

The acceptance property: the crashed run's halo counts are identical to a
crash-free run's (``run`` returns the report and the counts).

    PYTHONPATH=src python examples/torch_cosmology_faulttolerant.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import FaultSpec, Wilkins, h5

GRID = 32
SNAPSHOTS = 8

WORKFLOW = """
tasks:
  - func: nyx
    nprocs: 64
    on_failure:
      restart: {max_retries: 3, backoff_s: 0.05, jitter: 0.02}
    outports:
      - filename: plt*.h5
        dsets:
          - {name: /level_0/density, memory: 1}
  - func: reeber
    nprocs: 16
    on_failure:
      restart: {max_retries: 3}
    inports:
      - filename: plt*.h5
        dsets:
          - {name: /level_0/density, memory: 1}
  - func: viz
    on_failure: drop      # optional rider: a crash degrades it to a no-op
    inports:
      - filename: plt*.h5
        io_freq: 2
        dsets:
          - {name: /level_0/density, memory: 1}
"""


def evolve(rho, t):
    """One deterministic diffusion step (pure function of (state, t))."""
    lap = sum(torch.roll(rho, s, a) for a in range(3) for s in (1, -1)) - 6 * rho
    return torch.clamp(rho + 0.1 * lap + 0.01 * torch.sin(t + rho), min=0.0)


def uniform_density(grid, device):
    """The reference's initial field: uniform, float64."""
    return torch.ones((grid,) * 3, dtype=torch.float64, device=device)


def run(device="cuda:0", grid=GRID, snapshots=SNAPSHOTS, rho0=None,
        faults=None):
    """Run the workflow from ``rho0`` (the reference's uniform field unless
    given) with ``faults`` injected.  Returns ``(report, counts)``: reeber's
    halo cells per snapshot, a list."""
    device = torch.device(device)
    rho0 = uniform_density(grid, device) if rho0 is None else rho0.to(device)
    counts_out = {}

    def nyx(comm):
        """Simulation with per-snapshot checkpoints: a restart resumes from
        the last snapshot instead of re-running the whole history."""
        state = {"rho": rho0, "t": torch.zeros((), dtype=torch.int64)}
        restored = comm.restore(state)
        if restored is not None:
            state = restored[1]
            print(f"[nyx] attempt {comm.attempt}: resumed at snapshot "
                  f"{int(state['t'])} (epoch {comm.epoch})")
        for t in range(int(state["t"]), snapshots):
            rho = evolve(state["rho"], t)
            with h5.File(f"plt{t:05d}.h5", "w") as f:
                f.create_dataset("/level_0/density", data=rho, copy=False)
            state = {"rho": rho, "t": torch.tensor(t + 1)}
            comm.checkpoint(state)  # durable BEFORE acking the serve

    def reeber(comm):
        """Halo finder accumulating counts; checkpoints after every snapshot
        so a crash replays exactly one delivery."""
        state = {"counts": torch.zeros(snapshots, dtype=torch.int64,
                                       device=comm.device),
                 "n": torch.zeros((), dtype=torch.int64)}
        restored = comm.restore(state)
        if restored is not None:
            state = restored[1]
            print(f"[reeber] attempt {comm.attempt}: resumed after "
                  f"{int(state['n'])} snapshots")
        while True:
            f = h5.File("plt*.h5", "r")
            if f is None:
                break
            rho = f["/level_0/density"][...]
            i = int(state["n"])
            counts = state["counts"].clone()
            counts[i] = (rho > 1.01).sum()
            state = {"counts": counts, "n": state["n"] + 1}
            comm.checkpoint(state)
        counts_out["reeber"] = state["counts"].cpu().tolist()
        print(f"[reeber] halo cells per snapshot: {counts_out['reeber']}")

    def viz():
        """Optional rider -- no checkpoints, no restart policy; if it dies
        the workflow carries on without it."""
        while True:
            f = h5.File("plt*.h5", "r")
            if f is None:
                break
            print(f"[viz] rendered {f.filename}")

    w = Wilkins(WORKFLOW, {"nyx": nyx, "reeber": reeber, "viz": viz},
                devices=[device])
    report = w.run(timeout=300, faults=faults)
    return report, counts_out["reeber"]


FAULTS = [
    # producer crash at a step boundary (before snapshot 3 serves)
    FaultSpec(task="nyx", point="close", step=3),
    # consumer crash AFTER a payload was delivered but before the task saw
    # it -- only the replay protocol recovers this one
    FaultSpec(task="reeber", point="recv", step=5),
    # the optional rider dies -> dropped, not fatal
    FaultSpec(task="viz", point="open", step=2),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    device = ap.parse_args(argv).device

    print("=== crash-free reference run ===")
    _, reference = run(device)

    print("\n=== faulted run: nyx dies at snapshot 3, reeber in the "
          "delivered-but-unseen window, viz unconditionally ===")
    report, counts = run(device, faults=FAULTS)
    print("\n" + report.summary())
    restarted = sorted(r["task"] for r in report.restarts)
    assert restarted == ["nyx", "reeber"], restarted
    assert report.dropped_tasks == [("viz", 0)]
    assert counts == reference, (counts, reference)
    print("\nrecovered: 2 restarts + 1 drop, halo counts identical to the "
          "crash-free run")


if __name__ == "__main__":
    main()
