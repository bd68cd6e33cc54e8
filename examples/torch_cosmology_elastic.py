"""Elastic cosmology pipeline on the PyTorch port: the halo finder loses an
instance mid-run and the workflow RESIZES it instead of merely restarting
it.

The port of ``examples/cosmology_elastic.py``: the density lives on the
task's device as a tensor (``cuda:0`` unless ``--device`` says otherwise),
each halo-finder instance receives its slab of it as a tensor on that
device -- replayed snapshots included, which the surgery stitches on the
device -- and its per-row counts are a tensor checkpointed as a shard.
Nyx starts from the reference's uniform float64 field unless ``run`` is
handed another (``rho0``).

Wilkins features exercised:
  * ``on_failure: {rescale: {nslots: N}}`` -- a supervised restart that
    changes the task's instance count: the surgery re-cuts the sharded
    checkpoints with ``reshard_blocks``, rebuilds the redistributing
    channels for the new partition, and replays the undelivered snapshots
    into the re-partitioned consumers,
  * ``stall_timeout_s:`` + the health watchdog -- a silent (hung, not
    crashed) instance is declared stalled and the same rescale policy
    brings the task back smaller,
  * ``comm.checkpoint(state, sharded_axes={"counts": 0})``.

The acceptance property: the resized run's halo counts, concatenated over
the final instances, are byte-identical to a crash-free run's (``run``
returns the report and the counts).

    PYTHONPATH=src python examples/torch_cosmology_elastic.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import FaultSpec, Wilkins, h5, world
from repro_torch.core.redistribute import even_blocks

GRID = 32
SNAPSHOTS = 8

WORKFLOW = """
tasks:
  - func: nyx
    nprocs: 64
    on_failure:
      restart: {max_retries: 3}
    outports:
      - filename: plt*.h5
        dsets:
          - {name: /level_0/density, memory: 1}
  - func: reeber
    taskCount: 2          # two halo-finder instances, each owns a slab
    stall_timeout_s: 0.3  # health watchdog: silence past this is a stall
    on_failure:
      rescale: {nslots: 1, max_retries: 3}   # come back at HALF size
    inports:
      - filename: plt*.h5
        redistribute: 1   # slab decomposition along axis 0
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


def run(tag="run", device="cuda:0", grid=GRID, snapshots=SNAPSHOTS, rho0=None,
        faults=None):
    """Run the workflow from ``rho0`` (the reference's uniform field unless
    given) with ``faults`` injected.  Returns ``(report, counts)``: reeber's
    halo cells per row and snapshot, concatenated over the final
    instances (a ``(grid, snapshots)`` int64 array)."""
    device = torch.device(device)
    rho0 = uniform_density(grid, device) if rho0 is None else rho0.to(device)
    results = {}

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

    def reeber():
        """Halo finder over ITS slab of the density grid.  The slab extent
        comes from the instance's frozen ``RedistSpec``, so the same body
        runs before the rescale (2 instances) and after (1 instance, whole
        grid)."""
        comm = world()
        spec = comm.resolve_redist_spec(port="plt*.h5")
        _, (rows,) = even_blocks((grid,), spec.nslots)[spec.slot]
        state = {"counts": torch.zeros((rows, snapshots), dtype=torch.int64,
                                       device=comm.device),
                 "n": torch.zeros((), dtype=torch.int64)}
        restored = comm.restore(state)
        if restored is not None:
            state = restored[1]
            print(f"[reeber{comm.instance}] attempt {comm.attempt}: "
                  f"resumed after {int(state['n'])} snapshots with a "
                  f"{rows}-row shard")
        counts, n = state["counts"].clone(), int(state["n"])
        while True:
            f = h5.File("plt*.h5", "r")
            if f is None:
                break
            slab = f["/level_0/density"][...]   # THIS instance's rows only
            counts[:, n] = (slab > 1.01).sum(dim=(1, 2))
            n += 1
            comm.checkpoint({"counts": counts, "n": torch.tensor(n)},
                            sharded_axes={"counts": 0})
        results[comm.instance] = counts.cpu().numpy()

    w = Wilkins(WORKFLOW, {"nyx": nyx, "reeber": reeber}, devices=[device])
    report = w.run(timeout=300, faults=faults)
    final = w.graph.tasks["reeber"].task_count
    counts = np.concatenate([results[j] for j in range(final)], axis=0)
    print(f"[{tag}] reeber finished at taskCount={final}; per-snapshot "
          f"halo cells: {counts.sum(axis=0).tolist()}")
    return report, counts


#: run name -> the fault it injects: reeber[0] crashes at snapshot 2 (a
#: policy rescale 2->1), reeber[1] hangs without crashing (the watchdog
#: declares a stall and rescales 2->1)
FAULTS = {
    "crash": FaultSpec(task="reeber", point="recv", step=2, instance=0),
    "stall": FaultSpec(task="reeber", kind="stall", point="recv", step=1,
                       instance=1, seconds=2.0),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    device = ap.parse_args(argv).device

    print("=== crash-free reference run (2 halo-finder instances) ===")
    _, ref = run("reference", device)

    print("\n=== faulted run: reeber[0] crashes at snapshot 2 -> policy "
          "rescale 2->1 ===")
    report, crash_counts = run("crash", device, faults=FAULTS["crash"])
    print("\n" + report.summary())
    assert len(report.rescales) == 1
    assert (report.rescales[0]["old_nslots"],
            report.rescales[0]["new_nslots"]) == (2, 1)
    assert crash_counts.tobytes() == ref.tobytes(), \
        "rescaled run diverged from the reference"

    print("\n=== stalled run: reeber[1] hangs (no crash) -> watchdog "
          "declares a stall -> rescale 2->1 ===")
    report, stall_counts = run("stall", device, faults=FAULTS["stall"])
    print("\n" + report.summary())
    assert len(report.stalls) == 1 and report.stalls[0]["action"] == "rescale"
    assert report.rescales[0]["trigger"] == "stall"
    assert stall_counts.tobytes() == ref.tobytes(), \
        "watchdog-rescaled run diverged from the reference"

    print("\nrecovered: one policy rescale + one watchdog rescale, halo "
          "counts byte-identical to the crash-free run")


if __name__ == "__main__":
    main()
