"""Materials-science use case (paper §4.2.1) on the PyTorch port: an NxN
ensemble of MD simulations coupled in situ to crystal-nucleation
detectors.

The port of ``examples/nucleation_ensemble.py``, with the same workflow
YAML: the dynamics and the detector are torch on the task's device
(``cuda:0`` unless ``--device`` says otherwise) in place of the
reference's ``jax.jit`` functions, and each ensemble member draws its
start and its kicks from one ``torch.Generator`` seeded with ``--seed``
plus its instance number.

Wilkins features exercised:
  * ensembles via one ``taskCount`` line (paper Listing 4),
  * subset writers (``nwriters: 1`` -- the LAMMPS gather-to-rank-0 idiom),
  * stateless consumers relaunched per snapshot by the query protocol.

    PYTHONPATH=src python examples/torch_nucleation_ensemble.py \\
        [--device cpu] [--instances 4] [--atoms 512] [--steps 5]
"""

import argparse
import threading

import torch

from repro_torch.core import Wilkins, h5, world


def workflow(instances: int) -> str:
    return f"""
tasks:
  - func: freeze
    taskCount: {instances}   # the only change needed to define ensembles
    nprocs: 32
    nwriters: 1                # only rank 0 performs I/O (LAMMPS idiom)
    outports:
      - filename: dump-h5md.h5
        dsets:
          - {{name: /particles/*, memory: 1}}
  - func: detector
    taskCount: {instances}
    nprocs: 8
    inports:
      - filename: dump-h5md.h5
        dsets:
          - {{name: /particles/*, memory: 1}}
"""


WORKFLOW = workflow(4)


def relax(pos):
    """The deterministic half of a step: soft pairwise repulsion."""
    d = pos[:, None, :] - pos[None, :, :]
    r2 = torch.sum(d * d, dim=-1) + torch.eye(pos.shape[0], device=pos.device)
    force = torch.sum(d / (r2[..., None] ** 2 + 0.1), dim=1)
    return pos + 1e-3 * force


def md_step(pos, gen, temp):
    """Toy water-freezing dynamics: cooled random kicks + soft repulsion."""
    kick = torch.randn(pos.shape, generator=gen, device=pos.device) * temp
    return relax(pos) + kick


def diamond_detector(pos, cutoff=0.25):
    """Count atoms with >=4 neighbours inside the cutoff ('nucleated')."""
    d = pos[:, None, :] - pos[None, :, :]
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    neigh = torch.sum((r < cutoff) & (r > 0), dim=1)
    return torch.sum(neigh >= 4)


def temperature(t: int, steps: int) -> float:
    return 0.02 * (1.0 - t / steps)   # cooling schedule


def trajectory(instance: int, atoms: int, steps: int, device, seed: int = 0):
    """One ensemble member's positions after each step, in a plain loop:
    the same generator and ops as ``freeze`` runs inside the workflow."""
    gen = torch.Generator(device=device).manual_seed(seed + instance)
    pos = torch.rand((atoms, 3), generator=gen, device=device)
    for t in range(steps):
        pos = md_step(pos, gen, temperature(t, steps))
        yield t, pos


def run(instances=4, atoms=512, steps=5, device="cuda:0", seed=0, timeout=300):
    """Run the ensemble.  Returns ``(detections, report)``: detections maps
    (instance, timestep) to ``(nucleated count, device of the positions the
    detector received)``; every (instance, timestep) arrives exactly once,
    at its own instance's detector."""
    lock = threading.Lock()
    detections = {}

    def freeze():
        comm = world()  # restricted world: instance id, io-proc role
        for t, pos in trajectory(comm.instance, atoms, steps, comm.device, seed):
            if comm.is_io_proc():   # subset writers: rank 0 only
                with h5.File("dump-h5md.h5", "w") as f:
                    ds = f.create_dataset("/particles/pos", data=pos, copy=False)
                    ds.attrs["timestep"] = t
                    ds.attrs["instance"] = comm.instance

    def detector():
        comm = world()
        f = h5.File("dump-h5md.h5", "r")
        if f is None:
            return
        ds = f["/particles/pos"]
        if ds.attrs["instance"] != comm.instance:
            raise AssertionError(f"detector {comm.instance} received instance "
                                 f"{ds.attrs['instance']}'s snapshot")
        pos = ds[:]
        n = int(diamond_detector(pos))
        key = (comm.instance, int(ds.attrs["timestep"]))
        with lock:
            if key in detections:
                raise AssertionError(f"snapshot {key} delivered twice")
            detections[key] = (n, str(pos.device))

    w = Wilkins(workflow(instances), {"freeze": freeze, "detector": detector},
                devices=[torch.device(device)])
    report = w.run(timeout=timeout)
    missing = [(i, t) for i in range(instances) for t in range(steps)
               if (i, t) not in detections]
    if missing:
        raise AssertionError(f"snapshots never analysed: {missing}")
    return detections, report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--atoms", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    detections, report = run(args.instances, args.atoms, args.steps,
                             args.device, args.seed)
    counts = {}
    for (inst, t), (n, _) in sorted(detections.items()):
        counts.setdefault(inst, []).append(n)
    for inst, series in counts.items():
        print(f"instance {inst}: nucleated counts {series}")
    rare = max(counts, key=lambda i: max(counts[i]))
    print(f"-> most nucleation observed in instance {rare} "
          f"(the 'rare event' the ensemble exists to catch)")
    print(report.summary())
