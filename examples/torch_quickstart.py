"""Quickstart on the PyTorch port: the paper's Listing 1 workflow, end to
end, with the data as tensors on the card.

One producer writes a grid and a particle list per timestep; two consumers
each subscribe to one dataset.  The task codes do ordinary HDF5-style I/O
-- no workflow API calls -- and the YAML is byte for byte the one of
``examples/quickstart.py``.  The particles are the reference's draw
(``np.random.default_rng(t)``), moved to the task's device.  The producer
hands its tensors over in place (``create_dataset(..., copy=False)``):
each consumer receives a view of the producer's tensor on the same device,
with no copy.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import threading

import numpy as np
import torch

from repro_torch.core import Wilkins, h5
from repro_torch.core.datamodel import reset_transport_stats, transport_stats

N = 1_000_000
STEPS = 5

WORKFLOW = """
tasks:
  - func: producer
    nprocs: 4
    outports:
      - filename: outfile.h5
        dsets:
          - {name: /group1/grid, file: 0, memory: 1}
          - {name: /group1/particles, file: 0, memory: 1}
  - func: consumer1
    nprocs: 5
    inports:
      - filename: outfile.h5
        dsets:
          - {name: /group1/grid, file: 0, memory: 1}
  - func: consumer2
    nprocs: 3
    inports:
      - filename: outfile.h5
        dsets:
          - {name: /group1/particles, file: 0, memory: 1}
"""


def particles(t, n, device):
    """The reference producer's particles of timestep ``t`` on ``device``."""
    return torch.from_numpy(np.random.default_rng(t).random((n, 3))
                            .astype(np.float32)).to(device)


def storage(x):
    return x.untyped_storage().data_ptr()


def run(device="cuda:0"):
    """Run the workflow.  Returns a dict: consumer1's ``total`` of grid[0]
    over the timesteps, consumer2's particle ``means`` (float64) in arrival
    order,
    ``shared`` -- per received tensor, whether its storage is the
    producer's -- the ``report`` and ``transport_stats()`` of the run."""
    lock = threading.Lock()
    written = {}        # storage pointer -> the producer's tensor (kept alive)
    got = {"total": None, "means": [], "shared": []}

    def producer(comm):
        """An unmodified simulation: writes one file per timestep."""
        for t in range(STEPS):
            grid = torch.arange(N, dtype=torch.int64, device=comm.device) + t
            parts = particles(t, N, comm.device)
            with lock:
                written.update({storage(grid): grid, storage(parts): parts})
            with h5.File("outfile.h5", "w") as f:
                f.create_dataset("/group1/grid", data=grid, copy=False)
                f.create_dataset("/group1/particles", data=parts, copy=False)

    def consumer1():
        """Stateful analysis: runs once, loops over timesteps itself."""
        total = 0
        while True:
            f = h5.File("outfile.h5", "r")
            if f is None:          # producer says all-done (query protocol)
                break
            grid = f["/group1/grid"][:]
            total += int(grid[0])
            with lock:
                got["shared"].append(storage(grid) in written)
        got["total"] = total
        print(f"[consumer1] sum of grid[0] over timesteps = {total}")

    def consumer2():
        """Stateless analysis: the driver relaunches it per timestep."""
        f = h5.File("outfile.h5", "r")
        if f is None:
            return
        parts = f["/group1/particles"][:]
        mean = parts.mean(dim=0, dtype=torch.float64)
        with lock:
            got["means"].append(mean)
            got["shared"].append(storage(parts) in written)
        print(f"[consumer2] mean particle on {parts.device} = "
              f"{mean.cpu().numpy().round(3)}")

    reset_transport_stats()
    w = Wilkins(WORKFLOW, {"producer": producer, "consumer1": consumer1,
                           "consumer2": consumer2},
                devices=[torch.device(device)])
    got["report"] = w.run(timeout=120)
    got["stats"] = transport_stats().snapshot()
    return got


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    out = run(ap.parse_args().device)
    assert out["total"] == sum(range(STEPS)), out["total"]
    assert len(out["means"]) == STEPS and all(out["shared"])
    print(out["report"].summary())
