"""Quickstart on the PyTorch port: the paper's Listing 1 workflow, end to
end, with the data as tensors on the card.

One producer writes a grid and a particle list per timestep; two consumers
each subscribe to one dataset.  The task codes do ordinary HDF5-style I/O
-- no workflow API calls -- and the YAML is byte for byte the one of
``examples/quickstart.py``.  The producer hands its tensors over in place
(``create_dataset(..., copy=False)``): each consumer receives a view of
the producer's tensor on the same device, with no copy.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import Wilkins, h5

N = 1_000_000

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


def producer(comm):
    """An unmodified simulation: writes one file per timestep."""
    for t in range(5):
        g = torch.Generator(device=comm.device).manual_seed(t)
        with h5.File("outfile.h5", "w") as f:
            f.create_dataset("/group1/grid", copy=False, data=torch.arange(
                N, dtype=torch.int64, device=comm.device) + t)
            f.create_dataset("/group1/particles", copy=False, data=torch.rand(
                (N, 3), generator=g, device=comm.device))


def consumer1():
    """Stateful analysis: runs once, loops over timesteps itself."""
    total = 0
    while True:
        f = h5.File("outfile.h5", "r")
        if f is None:          # producer says all-done (query protocol)
            break
        total += int(f["/group1/grid"][0])
    print(f"[consumer1] sum of grid[0] over timesteps = {total}")
    assert total == 0 + 1 + 2 + 3 + 4


def consumer2():
    """Stateless analysis: the driver relaunches it per timestep."""
    f = h5.File("outfile.h5", "r")
    if f is None:
        return
    parts = f["/group1/particles"][:]
    print(f"[consumer2] mean particle on {parts.device} = "
          f"{parts.mean(dim=0).cpu().numpy().round(3)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    w = Wilkins(WORKFLOW, {"producer": producer,
                           "consumer1": consumer1,
                           "consumer2": consumer2},
                devices=[torch.device(ap.parse_args().device)])
    report = w.run(timeout=120)
    print(report.summary())
