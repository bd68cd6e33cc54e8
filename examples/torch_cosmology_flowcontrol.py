"""Cosmology use case (paper §4.2.2) on the PyTorch port: Nyx + Reeber with
flow control and the custom double-open/close I/O idiom handled by an
external action script.

The port of ``examples/cosmology_flowcontrol.py``: the density update and
the halo count are torch on the task's device (``cuda:0`` unless
``--device`` says otherwise) in place of the reference's ``jax.jit``
functions, and the noise comes from a ``torch.Generator`` seeded per
snapshot, so the fields differ from the reference's ``jax.random`` draw;
which snapshots are served, analysed and skipped does not.  The field is
handed over in place (``create_dataset(..., copy=False)``).

Wilkins features exercised:
  * custom actions (paper Listing 5) from a user script -- task code unchanged,
  * flow control ``io_freq: 2`` (the 'some' strategy, paper Table 3),
  * filename glob ports (``plt*.h5``).

    PYTHONPATH=src python examples/torch_cosmology_flowcontrol.py [--device cpu]
"""

import argparse
import os
import tempfile
import threading
import time

import torch

from repro_torch.core import Wilkins, h5

GRID = 48
SNAPSHOTS = 10

ACTION_SCRIPT = '''
def nyx(vol, rank):
    """Paper Listing 5: serve only at the second close of each snapshot."""
    def afc_cb(f):
        if vol.file_close_counter % 2 == 1:
            vol.clear_files()          # 1st close: single-rank metadata write
        else:
            vol.serve_all(True, True)  # 2nd close: bulk data -> consumer
            vol.clear_files()
            vol.broadcast_files()
    vol.set_after_file_close(afc_cb)
'''

WORKFLOW = """
tasks:
  - func: nyx
    nprocs: 1024
    actions: ["nyx_actions", "nyx"]
    outports:
      - filename: plt*.h5
        dsets:
          - {name: /level_0/density, memory: 1}
  - func: reeber
    nprocs: 64
    inports:
      - filename: plt*.h5
        io_freq: 2   # 'some' flow control: analyze every 2nd snapshot
        dsets:
          - {name: /level_0/density, memory: 1}
"""


def nyx_step(rho, gen):
    lap = sum(torch.roll(rho, s, a) for a in range(3) for s in (1, -1)) - 6 * rho
    noise = torch.randn(rho.shape, generator=gen, device=rho.device)
    return torch.clamp(rho + 0.1 * lap + 0.06 * noise * rho, min=0.0)


def find_halos(rho, cutoff=1.05):
    return (rho > cutoff).sum()


def snapshots(grid, count, device):
    """Nyx's density after each snapshot: the noise of snapshot ``t`` from
    a generator seeded with ``t`` on ``device``."""
    rho = torch.ones((grid, grid, grid), device=device)
    for t in range(count):
        rho = nyx_step(rho, torch.Generator(device=device).manual_seed(t))
        yield t, rho


def storage(x):
    return x.untyped_storage().data_ptr()


def run(device="cuda:0", grid=GRID, count=SNAPSHOTS):
    """Run the workflow with the action script written to a temporary
    ``action_dirs`` entry.  Returns ``(analysed, report,
    broadcasts)``: ``analysed`` maps each snapshot reeber analysed to
    (halo cells, the payload's device, its shape, whether it shares the
    storage nyx wrote); ``broadcasts`` is nyx's VOL log of the action
    script's ``broadcast_files`` calls, one per served close."""
    lock = threading.Lock()
    written = {}        # storage pointer -> nyx's field (kept alive)
    analysed = {}

    def nyx(comm):
        for t, rho in snapshots(grid, count, comm.device):
            with lock:
                written[storage(rho)] = rho
            # Nyx's custom I/O: open/close twice per snapshot (paper §4.2.2)
            with h5.File(f"plt{t:05d}.h5", "w") as f:   # 1st: metadata from rank 0
                f.create_dataset("/level_0/density",
                                 data=torch.zeros(1, device=comm.device),
                                 copy=False)
            with h5.File(f"plt{t:05d}.h5", "w") as f:   # 2nd: bulk parallel write
                ds = f.create_dataset("/level_0/density", data=rho, copy=False)
                ds.attrs["a"] = 1.0 / (1.0 + 10 - t)     # scale factor

    def reeber():
        while True:
            f = h5.File("plt*.h5", "r")
            if f is None:
                break
            rho = f["/level_0/density"][:]
            n = int(find_halos(rho))
            time.sleep(0.1)  # Reeber is slower than Nyx (why flow control exists)
            with lock:
                analysed[int(f.filename[3:8])] = (
                    n, str(rho.device), tuple(rho.shape), storage(rho) in written)
            print(f"[reeber] {f.filename}: {n} halo cells above cutoff")
        print(f"[reeber] analyzed {len(analysed)}/{count} snapshots "
              f"(io_freq=2 -> every 2nd)")

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "nyx_actions.py"), "w") as f:
            f.write(ACTION_SCRIPT)
        w = Wilkins(WORKFLOW, {"nyx": nyx, "reeber": reeber},
                    action_dirs=[d], devices=[torch.device(device)])
        report = w.run(timeout=300)
    return analysed, report, list(w.vols[("nyx", 0)]._broadcast_log)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    analysed, report, _ = run(ap.parse_args().device)
    print(report.summary())
