"""The port's workflow runtime against the JAX package's, end to end: the
same seeded 4->2 redistributing workflow and the quickstart workflow run
through ``repro.core.Wilkins`` and ``repro_torch.core.Wilkins`` on the CPU,
and every consumer must receive the same bytes."""

import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import datamodel as jdm  # noqa: E402
from repro.core import redistribute as jred  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import datamodel as tdm  # noqa: E402
from repro_torch.core import redistribute as tred  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

PACK = ("pack_blocks", "pack_cols")

CPU = torch.device("cpu")
SEED = 2024
SHAPE = (12, 10, 6)   # ragged against 8-row tiles and 2x2 consumer ranks
STEPS = 3


def _yaml(axis):
    redist = "redistribute: 1" if axis == 0 else f"redistribute: {{axis: {axis}}}"
    return f"""
tasks:
  - func: producer
    taskCount: 4
    outports:
      - filename: plt.h5
        dsets: [{{name: /density, memory: 1}}]
  - func: consumer
    taskCount: 2
    nprocs: 2
    inports:
      - filename: plt.h5
        {redist}
        dsets: [{{name: /density, memory: 1}}]
"""


def _field(inst, step):
    return np.random.default_rng(SEED + 100 * inst + step) \
        .normal(size=SHAPE).astype(np.float32)


def _ownership(dm):
    own = dm.BlockOwnership()
    for r, (s, sh) in enumerate(jred.even_blocks(SHAPE, 4)):
        own.add(r, s, sh)
    return own


def _run(core, dm, red, port, axis):
    got = {}
    lock = threading.Lock()
    own = _ownership(dm)

    def producer(comm):
        for t in range(STEPS):
            with core.h5.File("plt.h5", "w") as f:
                f.attrs["producer"] = comm.instance
                f.attrs["step"] = t
                if port:
                    data = convert.tensor_from_numpy(_field(comm.instance, t),
                                                     comm.device)
                    f.create_dataset("/density", data=data, ownership=own,
                                     copy=False)
                else:
                    ds = f.inner.create_dataset(
                        "/density", data=jnp.asarray(_field(comm.instance, t)),
                        copy=False)
                    ds.ownership = own

    def consumer(comm):
        while True:
            f = core.h5.File("plt.h5", "r")
            if f is None:
                break
            blocks = comm.reshard(f["/density"], prefer="pack")
            key = (comm.instance, int(f.attrs["producer"]), int(f.attrs["step"]))
            with lock:
                got[key] = [convert.numpy_from_tensor(b) if port else np.asarray(b)
                            for b in blocks]

    red.reset_plan_cache()
    dm.reset_transport_stats()
    kw = {"devices": [CPU]} if port else {}
    rep = core.Wilkins(_yaml(axis), {"producer": producer, "consumer": consumer},
                       **kw).run(timeout=120)
    return rep, got, dm.transport_stats().snapshot(), red.plan_cache().snapshot()


def _hit_rate(snap):
    return 1 - snap["size"] / (snap["hits"] + snap["misses"])


@pytest.mark.parametrize("axis", [0, 1])
def test_4to2_redistributing_workflow_matches_jax(axis):
    build.reset_launch_counts(PACK)
    trep, tgot, tstats, tpc = _run(tcore, tdm, tred, True, axis)
    jrep, jgot, jstats, jpc = _run(jcore, jdm, jred, False, axis)
    assert len(tgot) == 2 * 2 * STEPS   # each consumer: 2 producers x steps
    assert sorted(tgot) == sorted(jgot)
    for key in tgot:
        assert len(tgot[key]) == len(jgot[key]) == 2
        for a, b in zip(tgot[key], jgot[key]):
            np.testing.assert_array_equal(a, b)
    # every block is the matching slice of the field it came from
    spec = tred.RedistSpec(axis=axis, nslots=2, slot=0, nranks=2)
    dst, _ = spec.dst_boxes(SHAPE)
    for (inst, prod, step), blocks in tgot.items():
        g = _field(prod, step)
        for r, b in zip(range(inst * 2, inst * 2 + 2), blocks):
            starts, sh = dst[r]
            np.testing.assert_array_equal(
                b, g[tuple(slice(s, s + n) for s, n in zip(starts, sh))])
    assert trep.total_served == jrep.total_served == 4 * STEPS
    assert trep.total_bytes_moved == jrep.total_bytes_moved
    for k in ("redist_planned_bytes", "redist_shipped_bytes",
              "redist_baseline_bytes", "redist_aligned", "redist_slabs",
              "reshard_pack", "reshard_numpy"):
        assert tstats[k] == jstats[k], k
    assert tstats["reshard_pack"] == len(tgot) and tstats["reshard_numpy"] == 0
    # Two threads missing the same key at once both count a miss, in both
    # packages (PlanCache compiles outside its lock), so the raw rate varies
    # from run to run; the rate over distinct plans does not.
    assert tpc["hits"] + tpc["misses"] == jpc["hits"] + jpc["misses"]
    assert tpc["size"] == jpc["size"]
    assert _hit_rate(tpc) == _hit_rate(jpc) > 0.8
    # on the CPU the wrappers ran their plain versions: no kernel launched
    assert build.launch_counts(PACK) == {"pack_blocks": 0, "pack_cols": 0}


def _quickstart_workflow():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    try:
        import quickstart
    finally:
        sys.path.pop(0)
    return quickstart.WORKFLOW


def _run_quickstart(core, port):
    n = 2000
    out = {"grid0": [], "particles": []}
    lock = threading.Lock()

    def producer(comm):
        for t in range(5):
            grid = np.arange(n, dtype=np.int64) + t
            parts = np.random.default_rng(t).random((n, 3)).astype(np.float32)
            with core.h5.File("outfile.h5", "w") as f:
                if port:
                    f.create_dataset("/group1/grid", copy=False,
                                     data=convert.tensor_from_numpy(grid, comm.device))
                    f.create_dataset("/group1/particles", copy=False,
                                     data=convert.tensor_from_numpy(parts, comm.device))
                else:
                    f.create_dataset("/group1/grid", data=grid)
                    f.create_dataset("/group1/particles", data=parts)

    def consumer1():
        while True:
            f = core.h5.File("outfile.h5", "r")
            if f is None:
                break
            with lock:
                out["grid0"].append(int(f["/group1/grid"][0]))

    def consumer2():
        f = core.h5.File("outfile.h5", "r")
        if f is None:
            return
        parts = f["/group1/particles"][:]
        if port:
            parts = convert.numpy_from_tensor(parts)
        with lock:
            out["particles"].append(np.array(parts))

    kw = {"devices": [CPU]} if port else {}
    rep = core.Wilkins(_quickstart_workflow(),
                       {"producer": producer, "consumer1": consumer1,
                        "consumer2": consumer2}, **kw).run(timeout=120)
    return rep, out


def test_quickstart_workflow_matches_jax():
    trep, tout = _run_quickstart(tcore, True)
    jrep, jout = _run_quickstart(jcore, False)
    assert tout["grid0"] == jout["grid0"] == [0, 1, 2, 3, 4]
    assert len(tout["particles"]) == len(jout["particles"]) == 5
    key = lambda a: a[0, 0]  # noqa: E731 -- order of stateless relaunches
    for a, b in zip(sorted(tout["particles"], key=key),
                    sorted(jout["particles"], key=key)):
        np.testing.assert_array_equal(a, b)
    assert trep.total_served == jrep.total_served
    assert trep.total_bytes_moved == jrep.total_bytes_moved
