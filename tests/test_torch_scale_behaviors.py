"""Scale behaviours on the port beside the JAX package: the twin of
``tests/test_scale_behaviors.py`` -- straggler mitigation via ``latest``
flow control, and elastic ensemble re-sizing via re-matching.  Both
workflows run through both packages on the same inputs (tensors on the
port's side).  Under ``latest`` which steps a consumer sees depends on
thread timing, so that twin holds every delivery to the producer's
payload for its step and compares the steps both packages delivered."""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_twins import assert_same, assert_same_deliveries, run_both  # noqa: E402

STRAGGLER_YAML = """
tasks:
  - func: sim
    taskCount: 3
    outports:
      - filename: o.h5
        dsets: [{name: /x, memory: 1}]
  - func: ana
    taskCount: 3
    inports:
      - filename: o.h5
        io_freq: -1
        dsets: [{name: /x, memory: 1}]
"""


def _straggler(s):
    counts = {0: 0, 1: 0, 2: 0}

    def sim(comm):
        slow = comm.instance == 1
        for t in range(6):
            time.sleep(0.12 if slow else 0.01)
            with s.h5.File("o.h5", "w") as f:
                f.attrs["producer"] = comm.instance
                f.attrs["step"] = t
                f.create_dataset("/x", data=s.data(np.array([t])))

    def ana(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                return
            time.sleep(0.02)
            s.record(("ana", comm.instance, int(f.attrs["producer"]),
                      int(f.attrs["step"])), f["/x"][:])
            with s.lock:
                counts[comm.instance] += 1

    t0 = time.monotonic()
    rep = s.wilkins(STRAGGLER_YAML, {"sim": sim, "ana": ana}).run(timeout=60)
    return rep, time.monotonic() - t0, counts


def test_latest_mitigates_straggler_instance():
    t, j = run_both(_straggler)
    for run in (t, j):
        rep, wall, counts = run.result
        assert wall < 2.0
        assert counts[0] >= 1 and counts[2] >= 1
        assert rep.total_dropped >= 1
        for (_, inst, prod, step), (dt, shape, raw) in run.side.got.items():
            assert inst == prod                       # NxN pairing
            assert np.frombuffer(raw, dtype=dt).tolist() == [step]
    # the steps that got through depend on timing; those both delivered
    # carry the same bytes
    assert_same_deliveries(t, j, keys=set(t.side.got) & set(j.side.got))


def _doc(n_prod, n_cons):
    return {
        "tasks": [
            {"func": "p", "taskCount": n_prod,
             "outports": [{"filename": "o.h5",
                           "dsets": [{"name": "/g", "memory": 1}]}]},
            {"func": "c", "taskCount": n_cons,
             "inports": [{"filename": "o.h5",
                          "dsets": [{"name": "/g", "memory": 1}]}]},
        ]
    }


def _resized(s):
    def p(comm):
        with s.h5.File("o.h5", "w") as f:
            f.attrs["producer"] = comm.instance
            f.create_dataset("/g", data=s.data(np.arange(8) + comm.instance))

    def c(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                return
            s.record(("c", comm.instance, int(f.attrs["producer"]), 0),
                     f["/g"][:])

    return s.wilkins(_doc(8, 4), {"p": p, "c": c}).run(timeout=30)


def test_elastic_ensemble_resize_rematches():
    from repro_torch.core import WorkflowGraph

    g1 = WorkflowGraph.from_yaml(_doc(4, 2))
    g2 = WorkflowGraph.from_yaml(_doc(8, 4))
    assert len(g1.edges) == len(g2.edges) == 1
    assert g1.edges[0].instance_links(4, 2) == [(0, 0), (1, 1), (2, 0), (3, 1)]
    links2 = g2.edges[0].instance_links(8, 4)
    assert len(links2) == 8
    assert {c for _, c in links2} == {0, 1, 2, 3}

    t, j = run_both(_resized)
    assert len(t.side.got) == 8
    # each consumer received exactly the producers its links name
    assert sorted((c, p) for (_, c, p, _) in t.side.got) == \
        sorted((c, p) for p, c in links2)
    assert_same(t, j)
