"""End-to-end behaviour of the port's workflow system beside the JAX
package's: the twin of ``tests/test_system.py``.

Every workflow that carries data runs through ``repro.core.Wilkins`` and
``repro_torch.core.Wilkins`` (``devices=[cpu]``) on the same inputs --
numpy arrays on the reference's side, tensors made from them on the
port's -- and the two must deliver the same bytes to each consumer
instance, keyed by (task, instance, producer, step), with the same
served and moved totals and transport counters (``torch_twins``).  Each
reference case has a twin of the same name.  By design:

* ``test_same_code_standalone`` runs the port alone: no workflow, one
  container file, read back with the reference's loader as well;
* ``test_run_failure_chains_secondary_errors_and_attaches_report`` and
  ``test_run_timeout_attaches_partial_report_and_secondary_errors`` carry
  no data, so they run the port alone.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import datamodel as jdm  # noqa: E402
from repro_torch.core import Wilkins, WorkflowGraph, h5  # noqa: E402
from torch_twins import CPU, assert_same, run_both  # noqa: E402


def _grid(t, n=100):
    return np.arange(n, dtype=np.uint64) + t


PIPELINE_YAML = """
tasks:
  - func: producer
    nprocs: 4
    outports:
      - filename: outfile.h5
        dsets:
          - {name: /group1/grid, memory: 1}
          - {name: /group1/particles, memory: 1}
  - func: consumer1
    nprocs: 2
    inports:
      - filename: outfile.h5
        dsets:
          - {name: /group1/grid, memory: 1}
  - func: consumer2
    nprocs: 2
    inports:
      - filename: outfile.h5
        dsets:
          - {name: /group1/particles, memory: 1}
"""


def _listing1(s):
    seen = {"c1": [], "c2": []}

    def producer():
        for t in range(3):
            with s.h5.File("outfile.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/group1/grid", data=s.data(_grid(t).astype(np.int64)))
                f.create_dataset("/group1/particles",
                                 data=s.data(np.full((50, 3), t, np.float32)))

    def consumer1():
        while True:
            f = s.h5.File("outfile.h5", "r")
            if f is None:
                break
            assert "/group1/grid" in f
            assert "/group1/particles" not in f
            seen["c1"].append(int(f["/group1/grid"][0]))
            s.record(("consumer1", 0, 0, int(f.attrs["step"])), f["/group1/grid"])

    def consumer2():
        f = s.h5.File("outfile.h5", "r")
        if f is None:
            return
        assert "/group1/particles" in f and "/group1/grid" not in f
        seen["c2"].append(float(f["/group1/particles"][0, 0]))
        s.record(("consumer2", 0, 0, int(f.attrs["step"])), f["/group1/particles"])

    rep = s.wilkins(PIPELINE_YAML, {"producer": producer, "consumer1": consumer1,
                                    "consumer2": consumer2}).run(timeout=60)
    return rep, seen


def test_listing1_three_task_workflow():
    t, j = run_both(_listing1)
    for run in (t, j):
        rep, seen = run.result
        assert seen["c1"] == [0, 1, 2]
        assert seen["c2"] == [0.0, 1.0, 2.0]
        assert rep.total_served == 6
        assert rep.task_launches[("consumer2", 0)] >= 3
    t.result = t.result[0]
    j.result = j.result[0]
    assert_same(t, j)


def test_same_code_standalone(tmp_path):
    h5.set_standalone_dir(str(tmp_path))
    try:
        def producer():
            with h5.File("outfile.h5", "w") as f:
                f.create_dataset("/group1/grid", data=torch.from_numpy(
                    _grid(7).astype(np.int64)))

        def consumer():
            f = h5.File("outfile.h5", "r")
            return np.asarray(f["/group1/grid"][:])

        producer()
        got = consumer()
        np.testing.assert_array_equal(got, _grid(7))
        # the container on disk is the reference's format
        back = jdm.File.load(str(tmp_path / "outfile.h5"))
        np.testing.assert_array_equal(back["/group1/grid"][:], _grid(7))
    finally:
        h5.set_standalone_dir(".")


SPILL_YAML = """
tasks:
  - func: p
    outports:
      - filename: out.h5
        dsets:
          - {name: /d, file: 1, memory: 0}
  - func: c
    inports:
      - filename: out.h5
        dsets:
          - {name: /d, file: 1, memory: 0}
"""


def _spill(s, tmp_path):
    def p():
        with s.h5.File("out.h5", "w") as f:
            f.create_dataset("/d", data=s.data(np.arange(10.0)))

    def c():
        f = s.h5.File("out.h5", "r")
        if f is not None:
            d = f["/d"].read_direct()
            assert isinstance(d, np.memmap) or isinstance(d.base, np.memmap)
            s.record(("c", 0, 0, 0), d)

    return s.wilkins(SPILL_YAML, {"p": p, "c": c},
                     spill_dir=str(tmp_path / s.name)).run(timeout=30)


def test_file_transport_spill(tmp_path):
    t, j = run_both(_spill, tmp_path)
    assert len(t.side.got) == 1
    dt, shape, raw = t.side.got[("c", 0, 0, 0)]
    np.testing.assert_array_equal(np.frombuffer(raw, dtype=dt), np.arange(10.0))
    assert_same(t, j)


FANIN_YAML = """
tasks:
  - func: producer
    taskCount: 4
    outports:
      - filename: outfile.h5
        dsets: [{name: /group1/grid, memory: 1}]
  - func: consumer
    taskCount: 2
    nprocs: 5
    inports:
      - filename: outfile.h5
        dsets: [{name: /group1/grid, memory: 1}]
"""


def _fanin(s):
    got = {0: 0, 1: 0}

    def producer(comm):
        with s.h5.File("outfile.h5", "w") as f:
            f.attrs["producer"] = comm.instance
            f.create_dataset("/group1/grid",
                             data=s.data(_grid(comm.instance).astype(np.int64)))

    def consumer(comm):
        while True:
            f = s.h5.File("outfile.h5", "r")
            if f is None:
                break
            s.record(("consumer", comm.instance, int(f.attrs["producer"]), 0),
                     f["/group1/grid"])
            with s.lock:
                got[comm.instance] += 1

    rep = s.wilkins(FANIN_YAML, {"producer": producer,
                                 "consumer": consumer}).run(timeout=60)
    assert got == {0: 2, 1: 2}
    return rep


def test_ensemble_fanin_round_robin():
    g = WorkflowGraph.from_yaml(FANIN_YAML)
    assert len(g.edges) == 1
    assert g.edges[0].instance_links(4, 2) == [(0, 0), (1, 1), (2, 0), (3, 1)]
    t, j = run_both(_fanin)
    assert sorted((c, p) for (_, c, p, _) in t.side.got) == \
        [(0, 0), (0, 2), (1, 1), (1, 3)]
    assert_same(t, j)


def _topology(s, np_, nc, topology):
    yaml = f"""
tasks:
  - func: producer
    taskCount: {np_}
    outports:
      - filename: o.h5
        dsets: [{{name: /g, memory: 1}}]
  - func: consumer
    taskCount: {nc}
    inports:
      - filename: o.h5
        dsets: [{{name: /g, memory: 1}}]
"""

    def producer(comm):
        with s.h5.File("o.h5", "w") as f:
            f.attrs["producer"] = comm.instance
            f.create_dataset("/g", data=s.data(_grid(1).astype(np.int64)))

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            s.record(("consumer", comm.instance, int(f.attrs["producer"]), 0),
                     f["/g"])

    w = s.wilkins(yaml, {"producer": producer, "consumer": consumer})
    assert w.graph.topology_kind() == topology
    return w.run(timeout=60)


@pytest.mark.parametrize("topology,np_,nc", [("fan-out", 1, 4), ("NxN", 3, 3)])
def test_ensemble_topologies(topology, np_, nc):
    t, j = run_both(_topology, np_, nc, topology)
    assert len(t.side.got) == max(np_, nc)
    assert_same(t, j)


def test_subset_writers():
    yaml = """
tasks:
  - func: sim
    nprocs: 32
    nwriters: 1
    outports:
      - filename: dump.h5
        dsets: [{name: /particles/*, memory: 1}]
  - func: detector
    nprocs: 8
    inports:
      - filename: dump.h5
        dsets: [{name: /particles/*, memory: 1}]
"""
    w = Wilkins(yaml, {"sim": lambda: None, "detector": lambda: None},
                devices=[CPU])
    vol = w.vols[("sim", 0)]
    assert vol.io_procs == 1 and vol.nprocs == 32
    comm = w._make_comm("sim", 0)
    assert comm.is_io_proc(0) and not comm.is_io_proc(1)
    assert comm.device == CPU


ACTIONS = """
def nyx(vol, rank):
    def afc_cb(f):
        if vol.file_close_counter % 2 == 1:
            vol.clear_files()
        else:
            vol.serve_all(True, True)
            vol.clear_files()
            vol.broadcast_files()
    def bfo_cb(name):
        pass
    vol.set_after_file_close(afc_cb)
    vol.set_before_file_open(bfo_cb)
"""

ACTIONS_YAML = """
tasks:
  - func: nyx
    nprocs: 4
    actions: ["actions", "nyx"]
    outports:
      - filename: plt*.h5
        dsets: [{name: /level_0/density, memory: 1}]
  - func: reeber
    nprocs: 2
    inports:
      - filename: plt*.h5
        dsets: [{name: /level_0/density, memory: 1}]
"""


def _actions(s, tmp_path):
    received = []

    def nyx():
        for t in range(2):
            with s.h5.File(f"plt{t:05d}.h5", "w") as f:
                f.create_dataset("/level_0/density", data=s.data(np.zeros(4)))
            with s.h5.File(f"plt{t:05d}.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/level_0/density",
                                 data=s.data(np.full(64, float(t))))

    def reeber():
        while True:
            f = s.h5.File("plt*.h5", "r")
            if f is None:
                break
            received.append(float(f["/level_0/density"][0]))
            s.record(("reeber", 0, 0, int(f.attrs["step"])), f["/level_0/density"])

    rep = s.wilkins(ACTIONS_YAML, {"nyx": nyx, "reeber": reeber},
                    action_dirs=[str(tmp_path)]).run(timeout=60)
    assert received == [0.0, 1.0]
    return rep


def test_custom_actions_nyx_idiom(tmp_path):
    (tmp_path / "actions.py").write_text(ACTIONS)
    t, j = run_both(_actions, tmp_path)
    assert_same(t, j)


RESTART_YAML = """
tasks:
  - func: flaky
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    inports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
"""


def _restart(s):
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("injected failure")
        with s.h5.File("o.h5", "w") as f:
            f.create_dataset("/g", data=s.data(_grid(0).astype(np.int64)))

    def consumer():
        f = s.h5.File("o.h5", "r")
        if f is not None:
            s.record(("consumer", 0, 0, 0), f["/g"])

    rep = s.wilkins(RESTART_YAML, {"flaky": flaky, "consumer": consumer},
                    max_restarts=2).run(timeout=30)
    assert attempts["n"] == 2
    assert len(rep.failures) == 1
    return rep


def test_fault_tolerance_restart():
    t, j = run_both(_restart)
    assert list(t.side.got) == [("consumer", 0, 0, 0)]
    assert_same(t, j)


CYCLE_YAML = """
tasks:
  - func: sim
    outports:
      - filename: state.h5
        dsets: [{name: /x, memory: 1}]
    inports:
      - filename: steer.h5
        dsets: [{name: /param, memory: 1}]
  - func: steer
    inports:
      - filename: state.h5
        dsets: [{name: /x, memory: 1}]
    outports:
      - filename: steer.h5
        dsets: [{name: /param, memory: 1}]
"""


def _cycle(s):
    steps = {"sim": [], "steer": []}

    def sim():
        x = 1.0
        for t in range(3):
            with s.h5.File("state.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/x", data=s.data(np.array([x])))
            f = s.h5.File("steer.h5", "r")
            if f is None:
                break
            s.record(("sim", 0, 0, int(f.attrs["step"])), f["/param"])
            x = float(f["/param"][0])
            steps["sim"].append(x)

    def steer():
        while True:
            f = s.h5.File("state.h5", "r")
            if f is None:
                break
            t = int(f.attrs["step"])
            s.record(("steer", 0, 0, t), f["/x"])
            x = float(f["/x"][0])
            steps["steer"].append(x)
            with s.h5.File("steer.h5", "w") as g2:
                g2.attrs["step"] = t
                g2.create_dataset("/param", data=s.data(np.array([x * 2])))

    rep = s.wilkins(CYCLE_YAML, {"sim": sim, "steer": steer}).run(timeout=60)
    assert steps["sim"] == [2.0, 4.0, 8.0]
    return rep


def test_cycle_topology():
    g = WorkflowGraph.from_yaml(CYCLE_YAML)
    assert len(g.edges) == 2
    t, j = run_both(_cycle)
    assert len(t.side.got) == 6
    assert_same(t, j)


def test_run_failure_chains_secondary_errors_and_attaches_report():
    from repro_torch.core.driver import WorkflowReport

    yaml = """
tasks:
  - func: a
  - func: b
"""

    def a():
        raise ValueError("boom-a")

    def b():
        time.sleep(0.05)
        raise KeyError("boom-b")

    w = Wilkins(yaml, {"a": a, "b": b}, devices=[CPU])
    with pytest.raises((ValueError, KeyError)) as ei:
        w.run(timeout=30)
    err = ei.value
    kinds, e = set(), err
    while e is not None:
        kinds.add(type(e))
        e = e.__context__
    assert {ValueError, KeyError} <= kinds
    rep = err.report
    assert isinstance(rep, WorkflowReport)
    assert rep.wall_time_s > 0
    assert {f.error for f in rep.failures} == \
        {"ValueError: boom-a", "KeyError: 'boom-b'"}


def test_run_timeout_attaches_partial_report_and_secondary_errors():
    yaml = """
tasks:
  - func: hang
  - func: fail
"""
    release = threading.Event()

    def hang():
        release.wait(5.0)

    def fail():
        raise RuntimeError("early failure")

    w = Wilkins(yaml, {"hang": hang, "fail": fail}, devices=[CPU])
    with pytest.raises(TimeoutError) as ei:
        w.run(timeout=0.3)
    release.set()
    err = ei.value
    assert "wilkins-hang-0" in str(err)
    rep = err.report
    assert rep.channels == [] or rep.channels is w.channels
    assert [f.error for f in rep.failures] == ["RuntimeError: early failure"]
    kinds, e = set(), err
    while e is not None:
        kinds.add(type(e))
        e = e.__context__
    assert RuntimeError in kinds
