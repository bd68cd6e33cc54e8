"""The port's elastic rescale against the JAX package's (mirrors
``tests/test_rescale.py``, whose unmarked cases each appear here).

Every workflow case runs the same YAML and the same fault plan through
``repro.core.Wilkins`` and ``repro_torch.core.Wilkins`` on the CPU.  The
producers write the same seeded numpy fields; the port's producers hand
them over as tensors (``copy=False``) and its consumers accumulate and
checkpoint tensors.  Each case holds the consumers' concatenated output
byte-identical across the packages and to the crash-free sum, the
``report.rescales``/``restarts``/``stalls`` fields equal, and the steps
each final incarnation received (the replayed ones first) equal.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
# The JAX package imports its whole ``train`` package (optimizer, trainer)
# at a task's first ``restore``, inside the watchdog's window: cold, that
# import can silence every instance past a 0.25 s stall timeout (ROADMAP
# Queue 3).  Import it here so the stall cases compare the protocol.
import repro.train.checkpoint  # noqa: E402,F401
import repro_torch.core as tcore  # noqa: E402
from repro.core import reshard_blocks as jreshard_blocks  # noqa: E402
from repro.core.redistribute import even_blocks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (FailurePolicy, FaultSpec,  # noqa: E402
                              TelemetryTimeline, WorkflowGraph,
                              reshard_blocks)
from repro_torch.core import rescale as trescale  # noqa: E402
from repro_torch.core.datamodel import File  # noqa: E402

CPU = torch.device("cpu")
SEED = 14
STEPS = 4
GLOBAL = 50  # deliberately not divisible by 3: ragged shards in the sweep

DSETS = {"a.h5": "/g", "b.h5": "/h"}


def _a(t):
    return np.random.default_rng(SEED + t).standard_normal(GLOBAL)


def _b(t):
    return np.random.default_rng(SEED + 100 + t).standard_normal(GLOBAL)


EXPECTED_C1 = sum(_a(t) for t in range(STEPS))
EXPECTED_C2 = sum(_a(t) + 3.0 * _b(t) for t in range(STEPS))


def _rescale_yaml(n1=1, n2=1, extra_c1="", nprocs_c1=1):
    """2 single-instance producers -> 2 two-instance elastic consumers."""
    return f"""
tasks:
  - func: p1
    outports:
      - filename: a.h5
        dsets: [{{name: /g, memory: 1}}]
    on_failure:
      restart: {{max_retries: 3}}
  - func: p2
    outports:
      - filename: b.h5
        dsets: [{{name: /h, memory: 1}}]
    on_failure:
      restart: {{max_retries: 3}}
  - func: c1
    taskCount: 2
    nprocs: {nprocs_c1}
    {extra_c1}
    inports:
      - filename: a.h5
        redistribute: 1
        dsets: [{{name: /g, memory: 1}}]
    on_failure:
      rescale: {{nslots: {n1}, max_retries: 3}}
  - func: c2
    taskCount: 2
    inports:
      - filename: a.h5
        redistribute: 1
        dsets: [{{name: /g, memory: 1}}]
      - filename: b.h5
        redistribute: 1
        dsets: [{{name: /h, memory: 1}}]
    on_failure:
      rescale: {{nslots: {n2}, max_retries: 3}}
"""


# ---------------------------------------------------------------------------
# one task body per package: numpy in the JAX package, tensors in the port
# ---------------------------------------------------------------------------
class Pkg:
    def __init__(self, port):
        self.port = port
        self.core = tcore if port else jcore

    def wilkins(self, yaml, funcs, **kw):
        if self.port:
            kw["devices"] = [CPU]
        return self.core.Wilkins(yaml, funcs, **kw)

    def array(self, a, comm):
        return convert.tensor_from_numpy(a, comm.device) if self.port else a

    def zeros(self, shape, dtype, comm):
        return self.array(np.zeros(shape, dtype), comm)

    def host(self, x):
        return convert.numpy_from_tensor(x).copy() if self.port \
            else np.asarray(x).copy()

    def write(self, filename, t, data, comm):
        with self.core.h5.File(filename, "w") as f:
            f.attrs["step"] = t
            if self.port:
                f.create_dataset(DSETS[filename], copy=False,
                                 data=self.array(data, comm))
            else:
                f.create_dataset(DSETS[filename], data=data)

    def producer(self, filename, make, hook=None):
        def producer():
            comm = self.core.world()
            state = {"step": self.zeros((), np.int64, comm)}
            restored = comm.restore(state)
            start = 0
            if restored is not None:
                _, state = restored
                start = int(state["step"])
            for t in range(start, STEPS):
                self.write(filename, t, make(t), comm)
                comm.checkpoint({"step": self.array(np.array(t + 1, np.int64),
                                                    comm)})
                if hook is not None:
                    hook(comm, t, start)
        return producer

    def consumer(self, results, key, primary, extras=(), weights=(1.0,)):
        """Accumulate this instance's slab of every step; shard-checkpoint
        it.  The accumulator is sized from the instance's frozen
        ``RedistSpec``, so the same body runs at any instance count.

        A pure consumer whose body returned is launched again, in the same
        incarnation (the same ``comm``), while any of its producers has not
        yet marked its channel done (the query protocol, driver.py
        ``_run_instance``).  Whether that relaunch happens is a race with
        the producer's close in either package, and the relaunch restores
        the last checkpoint and receives nothing; so the steps recorded for
        an instance (and the payload types it saw) are those of every
        launch of its final incarnation."""
        launches = {}  # instance -> (comm, steps, kinds) of its incarnation

        def consumer():
            comm = self.core.world()
            live = launches.get(comm.instance)
            if live is None or live[0] is not comm:  # a new incarnation
                live = launches[comm.instance] = (comm, [], set())
            _, steps, kinds = live
            spec = comm.resolve_redist_spec(port=primary)
            _, shape = even_blocks((GLOBAL,), spec.nslots)[spec.slot]
            like = {"acc": self.zeros(shape, np.float64, comm),
                    "n": self.zeros((), np.int64, comm)}
            state = like
            restored = comm.restore(like)
            if restored is not None:
                _, state = restored
            acc = state["acc"].clone() if self.port \
                else np.asarray(state["acc"]).copy()
            n = int(state["n"])
            while True:
                f0 = self.core.h5.File(primary, "r")
                if f0 is None:
                    break
                steps.append(int(f0.attrs["step"]))
                slab = f0[DSETS[primary]][...]
                kinds.add(type(slab).__name__)
                delta = weights[0] * slab
                for w, extra in zip(weights[1:], extras):
                    fx = self.core.h5.File(extra, "r")
                    delta = delta + w * fx[DSETS[extra]][...]
                acc = acc + delta
                n += 1
                comm.checkpoint({"acc": acc,
                                 "n": self.array(np.array(n, np.int64), comm)},
                                sharded_axes={"acc": 0})
            results[(key, comm.instance)] = (self.host(acc), n, steps, kinds)
        return consumer

    def funcs(self, results, p1_hook=None):
        return {
            "p1": self.producer("a.h5", _a, p1_hook),
            "p2": self.producer("b.h5", _b),
            "c1": self.consumer(results, "c1", "a.h5"),
            "c2": self.consumer(results, "c2", "a.h5", extras=("b.h5",),
                                weights=(1.0, 3.0)),
        }


PKGS = (Pkg(port=False), Pkg(port=True))


def _output(w, results, key):
    parts = []
    for j in range(w.graph.tasks[key].task_count):
        assert (key, j) in results, \
            f"{key}[{j}] never finished (have {sorted(results)})"
        acc, n, _, _ = results[(key, j)]
        assert n == STEPS, f"{key}[{j}] saw {n}/{STEPS} steps"
        parts.append(acc)
    return np.concatenate(parts)


def _summary(w, rep, results):
    """What must agree across the packages.  Events of different tasks
    interleave as their threads run, so each list is ordered by task (a
    stable sort: one task's events keep their order)."""
    ev = lambda evs, ks: sorted(({k: e[k] for k in ks} for e in evs),  # noqa: E731
                                key=lambda e: e["task"])
    return {
        "c1": _output(w, results, "c1").tobytes(),
        "c2": _output(w, results, "c2").tobytes(),
        "task_counts": {k: w.graph.tasks[k].task_count for k in ("c1", "c2")},
        "rescales": ev(rep.rescales, ("task", "old_nslots", "new_nslots",
                                      "old_nprocs", "new_nprocs", "trigger",
                                      "cut_step")),
        "restarts": ev(rep.restarts, ("task", "instance", "attempt", "epoch")),
        "stalls": ev(rep.stalls, ("task", "instance", "timeout_s", "action")),
        "steps": {k: v[2] for k, v in results.items()},
    }


def _unpin(summary):
    """A spec without ``instance`` fires on whichever instance gets there
    first, in either package: compare what does not depend on which.

    The cut step is the newest checkpoint every old instance holds, so it
    depends on how far the other instances had got when the fault fired;
    under load it varies from run to run in either package.  Each resized
    instance must have received exactly the steps after its own package's
    cut; the cut and those steps are not compared across the packages."""
    out = dict(summary)
    out["restarts"] = [{k: v for k, v in e.items() if k != "instance"}
                       for e in summary["restarts"]]
    cuts = {e["task"]: e["cut_step"] for e in summary["rescales"]}
    out["rescales"] = [{k: v for k, v in e.items() if k != "cut_step"}
                       for e in summary["rescales"]]
    for (task, j), steps in summary["steps"].items():
        if task in cuts:
            assert steps == list(range(cuts[task] + 1, STEPS)), \
                f"{task}[{j}] got {steps} after cut {cuts[task]}"
    out["steps"] = sorted(v for (task, _), v in summary["steps"].items()
                          if task not in cuts)
    return out


def _run_both(tmp_path, tag, yaml=None, faults=None, p1_hook=None,
              racy=False, **yaml_kw):
    """Run the workflow in both packages; assert they agree and match the
    crash-free sum; return the port's (workflow, report, results).

    ``racy``: the trigger (a steering call, the stall watchdog) races the
    live instances, so how far they got -- the cut step, and the steps
    each incarnation saw -- varies from run to run in either package and
    is not compared."""
    yaml = yaml or _rescale_yaml(**yaml_kw)
    if isinstance(faults, FaultSpec):
        faults = [faults]
    # each package builds its own FaultSpecs from the same fields
    faults = [dataclasses.asdict(f) for f in faults or ()]
    out = {}
    for pkg in PKGS:
        results = {}
        w = pkg.wilkins(yaml, pkg.funcs(results, p1_hook),
                        spill_dir=str(tmp_path / f"{tag}_{pkg.port}"))
        rep = w.run(timeout=60, faults=faults or None)
        out[pkg.port] = (w, rep, results, _summary(w, rep, results))
    jsum, tsum = out[False][3], out[True][3]
    if any(f["instance"] is None for f in faults):
        jsum, tsum = _unpin(jsum), _unpin(tsum)
    assert tsum["c1"] == jsum["c1"] == EXPECTED_C1.tobytes()
    assert tsum["c2"] == jsum["c2"] == EXPECTED_C2.tobytes()
    if racy:
        for summ in (jsum, tsum):
            summ["steps"] = None
            for e in summ["rescales"]:
                e.pop("cut_step")
    for k in ("task_counts", "rescales", "restarts", "stalls", "steps"):
        assert tsum[k] == jsum[k], k
    # every delivery, replayed or live, reached the port's tasks as a tensor
    assert all(v[3] == {"Tensor"} for v in out[True][2].values())
    return out[True][:3]


# ---------------------------------------------------------------------------
# baseline: the elastic workflow without any fault is byte-exact at size 2
# ---------------------------------------------------------------------------
def test_crash_free_elastic_workflow(tmp_path):
    w, rep, _ = _run_both(tmp_path, "ref")
    assert rep.rescales == [] and rep.stalls == []
    assert w.graph.tasks["c1"].task_count == 2


# ---------------------------------------------------------------------------
# crash -> policy rescale (shrink AND grow) -> byte-identical
# ---------------------------------------------------------------------------
def test_policy_rescale_shrink_byte_identical(tmp_path):
    w, rep, results = _run_both(
        tmp_path, "shrink", n1=1,
        faults=FaultSpec(task="c1", point="recv", step=1, instance=0))
    assert w.graph.tasks["c1"].task_count == 1
    assert len(rep.rescales) == 1
    ev = rep.rescales[0]
    assert (ev["task"], ev["old_nslots"], ev["new_nslots"], ev["trigger"]) \
        == ("c1", 2, 1, "policy")
    assert ev["latency_s"] >= 0.0 and "InjectedFault" in ev["reason"]
    # the resized instance got the replayed steps after the cut, then the rest
    assert results[("c1", 0)][2] == list(range(ev["cut_step"] + 1, STEPS))
    tl = rep.timeline.events("rescale")
    assert len(tl) == 1 and tl[0]["task"] == "c1"
    assert "RESCALE c1: nslots 2->1" in rep.summary()
    assert rep.scheduler["rescale_events"] == tl
    assert rep.scheduler["rescales"] == 1
    # the new instance's device group was cut from the old instances'
    assert w.device_groups[("c1", 0)] == [CPU]
    assert ("c1", 1) not in w.device_groups


def test_policy_rescale_grow_byte_identical(tmp_path):
    w, rep, _ = _run_both(
        tmp_path, "grow", n2=3,
        faults=FaultSpec(task="c2", point="open", step=2, instance=1))
    assert w.graph.tasks["c2"].task_count == 3
    assert [r["new_nslots"] for r in rep.rescales] == [3]
    assert "RESCALE c2: nslots 2->3" in rep.summary()
    assert all(w.device_groups[("c2", j)] == [CPU] for j in range(3))


def test_rescale_with_producer_restart_in_same_run(tmp_path):
    _, rep, _ = _run_both(tmp_path, "mixed", n1=1, faults=[
        FaultSpec(task="p1", point="close", step=1),
        FaultSpec(task="c1", point="recv", step=2, instance=1),
    ])
    assert [r["task"] for r in rep.restarts] == ["p1"]
    assert [r["task"] for r in rep.rescales] == ["c1"]


#: the reference's representative subset of its M->N sweep: shrink, grow and
#: same size, first/mid/last step, before and after delivery, both consumers
FAST_SWEEP = [
    ("c1", "recv", 0, 1),
    ("c1", "open", STEPS - 1, 3),
    ("c2", "recv", 3, 1),
    ("c2", "open", 5, 3),
    ("c1", "recv", 2, 2),
]


def _sweep_cases():
    """The reference's exhaustive M->N sweep (tests/test_rescale.py
    ``_sweep_cases``): every target size in {1, 2, 3}, each consumer at
    every open and recv -- c2 opens two files a loop, so its steps run to
    2 * STEPS - 1."""
    cases = []
    for n in (1, 2, 3):
        for pt in ("open", "recv"):
            cases += [("c1", pt, s, n) for s in range(STEPS)]
            cases += [("c2", pt, s, n) for s in range(2 * STEPS)]
    return cases


SWEEP = _sweep_cases()


def _run_sweep_case(tmp_path, task, point, step, n):
    kw = {"n1": n} if task == "c1" else {"n2": n}
    w, rep, _ = _run_both(tmp_path, f"{task}_{point}_{step}_{n}",
                          faults=FaultSpec(task=task, point=point, step=step),
                          **kw)
    assert w.graph.tasks[task].task_count == n
    if n != 2:
        assert [r["task"] for r in rep.rescales] == [task]
        assert rep.rescales[0]["new_nslots"] == n


@pytest.mark.parametrize("task,point,step,n", FAST_SWEEP)
def test_rescale_sweep_representative(tmp_path, task, point, step, n):
    _run_sweep_case(tmp_path, task, point, step, n)


@pytest.mark.slow
@pytest.mark.parametrize("task,point,step,n", SWEEP)
def test_rescale_sweep_exhaustive(tmp_path, task, point, step, n):
    _run_sweep_case(tmp_path, task, point, step, n)


# ---------------------------------------------------------------------------
# programmatic trigger: comm.rescale() without any fault
# ---------------------------------------------------------------------------
def test_programmatic_rescale_from_task_code(tmp_path):
    def steer(comm, t, start):
        if t == 1 and start == 0:
            assert comm.rescale("c1", nslots=1,
                                reason="steering decision") is not None

    w, rep, _ = _run_both(tmp_path, "api", n1=1, p1_hook=steer,
                          racy=True)
    assert w.graph.tasks["c1"].task_count == 1
    assert len(rep.rescales) == 1
    ev = rep.rescales[0]
    assert ev["trigger"] == "api" and ev["reason"] == "steering decision"
    assert "RESCALE c1" in rep.summary()


# ---------------------------------------------------------------------------
# health watchdog: stall detection and rescale-down
# ---------------------------------------------------------------------------
def test_watchdog_stall_triggers_rescale_down(tmp_path):
    w, rep, _ = _run_both(
        tmp_path, "stall", n1=1, extra_c1="stall_timeout_s: 0.25",
        racy=True,
        faults=FaultSpec(task="c1", kind="stall", point="recv", step=1,
                         instance=0, seconds=1.5))
    assert w.graph.tasks["c1"].task_count == 1
    assert len(rep.stalls) == 1
    st = rep.stalls[0]
    assert (st["task"], st["instance"], st["action"]) == ("c1", 0, "rescale")
    assert st["silent_s"] >= st["timeout_s"] == 0.25
    assert [r["trigger"] for r in rep.rescales] == ["stall"]
    assert len(rep.timeline.events("stall")) == 1
    assert "STALL c1[0]" in rep.summary()
    assert "RESCALE c1: nslots 2->1" in rep.summary()


def test_watchdog_hysteresis_spares_slow_tasks(tmp_path):
    w, rep, _ = _run_both(
        tmp_path, "slow", n1=1, extra_c1="stall_timeout_s: 0.6",
        faults=FaultSpec(task="c1", kind="slow_io", point="recv", step=None,
                         times=None, attempt=None, seconds=0.12))
    assert w.graph.tasks["c1"].task_count == 2
    assert rep.stalls == [] and rep.rescales == []


# ---------------------------------------------------------------------------
# nprocs-only rescale: logical rank count moves, topology does not
# ---------------------------------------------------------------------------
def test_nprocs_only_rescale(tmp_path):
    yaml = _rescale_yaml(n1=1).replace(
        "rescale: {nslots: 1, max_retries: 3}",
        "rescale: {nprocs: 2, max_retries: 3}", 1)
    w, rep, _ = _run_both(
        tmp_path, "nprocs", yaml=yaml,
        faults=FaultSpec(task="c1", point="recv", step=1, instance=0))
    assert w.graph.tasks["c1"].task_count == 2
    assert w.graph.tasks["c1"].nprocs == 2
    ev = rep.rescales[0]
    assert (ev["old_nslots"], ev["new_nslots"]) == (2, 2)
    assert (ev["old_nprocs"], ev["new_nprocs"]) == (1, 2)
    assert "nprocs 1->2" in rep.summary()
    for ch in rep.channels:
        if ch.consumer[0] == "c1" and ch.redistribute is not None:
            assert ch.redistribute.nranks == 2


def test_rescale_events_survive_json_roundtrip(tmp_path):
    _, rep, _ = _run_both(
        tmp_path, "roundtrip", n1=1, extra_c1="stall_timeout_s: 0.25",
        racy=True, faults=[
            FaultSpec(task="c1", kind="stall", point="recv", step=1,
                      instance=0, seconds=1.5),
            FaultSpec(task="c2", point="recv", step=3, instance=0),
        ])
    text = rep.timeline.to_json()
    json.loads(text)
    tl2 = TelemetryTimeline.from_json(text)
    assert tl2.events("rescale") == rep.timeline.events("rescale")
    assert tl2.events("stall") == rep.timeline.events("stall")
    assert {e["trigger"] for e in tl2.events("rescale")} == {"stall", "policy"}
    s = rep.summary()
    assert "RESCALE c1: nslots 2->1" in s and "RESCALE c2: nslots 2->1" in s
    assert "STALL c1[0]" in s


# ---------------------------------------------------------------------------
# the surgery's pieces
# ---------------------------------------------------------------------------
def test_reconstruct_global_stitches_tensors_where_they_live():
    """A replayed step's global array is stitched with torch on the slabs'
    device, so the resized consumer gets a tensor as a live serve gives it;
    host slabs stitch with numpy, as in the JAX package."""
    g = np.arange(30.0).reshape(10, 3)
    for as_tensor in (True, False):
        sibs = []
        for starts, shape in even_blocks((10, 3), 3):
            f = File("x.h5")
            f.attrs["step"] = 2
            part = g[starts[0]:starts[0] + shape[0]]
            data = convert.tensor_from_numpy(part, CPU) if as_tensor else part
            ds = f.create_dataset("/g", data=data, copy=not as_tensor)
            ds.attrs["redist_global_shape"] = [10, 3]
            ds.attrs["redist_box_starts"] = list(starts)
            ds.attrs["units"] = "cm"
            sibs.append(f)
        out = trescale._reconstruct_global(sibs)
        buf = out["/g"].read_direct()
        assert isinstance(buf, torch.Tensor) == as_tensor
        host = convert.numpy_from_tensor(buf) if as_tensor else buf
        assert host.tobytes() == g.tobytes()
        assert dict(out["/g"].attrs) == {"units": "cm"}
        assert out.attrs["step"] == 2


@pytest.mark.parametrize("groups, n, want", [
    ([["cuda:0"], ["cuda:0"]], 1, [["cuda:0"]]),
    ([["cuda:0"]], 3, [["cuda:0"]] * 3),
    ([["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]], 1,
     [["cuda:0", "cuda:1", "cuda:2", "cuda:3"]]),
    ([["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]], 3,
     [["cuda:0"], ["cuda:1"], ["cuda:2", "cuda:3"]]),
    ([["cuda:0"], ["cuda:1"]], 3, [["cuda:0"], ["cuda:1"], ["cuda:0"]]),
    ([None, None], 2, [None, None]),
])
def test_new_instances_regroup_the_old_devices(groups, n, want):
    dev = lambda g: None if g is None else [torch.device(d) for d in g]  # noqa: E731
    assert trescale._regroup_devices([dev(g) for g in groups], n) == \
        [dev(g) for g in want]


# ---------------------------------------------------------------------------
# parse-time validation of rescale / stall declarations
# ---------------------------------------------------------------------------
def _yaml_with_policy(policy, extra_task="", inport_extra=""):
    return f"""
tasks:
  - func: src
    {extra_task}
    outports:
      - filename: x.h5
        dsets: [{{name: /d, memory: 1}}]
  - func: sink
    inports:
      - filename: x.h5
        {inport_extra}
        dsets: [{{name: /d, memory: 1}}]
    on_failure:
      {policy}
"""


_PRODUCER_RESCALE = """
tasks:
  - func: src
    outports:
      - filename: x.h5
        dsets: [{name: /d, memory: 1}]
    on_failure:
      rescale: {nslots: 2}
  - func: sink
    inports:
      - filename: x.h5
        dsets: [{name: /d, memory: 1}]
"""
_FILE_MODE = """
tasks:
  - func: src
    outports:
      - filename: x.h5
        dsets: [{name: /d, file: 1, memory: 0}]
  - func: sink
    inports:
      - filename: x.h5
        dsets: [{name: /d, file: 1, memory: 0}]
    on_failure:
      rescale: {nslots: 2}
"""
_ISOLATED = """
tasks:
  - func: lonely
    on_failure:
      rescale: {nslots: 2}
"""


@pytest.mark.parametrize("yaml, match", [
    (_PRODUCER_RESCALE, "task 'src'.*pure consumer"),
    (_yaml_with_policy("rescale: {nslots: 3}", extra_task="taskCount: 2"),
     "task 'sink'.*'src' has taskCount=2"),
    (_FILE_MODE, "task 'sink'.*memory transport"),
    (_yaml_with_policy("rescale: {nslots: 2}", inport_extra="io_freq: -1"),
     "task 'sink'.*io_freq: -1"),
    (_ISOLATED, "task 'lonely'.*no inport edge"),
    (_yaml_with_policy("restart: {max_retries: 2}").replace(
        "on_failure:", "stall_timeout_s: 1.0\n    on_failure:"),
     "task 'sink'.*stall_timeout_s requires"),
    (_yaml_with_policy("rescale: {nslots: 1}").replace(
        "on_failure:", "stall_timeout_s: 0\n    on_failure:"),
     "task 'sink'.*stall_timeout_s must be > 0"),
], ids=["producer", "multi_instance_producer", "file_mode", "latest_mode",
        "isolated", "stall_without_policy", "nonpositive_stall"])
def test_graph_rejects_like_the_reference(yaml, match):
    for graph in (WorkflowGraph, jcore.WorkflowGraph):
        with pytest.raises(ValueError, match=match):
            graph.from_yaml(yaml)


def test_policy_rejects_bad_rescale_mappings():
    with pytest.raises(ValueError, match="task 't'"):
        FailurePolicy.from_yaml({"rescale": {"nslots": 0}}, "t")
    with pytest.raises(ValueError, match="cannot combine rescale"):
        FailurePolicy.from_yaml({"rescale": {"nslots": 2}, "drop": {}}, "t")
    with pytest.raises(ValueError, match="cannot combine restart"):
        FailurePolicy.from_yaml(
            {"rescale": {"nslots": 2}, "restart": {}}, "t")


def test_driver_validates_programmatic_rescale():
    w = PKGS[1].wilkins(_rescale_yaml(), PKGS[1].funcs({}))
    with pytest.raises(ValueError, match="unknown task"):
        w._validate_rescale_request("nope", nslots=1)
    with pytest.raises(ValueError, match="nothing to change"):
        w._validate_rescale_request("c1")
    with pytest.raises(ValueError, match="nslots must be >= 1"):
        w._validate_rescale_request("c1", nslots=0)
    with pytest.raises(ValueError, match="pure consumer"):
        w._validate_rescale_request("p1", nslots=2)
    w._validate_rescale_request("c1", nslots=3)
    w._validate_rescale_request("p1", nprocs=2)


# ---------------------------------------------------------------------------
# reshard_blocks on tensors, against the JAX package's on the same arrays
# ---------------------------------------------------------------------------
def _same_cut(blocks, n, axis=0):
    got = reshard_blocks([convert.tensor_from_numpy(b, CPU) for b in blocks],
                         n, axis=axis)
    want = jreshard_blocks(blocks, n, axis=axis)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    return got


def test_reshard_blocks_grow_ragged():
    g = np.arange(11.0)
    out = _same_cut([g[:4], g[4:8], g[8:]], 5)
    assert [o.shape[0] for o in out] == [3, 2, 2, 2, 2]
    assert np.concatenate(out).tobytes() == g.tobytes()


def test_reshard_blocks_empty_source_block():
    g = np.arange(11.0)
    out = _same_cut([g[:4], g[4:4], g[4:]], 2)
    assert np.concatenate(out).tobytes() == g.tobytes()


def test_reshard_blocks_more_ranks_than_elements():
    out = _same_cut([np.arange(3.0)], 5)
    assert [o.shape[0] for o in out] == [1, 1, 1, 0, 0]


def test_reshard_blocks_all_empty():
    out = _same_cut([np.zeros((0,), np.float32)] * 2, 3)
    assert [o.shape for o in out] == [(0,)] * 3
    assert all(o.dtype == np.float32 for o in out)


def test_reshard_blocks_preserves_dtype():
    out = _same_cut([np.arange(5, dtype=np.int32)], 2)
    assert all(o.dtype == np.int32 for o in out)


@pytest.mark.parametrize("m,n", [(1, 4), (2, 3), (3, 2), (4, 1), (3, 5)])
def test_reshard_blocks_matches_single_shard_baseline(m, n):
    rng = np.random.default_rng(m * 10 + n)
    g = rng.standard_normal((13, 7))
    cuts = [s for s, _ in even_blocks((13,), m)][1:]
    blocks = np.split(g, [c[0] for c in cuts], axis=0)
    via_m = _same_cut(blocks, n)
    via_1 = _same_cut([g], n)
    for a, b in zip(via_m, via_1):
        assert a.tobytes() == b.tobytes()


def test_reshard_blocks_axis1():
    a = np.arange(24.0).reshape(4, 6)
    out = _same_cut([a[:, :2], a[:, 2:]], 4, axis=1)
    assert [o.shape for o in out] == [(4, 2), (4, 2), (4, 1), (4, 1)]


def test_reshard_blocks_rejects_bad_inputs():
    t = torch.arange(3.0)
    with pytest.raises(ValueError, match="at least one source block"):
        reshard_blocks([], 2)
    with pytest.raises(ValueError, match="new_nranks must be >= 1"):
        reshard_blocks([t], 0)
    with pytest.raises(ValueError, match="axis 2 out of range"):
        reshard_blocks([t], 2, axis=2)
    with pytest.raises(ValueError, match="disagree off-axis"):
        reshard_blocks([torch.zeros((2, 3)), torch.zeros((2, 4))], 2)


def test_sweep_is_the_references():
    from test_rescale import FAST_SWEEP as JFAST
    from test_rescale import SWEEP as JSWEEP

    assert SWEEP == JSWEEP and FAST_SWEEP == JFAST and len(SWEEP) == 72
