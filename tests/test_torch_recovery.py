"""The port's supervised restart against the JAX package's (mirrors
``tests/test_recovery.py``; its unmarked cases each appear here, the
checkpointer's parked write error in ``test_torch_checkpoint.py``).

The workflow cases run the same YAML and fault plan through both packages
on the CPU: the producers write the same seeded numpy fields (the port's as
tensors, ``copy=False``), the port's consumers accumulate and checkpoint
tensors.  Both packages' outputs must be byte-identical to each other and to
the crash-free sum, and their restart events equal.  The channel-level and
parsing cases run on the port, with tensor payloads where a payload moves.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (Channel, ChannelError, FailurePolicy,  # noqa: E402
                              FaultPlan, FaultSpec, InjectedFault,
                              PrefetchPool, RecoveryContext, TelemetryTimeline,
                              Wilkins, h5, reshard_blocks, world)
from repro_torch.core.datamodel import File  # noqa: E402

CPU = torch.device("cpu")
SEED = 7
STEPS = 4
N = 32


def _a(t):
    return np.random.default_rng(SEED + t).standard_normal(N)


def _b(t):
    return np.random.default_rng(SEED + 100 + t).standard_normal(N)


def _expected(weights):
    """The crash-free accumulators, summed in the consumers' order."""
    acc = np.zeros(N)
    for t in range(STEPS):
        for gen, w in zip((_a, _b), weights):
            acc = acc + w * gen(t)
    return acc


EXPECTED_C1 = _expected((1.0,))
EXPECTED_C2 = _expected((1.0, 3.0))


# 2 producers x 2 consumers, all under managed restart: p1 -> a.h5 fans out
# to BOTH consumers; p2 -> b.h5 feeds only c2 (so c2 exercises fan-in).
RECOVERY_YAML = """
tasks:
  - func: p1
    on_failure:
      restart: {max_retries: 3}
    outports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: p2
    on_failure:
      restart: {max_retries: 3}
    outports:
      - filename: b.h5
        dsets:
          - {name: /h, memory: 1}
  - func: c1
    on_failure:
      restart: {max_retries: 3}
    inports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: c2
    on_failure:
      restart: {max_retries: 3}
    inports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
      - filename: b.h5
        dsets:
          - {name: /h, memory: 1}
"""


class Pkg:
    """The task bodies of one package: numpy in the JAX package, tensors in
    the port."""

    def __init__(self, port):
        self.port = port
        self.core = tcore if port else jcore

    def wilkins(self, yaml, funcs, **kw):
        if self.port:
            kw["devices"] = [CPU]
        return self.core.Wilkins(yaml, funcs, **kw)

    def array(self, a, device=CPU):
        return convert.tensor_from_numpy(a, device) if self.port else a

    def host(self, x):
        return convert.numpy_from_tensor(x).copy() if self.port \
            else np.asarray(x).copy()

    def producer(self, filename, dset, gen):
        """Checkpoint-every-step producer: a restart resumes at the next step."""
        def produce(comm):
            start = 0
            r = comm.restore({"step": self.array(np.zeros((), np.int64))})
            if r is not None:
                start = int(r[1]["step"])
            for t in range(start, STEPS):
                with self.core.h5.File(filename, "w") as f:
                    if self.port:
                        f.create_dataset(dset, data=self.array(gen(t)),
                                         copy=False)
                    else:
                        f.create_dataset(dset, data=gen(t))
                comm.checkpoint({"step": self.array(np.array(t + 1, np.int64))})
        return produce

    def consumer(self, results, key, primary, extras=()):
        """Stateful accumulator with per-step checkpoints; records the final
        accumulator, the step count and the producer epochs it saw."""
        def consume(comm):
            like = {"acc": self.array(np.zeros(N, np.float64)),
                    "n": self.array(np.zeros((), np.int64))}
            state = like
            r = comm.restore(like)
            if r is not None:
                state = r[1]
            epochs = []
            while True:
                f0 = self.core.h5.File(primary[0], "r")
                if f0 is None:
                    break
                epochs.append(int(f0.attrs.get("wilkins_epoch", -1)))
                acc = state["acc"] + primary[2] * f0[primary[1]][...]
                for fname, dset, w in extras:
                    fx = self.core.h5.File(fname, "r")
                    if fx is not None:
                        acc = acc + w * fx[dset][...]
                state = {"acc": acc, "n": state["n"] + 1}
                comm.checkpoint(state)
            results[key] = (self.host(state["acc"]), int(state["n"]), epochs)
        return consume

    def funcs(self, results):
        return {
            "p1": self.producer("a.h5", "/g", _a),
            "p2": self.producer("b.h5", "/h", _b),
            "c1": self.consumer(results, "c1", ("a.h5", "/g", 1.0)),
            "c2": self.consumer(results, "c2", ("a.h5", "/g", 1.0),
                                extras=(("b.h5", "/h", 3.0),)),
        }


PKGS = (Pkg(port=False), Pkg(port=True))


def _specs(faults):
    if isinstance(faults, FaultSpec):
        faults = [faults]
    return [dataclasses.asdict(f) for f in faults or ()] or None


def _run_both(tmp_path, tag, faults=None, yaml=RECOVERY_YAML, funcs=None):
    """Run in both packages; return {port: (report, results)}."""
    out = {}
    for pkg in PKGS:
        results = {}
        fs = funcs(pkg, results) if funcs else pkg.funcs(results)
        w = pkg.wilkins(yaml, fs, spill_dir=str(tmp_path / f"{tag}_{pkg.port}"))
        out[pkg.port] = (w.run(timeout=60, faults=_specs(faults)), results)
    return out


def _restarts(rep):
    return [{k: e[k] for k in ("task", "instance", "attempt", "epoch")}
            for e in rep.restarts]


def _assert_byte_identical(out, keys=("c1", "c2")):
    """Both packages' outputs equal the crash-free sum byte for byte, and
    their restart events agree; returns the port's report and results."""
    want = {"c1": EXPECTED_C1, "c2": EXPECTED_C2, "cmain": EXPECTED_C1}
    for key in keys:
        for port in (False, True):
            acc, n, _ = out[port][1][key]
            assert n == STEPS
            assert acc.tobytes() == want[key].tobytes(), (key, port)
    assert sorted(_restarts(out[True][0]), key=str) == \
        sorted(_restarts(out[False][0]), key=str)
    return out[True]


# ---------------------------------------------------------------------------
# crash -> restart -> byte-identical output
# ---------------------------------------------------------------------------
def test_crash_free_run_matches_reference(tmp_path):
    rep, results = _assert_byte_identical(_run_both(tmp_path, "ref"))
    assert rep.restarts == [] and rep.dropped_tasks == []
    assert rep.scheduler["recovery"]["restarts"] == []
    assert set(results["c1"][2]) == {0}


def test_consumer_crash_recovers_byte_identical(tmp_path):
    rep, _ = _assert_byte_identical(_run_both(
        tmp_path, "ccrash", FaultSpec(task="c1", point="recv", step=1)))
    assert len(rep.restarts) == 1
    ev = rep.restarts[0]
    assert ev["task"] == "c1" and ev["attempt"] == 0 and ev["epoch"] == 1
    assert "InjectedFault" in ev["reason"]
    assert sum(c.stats.replayed for c in rep.channels) >= 1
    tl_events = rep.timeline.events("restart")
    assert len(tl_events) == 1 and tl_events[0]["task"] == "c1"
    assert "RESTART c1[0]" in rep.summary()
    assert "recovery:" in rep.summary()
    rec = rep.scheduler["recovery"]
    assert len(rec["restarts"]) == 1
    assert rec["states"]["c1[0]"] == "DONE"
    assert rec["faults_fired"] == 1
    assert rep.scheduler["restarts"] == 1


def test_producer_crash_recovers_byte_identical(tmp_path):
    rep, results = _assert_byte_identical(_run_both(
        tmp_path, "pcrash", FaultSpec(task="p1", point="close", step=1)))
    assert [r["task"] for r in rep.restarts] == ["p1"]
    assert 1 in results["c1"][2]


def test_multi_fault_run_recovers(tmp_path):
    rep, _ = _assert_byte_identical(_run_both(tmp_path, "multi", [
        FaultSpec(task="p2", point="close", step=2),
        FaultSpec(task="c2", point="recv", step=3),
    ]))
    assert sorted(r["task"] for r in rep.restarts) == ["c2", "p2"]


def test_stall_fault_does_not_restart(tmp_path):
    rep, _ = _assert_byte_identical(_run_both(tmp_path, "stall", [
        FaultSpec(task="p1", kind="stall", point="close", step=1,
                  seconds=0.05),
        FaultSpec(task="c1", kind="slow_io", point="recv", step=0,
                  seconds=0.05),
    ]))
    assert rep.restarts == []
    assert rep.scheduler["recovery"]["faults_fired"] == 2


#: the reference's representative subset of its crash-point sweep
FAST_SWEEP = [
    ("p1", "close", 0), ("p2", "close", STEPS - 1),
    ("c1", "open", 2), ("c1", "recv", STEPS - 1),
    ("c2", "recv", 3), ("c2", "open", 5),
]


def _sweep_cases():
    """The reference's exhaustive sweep (tests/test_recovery.py
    ``_sweep_cases``): every task at start, each producer at every close,
    each consumer at every open and recv -- c2 opens two files a loop, so
    its steps run to 2 * STEPS - 1."""
    cases = [(t, "start", 0) for t in ("p1", "p2", "c1", "c2")]
    cases += [(t, "close", s) for t in ("p1", "p2") for s in range(STEPS)]
    for pt in ("open", "recv"):
        cases += [("c1", pt, s) for s in range(STEPS)]
        cases += [("c2", pt, s) for s in range(2 * STEPS)]
    return cases


SWEEP = _sweep_cases()


def _run_sweep_case(tmp_path, task, point, step):
    out = _run_both(tmp_path, f"{task}_{point}_{step}",
                    FaultSpec(task=task, point=point, step=step))
    for port in (False, True):
        rep = out[port][0]
        assert rep.scheduler["recovery"]["faults_fired"] == 1, \
            f"fault {task}/{point}/{step} never fired"
        assert [r["task"] for r in rep.restarts] == [task]
    _assert_byte_identical(out)


@pytest.mark.parametrize("task,point,step", FAST_SWEEP)
def test_fault_sweep_representative(tmp_path, task, point, step):
    _run_sweep_case(tmp_path, task, point, step)


@pytest.mark.slow
@pytest.mark.parametrize("task,point,step", SWEEP)
def test_fault_sweep_exhaustive(tmp_path, task, point, step):
    """Crash every task at every step boundary; output is always identical,
    in both packages."""
    _run_sweep_case(tmp_path, task, point, step)


def test_mid_prefetch_crash_recovers_via_prep_retry(tmp_path):
    yaml_text = """
tasks:
  - func: p1
    outports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: c1
    inports:
      - filename: a.h5
        prefetch: 2
        queue_depth: 2
        dsets:
          - {name: /g, memory: 1}
"""

    def funcs(pkg, results):
        return {"p1": pkg.producer("a.h5", "/g", _a),
                "c1": pkg.consumer(results, "c1", ("a.h5", "/g", 1.0))}

    out = _run_both(tmp_path, "prep",
                    FaultSpec(task="p1", point="prefetch", step=1),
                    yaml=yaml_text, funcs=funcs)
    rep, _ = _assert_byte_identical(out, keys=("c1",))
    assert sum(c.stats.prep_retries for c in rep.channels) == 1
    assert rep.restarts == []
    assert rep.prefetch_errors == []
    assert "prep_retries=1" in rep.summary()


# ---------------------------------------------------------------------------
# poison pill: a consumer blocked on a dead producer
# ---------------------------------------------------------------------------
def _channel(tmp_path, **kw):
    kw.setdefault("mode", "memory")
    return Channel("p[0]->c[0]:x.h5", ("p", 0), ("c", 0), "x.h5", ["*"],
                   spill_dir=str(tmp_path), **kw)


def _file(step=0):
    f = File("x.h5")
    f.create_dataset("/g", data=convert.tensor_from_numpy(_a(step), CPU),
                     copy=False)
    return f


def _got(f):
    return convert.numpy_from_tensor(f["/g"][...])


def test_poison_wakes_blocked_get_immediately(tmp_path):
    ch = _channel(tmp_path)
    out = {}

    def blocked_consumer():
        t0 = time.monotonic()
        try:
            ch.get(timeout=30.0)
        except BaseException as e:
            out["err"] = e
        out["elapsed"] = time.monotonic() - t0

    th = threading.Thread(target=blocked_consumer)
    th.start()
    time.sleep(0.2)
    cause = RuntimeError("simulation diverged")
    ch.poison("sim", 3, cause)
    th.join(timeout=10)
    assert not th.is_alive()
    err = out["err"]
    assert isinstance(err, ChannelError)
    assert err.task == "sim" and err.instance == 3
    assert "sim" in str(err) and "simulation diverged" in str(err)
    assert err.__cause__ is cause
    assert out["elapsed"] < 10.0


def test_poison_delivers_queued_data_first(tmp_path):
    ch = _channel(tmp_path, queue_depth=2)
    assert ch.offer(_file(0))
    ch.poison("sim", 0, RuntimeError("late failure"))
    f = ch.get(timeout=5)
    np.testing.assert_array_equal(_got(f), _a(0))
    with pytest.raises(ChannelError):
        ch.get(timeout=5)
    with pytest.raises(ChannelError):
        ch.try_get()
    assert ch.is_done()


def test_workflow_poison_names_dead_producer(tmp_path):
    yaml_text = """
tasks:
  - func: bad
    outports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: victim
    inports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
"""
    seen = []

    def bad():
        with h5.File("a.h5", "w") as f:
            f.create_dataset("/g", data=convert.tensor_from_numpy(
                np.arange(N, dtype=np.float64), CPU), copy=False)
        raise ValueError("disk on fire")

    def victim():
        while True:
            f = h5.File("a.h5", "r")
            if f is None:
                break
            seen.append(int(f["/g"][0]))

    w = Wilkins(yaml_text, {"bad": bad, "victim": victim}, devices=[CPU],
                spill_dir=str(tmp_path / "poison"))
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:
        w.run(timeout=60)
    assert time.monotonic() - t0 < 30.0

    chain, e = [], ei.value
    while e is not None:
        chain.append(e)
        e = e.__context__
    assert any(isinstance(e, ValueError) and "disk on fire" in str(e)
               for e in chain)
    poisons = [e for e in chain if isinstance(e, ChannelError)]
    assert poisons and poisons[0].task == "bad"
    assert poisons[0].__cause__ is not None
    rep = ei.value.report
    assert {f.task for f in rep.failures} == {"bad", "victim"}
    assert seen == [0]


# ---------------------------------------------------------------------------
# prefetch-pool error audit
# ---------------------------------------------------------------------------
def test_prep_error_after_shutdown_is_drained():
    pool = PrefetchPool(max_workers=1)
    started, release = threading.Event(), threading.Event()

    def doomed_prep():
        started.set()
        release.wait(10)
        raise RuntimeError("prep exploded after teardown")

    fut = pool.submit(doomed_prep, edge="p[0]->c[0]:a.h5")
    assert started.wait(5)
    pool.shutdown(cancel_pending=True)
    release.set()
    errs = pool.drain_errors(timeout=10)
    assert len(errs) == 1
    edge, exc = errs[0]
    assert edge == "p[0]->c[0]:a.h5"
    assert isinstance(exc, RuntimeError) and "prep exploded" in str(exc)
    assert fut.exception() is not None
    assert pool.drain_errors(timeout=1) == []


def test_drain_skips_cancelled_and_observed_preps():
    pool = PrefetchPool(max_workers=1)
    gate = threading.Event()

    def blocker():
        gate.wait(10)
        raise RuntimeError("observed by the consumer")

    def never_runs():  # pragma: no cover - cancelled before starting
        raise AssertionError("queued prep must be cancelled at shutdown")

    f1 = pool.submit(blocker, edge="e1")
    time.sleep(0.1)
    f2 = pool.submit(never_runs, edge="e2")
    pool.shutdown(cancel_pending=True)
    gate.set()
    while not f1.done():
        time.sleep(0.01)
    f1._wilkins_observed = True
    assert f2.cancelled()
    assert pool.drain_errors(timeout=10) == []


# ---------------------------------------------------------------------------
# channel-level recovery protocol (dedup / replay / ack watermarks)
# ---------------------------------------------------------------------------
def test_offer_dedups_restarted_producer_serves(tmp_path):
    ch = _channel(tmp_path)
    assert ch.offer(_file(0))
    np.testing.assert_array_equal(_got(ch.get(timeout=5)), _a(0))
    ch.quarantine_producer(epoch=1)
    assert ch.epoch == 1
    assert ch.offer(_file(0)) is True
    assert ch.stats.deduped == 1
    assert not ch.peek_pending()
    assert ch.offer(_file(1))
    np.testing.assert_array_equal(_got(ch.get(timeout=5)), _a(1))


def test_quarantine_consumer_replays_unacked_deliveries(tmp_path):
    ch = _channel(tmp_path)
    ch.set_replay(True)
    assert ch.offer(_file(0))
    np.testing.assert_array_equal(_got(ch.get(timeout=5)), _a(0))
    ch.quarantine_consumer(epoch=1)
    assert ch.stats.replayed == 1
    replayed = ch.get(timeout=5)
    assert isinstance(replayed["/g"].read_direct(), torch.Tensor)
    np.testing.assert_array_equal(_got(replayed), _a(0))
    ch.ack_consumer()
    ch.quarantine_consumer(epoch=2)
    assert ch.stats.replayed == 1
    assert not ch.peek_pending()


def test_quarantine_producer_keeps_acked_queued_payloads(tmp_path):
    ch = _channel(tmp_path, queue_depth=4)
    assert ch.offer(_file(0))
    ch.ack_producer()
    assert ch.offer(_file(1))
    ch.quarantine_producer(epoch=1)
    np.testing.assert_array_equal(_got(ch.get(timeout=5)), _a(0))
    assert not ch.peek_pending()
    assert ch.stats.dropped == 1
    assert ch.offer(_file(1))
    np.testing.assert_array_equal(_got(ch.get(timeout=5)), _a(1))


def test_abandon_consumer_turns_offers_into_drops(tmp_path):
    ch = _channel(tmp_path)
    assert ch.offer(_file(0))
    ch.abandon_consumer()
    assert ch.offer(_file(1)) is False
    assert ch.stats.dropped >= 2
    assert not ch.peek_pending()


# ---------------------------------------------------------------------------
# policies: drop, exhaustion, legacy compatibility
# ---------------------------------------------------------------------------
DROP_YAML = """
tasks:
  - func: p1
    outports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: cmain
    inports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: copt
    on_failure: drop
    inports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
"""


def test_drop_policy_degrades_optional_task_to_noop(tmp_path):
    def funcs(pkg, results):
        return {"p1": pkg.producer("a.h5", "/g", _a),
                "cmain": pkg.consumer(results, "cmain", ("a.h5", "/g", 1.0)),
                "copt": pkg.consumer(results, "copt", ("a.h5", "/g", 1.0))}

    out = _run_both(tmp_path, "drop", FaultSpec(task="copt", point="open",
                                                step=1),
                    yaml=DROP_YAML, funcs=funcs)
    rep, results = _assert_byte_identical(out, keys=("cmain",))
    for port in (False, True):
        assert "copt" not in out[port][1]
        assert out[port][0].dropped_tasks == [("copt", 0)]
    assert rep.restarts == []
    assert len(rep.failures) == 1 and rep.failures[0].task == "copt"
    assert "DROPPED copt[0]" in rep.summary()
    assert rep.timeline.events("drop")[0]["task"] == "copt"
    assert rep.scheduler["recovery"]["states"]["copt[0]"] == "DROPPED"


def test_max_retries_exhaustion_chains_all_errors(tmp_path):
    yaml_text = """
tasks:
  - func: p1
    outports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: c1
    on_failure:
      restart: {max_retries: 1}
    inports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
"""
    pkg = PKGS[1]
    results = {}
    funcs = {"p1": pkg.producer("a.h5", "/g", _a),
             "c1": pkg.consumer(results, "c1", ("a.h5", "/g", 1.0))}
    w = pkg.wilkins(yaml_text, funcs, spill_dir=str(tmp_path / "exh"))
    with pytest.raises(InjectedFault) as ei:
        w.run(timeout=60, faults=FaultSpec(task="c1", point="open", step=0,
                                           attempt=None, times=None))
    rep = ei.value.report
    assert [(f.task, f.attempt) for f in rep.failures] == \
        [("c1", 0), ("c1", 1)]
    assert len(rep.restarts) == 1
    assert rep.scheduler["recovery"]["states"]["c1[0]"] == "FAILED"
    assert ("p1", 0) in rep.task_times


def test_legacy_max_restarts_stays_unmanaged(tmp_path):
    yaml_text = """
tasks:
  - func: flaky
    outports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
  - func: c1
    inports:
      - filename: a.h5
        dsets:
          - {name: /g, memory: 1}
"""
    attempts = {"n": 0}
    got = []

    def flaky():
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("transient")
        for t in range(2):
            with h5.File("a.h5", "w") as f:
                f.create_dataset("/g", copy=False, data=convert.tensor_from_numpy(
                    np.arange(N, dtype=np.float64) + 100.0 * t, CPU))

    def c1():
        while True:
            f = h5.File("a.h5", "r")
            if f is None:
                break
            got.append(int(f["/g"][0]))

    w = Wilkins(yaml_text, {"flaky": flaky, "c1": c1}, max_restarts=2,
                devices=[CPU], spill_dir=str(tmp_path / "legacy"))
    rep = w.run(timeout=60)
    assert attempts["n"] == 2
    assert got == [0, 100]
    assert rep.restarts == []
    assert len(rep.failures) == 1
    assert rep.scheduler["recovery"]["restarts"] == []


# ---------------------------------------------------------------------------
# policy / fault-spec parsing
# ---------------------------------------------------------------------------
def test_failure_policy_parses_all_spellings():
    assert FailurePolicy.from_yaml(None).kind == "fail"
    assert FailurePolicy.from_yaml("fail").kind == "fail"
    assert FailurePolicy.from_yaml("drop").kind == "drop"
    p = FailurePolicy.from_yaml("restart")
    assert p.kind == "restart" and p.max_retries == 1 and p.managed
    p = FailurePolicy.from_yaml(
        {"restart": {"max_retries": 5, "backoff_s": 0.25, "jitter": 0.1}},
        task="sim")
    assert (p.kind, p.max_retries, p.backoff_s, p.jitter) == \
        ("restart", 5, 0.25, 0.1)


@pytest.mark.parametrize("doc", [
    "explode",
    {"retry": {"max_retries": 2}},
    {"restart": "yes"},
    {"restart": {"max_retries": 0}},
    {"restart": {"backoff_s": -1}},
    {"restart": {"jitter": -0.5}},
    {"restart": {"bogus": 1}},
    17,
])
def test_failure_policy_rejects_bad_yaml_naming_the_task(doc):
    with pytest.raises(ValueError, match="task 'sim'"):
        FailurePolicy.from_yaml(doc, task="sim")


def test_backoff_is_deterministic_and_exponential():
    p = FailurePolicy(kind="restart", max_retries=3, backoff_s=0.1,
                      jitter=0.05)
    assert p.backoff("t", 0, 1) == p.backoff("t", 0, 1)
    assert p.backoff("t", 0, 2) > p.backoff("t", 0, 1) > p.backoff("t", 0, 0)
    assert FailurePolicy().backoff("t", 0, 5) == 0.0
    assert p.backoff("t", 0, 2) == jcore.FailurePolicy(
        kind="restart", max_retries=3, backoff_s=0.1,
        jitter=0.05).backoff("t", 0, 2)


def test_fault_spec_validation_and_coercion():
    with pytest.raises(ValueError, match="kind"):
        FaultSpec(task="t", kind="explode")
    with pytest.raises(ValueError, match="point"):
        FaultSpec(task="t", point="nowhere")
    with pytest.raises(ValueError, match="times"):
        FaultSpec(task="t", times=0)
    with pytest.raises(ValueError, match="seconds"):
        FaultSpec(task="t", seconds=-1.0)
    assert FaultPlan.coerce(None) is None
    plan = FaultPlan.coerce(FaultSpec(task="t"))
    assert isinstance(plan, FaultPlan) and len(plan.specs) == 1
    assert FaultPlan.coerce(plan) is plan
    plan2 = FaultPlan.coerce([{"task": "t", "point": "open", "step": 2}])
    assert plan2.specs[0].step == 2
    with pytest.raises(ValueError, match="task 'x'"):
        Wilkins("tasks:\n  - func: x\n    on_failure: explode\n",
                {"x": lambda: None}, devices=[CPU])


def test_fault_plan_times_budget():
    plan = FaultPlan([FaultSpec(task="t", point="open", step=None,
                                attempt=None, times=2)])
    for _ in range(2):
        with pytest.raises(InjectedFault):
            plan.fire("t", 0, "open", 0, 0)
    plan.fire("t", 0, "open", 0, 0)
    assert plan.fired() == 2
    assert len(plan.log) == 2


# ---------------------------------------------------------------------------
# checkpoint surface: TaskComm, RecoveryContext, reshard replay
# ---------------------------------------------------------------------------
def test_checkpoint_restore_are_noops_standalone():
    comm = world()
    assert comm.recovery is None
    assert comm.checkpoint({"x": torch.arange(3)}) is None
    assert comm.restore({"x": torch.zeros(3)}) is None
    assert comm.attempt == 0 and comm.epoch == 0


def test_recovery_context_checkpoint_acks_and_restores(tmp_path):
    class FakeCh:
        def __init__(self):
            self.producer_acks = 0
            self.consumer_acks = 0

        def ack_producer(self):
            self.producer_acks += 1

        def ack_consumer(self):
            self.consumer_acks += 1

    cin, cout = FakeCh(), FakeCh()
    rc = RecoveryContext("sim", 0, str(tmp_path / "ck"),
                         incoming=[cin], outgoing=[cout])
    assert rc.restore({"x": torch.zeros(4)}) is None
    assert rc.checkpoint({"x": torch.arange(4.0)}) == 0
    assert rc.checkpoint({"x": torch.arange(4.0) * 2}) == 1
    assert cout.producer_acks == 2 and cin.consumer_acks == 2

    rc2 = RecoveryContext("sim", 0, str(tmp_path / "ck"))
    step, state = rc2.restore({"x": torch.zeros(4, dtype=torch.float64)})
    assert step == 1
    assert state["x"].dtype == torch.float64
    assert torch.equal(state["x"], torch.arange(4.0, dtype=torch.float64) * 2)
    assert rc2.checkpoint({"x": torch.zeros(4)}) == 2


def test_reshard_blocks_m_to_n():
    g = np.arange(36, dtype=np.float64).reshape(12, 3)
    t = lambda a: convert.tensor_from_numpy(a, CPU)  # noqa: E731
    blocks3 = [t(b) for b in np.array_split(g, 3, axis=0)]
    out2 = reshard_blocks(blocks3, 2)
    assert len(out2) == 2
    np.testing.assert_array_equal(np.concatenate(out2, axis=0), g)
    out5 = reshard_blocks([t(b) for b in out2], 5)
    np.testing.assert_array_equal(np.concatenate(out5, axis=0), g)
    outc = reshard_blocks([t(b) for b in np.array_split(g, 3, axis=1)], 2,
                          axis=1)
    np.testing.assert_array_equal(np.concatenate(outc, axis=1), g)
    with pytest.raises(ValueError, match="at least one"):
        reshard_blocks([], 2)
    with pytest.raises(ValueError, match="new_nranks"):
        reshard_blocks(blocks3, 0)
    with pytest.raises(ValueError, match="axis"):
        reshard_blocks(blocks3, 2, axis=7)


def test_timeline_events_survive_json_roundtrip():
    tl = TelemetryTimeline(capacity=0)
    tl.record_event("restart", task="sim", instance=0, attempt=0, epoch=1,
                    reason="InjectedFault: boom")
    tl.record_event("drop", task="viz", instance=1)
    assert len(tl.events()) == 2
    assert tl.events("restart")[0]["epoch"] == 1
    tl2 = TelemetryTimeline.from_json(tl.to_json())
    assert tl2.events("restart") == tl.events("restart")
    assert [e["kind"] for e in tl2.events()] == ["restart", "drop"]


def test_sweep_is_the_references():
    from test_recovery import FAST_SWEEP as JFAST
    from test_recovery import SWEEP as JSWEEP

    assert SWEEP == JSWEEP and FAST_SWEEP == JFAST and len(SWEEP) == 36
