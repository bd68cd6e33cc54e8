"""The port's runtime-scheduling subsystem beside the JAX package's: the
twin of ``tests/test_scheduler.py`` (weighted-fair prefetch arbitration,
depth autotuning, the telemetry timeline, and the prefetch lifecycle
satellites).

The queue policies, the pool, the semaphore, the autotuner and the
timeline are copies of the reference's (``core/scheduler.py`` imports no
JAX), so their cases run on the port alone, on channels that carry tensor
snapshots.  Every workflow case runs through both packages on the same
inputs (tensors on the port's side) and holds the deliveries, served and
moved totals, transport counters and the scheduler's policy equal
(``torch_twins``); the autotuner's decisions follow thread timing, so
they are held to their bounds in each package, not across packages.  Each reference case has a twin
of the same name.  By design:

* ``test_autotuner_raises_depth_on_blocked_edge_in_real_workflow`` (slow)
  depends on thread timing: both packages must grow the depth within its
  bound and deliver the same bytes; the decisions are not compared.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import Wilkins, WorkflowGraph  # noqa: E402
from repro_torch.core.channel import Channel, PrefetchPool  # noqa: E402
from repro_torch.core.datamodel import (File, reset_transport_stats,  # noqa: E402
                                        transport_stats)
from repro_torch.core.redistribute import RedistSpec  # noqa: E402
from repro_torch.core.scheduler import (DepthAutotuner, FairPolicy,  # noqa: E402
                                        FifoPolicy, ResizableSemaphore,
                                        SchedulerConfig, SchedulerRuntime,
                                        TelemetryTimeline)
from torch_twins import CPU, assert_same, run_both  # noqa: E402


def _mk_channel(name="e", prefetch=1, autotune=None, weight=1, io_freq=1,
                queue_depth=4, slot=0):
    return Channel(name, ("p", 0), ("c", slot), "o.h5", ["/g"],
                   io_freq=io_freq, queue_depth=queue_depth,
                   redistribute=RedistSpec(axis=0, nslots=2, slot=slot,
                                           nranks=1),
                   prefetch=prefetch, weight=weight, autotune=autotune)


def _file(n=16):
    f = File("o.h5")
    f.create_dataset("/g", data=convert.tensor_from_numpy(
        np.arange(float(n)), CPU))
    return f


# ---------------------------------------------------------------------------
# queue policies
# ---------------------------------------------------------------------------
def test_fifo_policy_preserves_submission_order():
    pol = FifoPolicy()
    for i in range(10):
        pol.push(i, edge=f"e{i % 3}", weight=i + 1)
    assert [pol.pop() for _ in range(10)] == list(range(10))
    assert pol.pop() is None and pol.pending() == 0


def test_fair_policy_weighted_shares():
    """Weights 3:1 -> the heavy edge gets ~3x the pops while both edges
    stay backlogged; the acceptance bar is >= 2:1 over the first window."""
    pol = FairPolicy()
    for i in range(30):
        pol.push(("hot", i), edge="hot", weight=3)
        pol.push(("cold", i), edge="cold", weight=1)
    first = [pol.pop()[0] for _ in range(20)]
    hot = first.count("hot")
    cold = first.count("cold")
    assert hot >= 2 * cold, (hot, cold)
    assert cold >= 1  # no starvation: the weight-1 edge still progresses
    # full drain serves everything exactly once
    rest = []
    while pol.pending():
        rest.append(pol.pop())
    assert len(first) + len(rest) == 60


def test_fair_policy_idle_edge_does_not_hoard_credit():
    pol = FairPolicy()
    pol.push("a1", edge="a", weight=5)
    assert pol.pop() == "a1"          # edge a drains; its deficit resets
    for i in range(4):
        pol.push(("b", i), edge="b", weight=1)
    pol.push("a2", edge="a", weight=5)
    got = [pol.pop() for _ in range(5)]
    assert set(got) == {("b", 0), ("b", 1), ("b", 2), ("b", 3), "a2"}


def test_fair_policy_drain_returns_everything():
    pol = FairPolicy()
    for i in range(7):
        pol.push(i, edge=f"e{i % 2}")
    pol.pop()
    drained = pol.drain()
    assert len(drained) == 6 and pol.pending() == 0
    assert pol.pop() is None


def test_pool_fifo_default_serves_in_order():
    """The default pool policy is FIFO: one worker, submission order ==
    completion order (bit-for-bit the pre-scheduler behaviour)."""
    pool = PrefetchPool(max_workers=1)
    order = []
    gate = threading.Event()
    first = pool.submit(lambda: gate.wait(5))
    futs = [pool.submit(lambda i=i: order.append(i)) for i in range(5)]
    gate.set()
    for f in futs:
        f.result(timeout=5)
    assert order == list(range(5))
    pool.shutdown()


def test_pool_fair_policy_respects_weights():
    pool = PrefetchPool(max_workers=1, policy=FairPolicy())
    order = []
    gate = threading.Event()
    pool.submit(lambda: gate.wait(5))  # park the worker so queues build
    futs = []
    for i in range(6):
        futs.append(pool.submit(lambda: order.append("hot"),
                                edge="hot", weight=3))
        futs.append(pool.submit(lambda: order.append("cold"),
                                edge="cold", weight=1))
    gate.set()
    for f in futs:
        f.result(timeout=5)
    window = order[:8]
    assert window.count("hot") >= 2 * window.count("cold"), window
    pool.shutdown()


# ---------------------------------------------------------------------------
# resizable semaphore
# ---------------------------------------------------------------------------
def test_resizable_semaphore_bounds_and_overrelease():
    sem = ResizableSemaphore(2)
    assert sem.acquire(timeout=1) and sem.acquire(timeout=1)
    assert not sem.acquire(timeout=0.05)   # at the limit
    sem.release()
    sem.release()
    with pytest.raises(ValueError, match="released too many times"):
        sem.release()


def test_resizable_semaphore_grow_wakes_waiter_and_shrink_drains():
    sem = ResizableSemaphore(1)
    assert sem.acquire(timeout=1)
    got = threading.Event()

    def waiter():
        if sem.acquire(timeout=5):
            got.set()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not got.is_set()
    sem.resize(2)                  # grow: the blocked waiter proceeds
    assert got.wait(5)
    sem.resize(1)                  # shrink below in-use: just drains
    assert sem.in_use == 2 and sem.limit == 1
    sem.release()
    sem.release()
    assert sem.in_use == 0


# ---------------------------------------------------------------------------
# satellite: shutdown slot-leak regression
# ---------------------------------------------------------------------------
def test_shutdown_mid_flight_releases_every_depth_slot():
    """Queued preps cancelled by PrefetchPool.shutdown() must release their
    edge's semaphore slot via the done-callback -- fully released, and no
    ValueError from an over-release either."""
    ch = _mk_channel(prefetch=3, queue_depth=8)
    pool = PrefetchPool(max_workers=1)
    ch.set_prefetch_pool(pool)
    gate = threading.Event()
    started = threading.Event()
    orig = ch._prepare

    def slow_prepare(*a, **kw):
        started.set()
        gate.wait(5)
        return orig(*a, **kw)

    ch._prepare = slow_prepare
    f = _file()
    assert ch.offer(f)
    assert started.wait(5)      # the first prep is RUNNING on the worker
    for _ in range(2):          # two more queue behind it; all 3 slots held
        assert ch.offer(f)
    assert ch._prefetch_sem.in_use == 3
    assert ch.stats.inflight_preps == 3
    pool.shutdown()             # cancels the 2 queued preps
    gate.set()                  # lets the running prep finish
    deadline = time.monotonic() + 5
    while ch._prefetch_sem.in_use and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ch._prefetch_sem.in_use == 0          # no slot leaked
    assert ch.stats.inflight_preps == 0
    assert ch.stats.prefetch_cancelled == 2      # the queued pair
    # over-release is still an error (the callback ran exactly once each)
    with pytest.raises(ValueError):
        ch._prefetch_sem.release()


# ---------------------------------------------------------------------------
# satellite: `latest` x prefetch stale-prep cancellation
# ---------------------------------------------------------------------------
def test_latest_edge_cancels_stale_inflight_prep():
    reset_transport_stats()
    ch = _mk_channel(prefetch=2, io_freq=-1, queue_depth=4)
    pool = PrefetchPool(max_workers=1)
    ch.set_prefetch_pool(pool)
    gate = threading.Event()
    orig = ch._prepare

    def slow_prepare(*a, **kw):
        gate.wait(5)
        return orig(*a, **kw)

    ch._prepare = slow_prepare
    f = _file()
    ch.set_consumer_waiting(True)   # `latest` serves only waiting consumers
    try:
        assert ch.offer(f)          # step 0: prep starts (worker blocked)
        assert ch.offer(f)          # step 1: supersedes step 0's queued prep
        with ch._lock:
            assert len(ch._queue) == 1          # stale future replaced
        assert ch.stats.dropped == 1
    finally:
        ch.set_consumer_waiting(False)
    gate.set()
    ch.finish()
    got = ch.get(timeout=5)         # the fresh step delivers fine
    assert got is not None
    deadline = time.monotonic() + 5
    while ch._prefetch_sem.in_use and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ch._prefetch_sem.in_use == 0
    # exactly one prep was dropped as stale, counted in transport stats
    assert transport_stats().snapshot()["prefetch_cancelled"] == 1
    assert ch.stats.prefetch_cancelled == 1
    pool.shutdown()


def test_latest_edge_keeps_finished_payloads():
    """A COMPLETED future is fresh data, not a stale prep: it must survive
    the supersede pass and deliver."""
    ch = _mk_channel(prefetch=2, io_freq=-1, queue_depth=4)
    pool = PrefetchPool(max_workers=2)
    ch.set_prefetch_pool(pool)
    f = _file()
    ch.set_consumer_waiting(True)
    try:
        assert ch.offer(f)
        with ch._lock:
            fut = ch._queue[0][1]
        fut.result(timeout=5)       # prep done before the next offer
        time.sleep(0.02)            # let the done-callback run
        assert ch.offer(f)
        with ch._lock:
            assert len(ch._queue) == 2      # nothing dropped
        assert ch.stats.dropped == 0
    finally:
        ch.set_consumer_waiting(False)
    pool.shutdown()


# ---------------------------------------------------------------------------
# depth autotuner
# ---------------------------------------------------------------------------
def test_autotuner_grows_blocked_edge_within_bounds():
    ch = _mk_channel(prefetch=1, autotune=(1, 3))
    tuner = DepthAutotuner()
    tuner.tick([ch])                       # baseline
    for i in range(5):                     # keep signalling "blocked"
        with ch._lock:
            ch.stats.prefetch_misses += 2
            ch.stats.prefetch_blocked_s += 0.1
            ch.stats.served += 2
        tuner.tick([ch])
    assert ch.prefetch == 3                # grew, then pinned at max
    assert ch._prefetch_sem.limit == 3
    grow = [d for d in tuner.decisions if "grow" in d.reason]
    assert len(grow) == 2 and grow[0].old == 1 and grow[-1].new == 3


def test_autotuner_shrinks_idle_edge_with_hysteresis():
    ch = _mk_channel(prefetch=3, autotune=(1, 4))
    tuner = DepthAutotuner()
    tuner.tick([ch])                       # baseline
    for _ in range(6):                     # all hits, nothing blocked
        with ch._lock:
            ch.stats.prefetch_hits += 2
            ch.stats.served += 2
        tuner.tick([ch])
    assert ch.prefetch < 3                 # narrowed...
    assert ch.prefetch >= 1                # ...but never below min
    # hysteresis: first shrink needed two idle ticks, not one
    shrinks = [d for d in tuner.decisions if "idle" in d.reason]
    assert shrinks and shrinks[0].old == 3


def test_autotuner_idle_hysteresis_requires_consecutive_ticks():
    """A hold tick between two idle ticks restarts the shrink count: idle,
    hold, idle must NOT shrink (the documented rule is 2 CONSECUTIVE)."""
    ch = _mk_channel(prefetch=3, autotune=(1, 4))
    tuner = DepthAutotuner()
    tuner.tick([ch])                       # baseline
    with ch._lock:                         # idle tick 1
        ch.stats.prefetch_hits += 1
        ch.stats.served += 1
    tuner.tick([ch])
    tuner.tick([ch])                       # hold tick (no activity at all)
    with ch._lock:                         # idle tick again -- count restarts
        ch.stats.prefetch_hits += 1
        ch.stats.served += 1
    tuner.tick([ch])
    assert ch.prefetch == 3 and not tuner.decisions


def test_autotuner_shrinks_on_cancelled_preps():
    ch = _mk_channel(prefetch=3, autotune=(1, 4))
    tuner = DepthAutotuner()
    tuner.tick([ch])
    with ch._lock:
        ch.stats.prefetch_cancelled += 1
        ch.stats.served += 1
    tuner.tick([ch])
    assert ch.prefetch == 2
    assert any("cancelled" in d.reason for d in tuner.decisions)


def test_autotuner_ignores_non_autotuned_channels():
    ch = _mk_channel(prefetch=2, autotune=None)
    tuner = DepthAutotuner()
    tuner.tick([ch])
    with ch._lock:
        ch.stats.prefetch_misses += 5
        ch.stats.prefetch_blocked_s += 1.0
    tuner.tick([ch])
    assert ch.prefetch == 2 and not tuner.decisions


def test_set_depth_requires_prefetch_machinery():
    ch = Channel("c", ("p", 0), ("c", 0), "o.h5", ["/g"])  # prefetch off
    with pytest.raises(ValueError, match="without prefetch"):
        ch.set_depth(2)
    ch2 = _mk_channel(prefetch=2)
    with pytest.raises(ValueError, match=">= 1"):
        ch2.set_depth(0)


# ---------------------------------------------------------------------------
# telemetry timeline
# ---------------------------------------------------------------------------
def test_timeline_samples_and_json_roundtrip(tmp_path):
    chans = [_mk_channel(name=f"e{i}", prefetch=1, slot=i % 2)
             for i in range(2)]
    tl = TelemetryTimeline(capacity=64)
    for _ in range(3):
        tl.sample(chans)
    assert tl.per_edge_counts() == {"e0": 3, "e1": 3}
    path = str(tmp_path / "timeline.json")
    tl.export(path)
    back = TelemetryTimeline.load(path)
    assert back.per_edge_counts() == tl.per_edge_counts()
    assert back.samples() == tl.samples()
    doc = json.loads(tl.to_json())
    assert doc["version"] == 1 and len(doc["samples"]) == 6


def test_timeline_ring_bounds_and_counts_drops():
    ch = _mk_channel(prefetch=1)
    tl = TelemetryTimeline(capacity=4)
    for _ in range(6):
        tl.sample([ch])
    assert len(tl) == 4 and tl.dropped == 2


def test_timeline_capacity_zero_disables_sampling():
    tl = TelemetryTimeline(capacity=0)
    assert tl.sample([_mk_channel()]) == 0 and len(tl) == 0


# ---------------------------------------------------------------------------
# YAML surface
# ---------------------------------------------------------------------------
def _yaml(scheduler="", inport_extra=""):
    return f"""
{scheduler}
tasks:
  - func: producer
    outports:
      - filename: o.h5
        dsets: [{{name: /g, memory: 1}}]
  - func: consumer
    inports:
      - filename: o.h5
        {inport_extra}
        dsets: [{{name: /g, memory: 1}}]
"""


def test_scheduler_block_parses_with_defaults():
    g = WorkflowGraph.from_yaml(_yaml())
    assert g.scheduler == SchedulerConfig()   # fifo, quantum 1, tick 4
    g2 = WorkflowGraph.from_yaml(
        _yaml(scheduler="scheduler: {policy: fair, quantum: 2, "
                        "tick_every: 3, telemetry: 16}"))
    assert g2.scheduler.policy == "fair" and g2.scheduler.quantum == 2
    assert g2.scheduler.tick_every == 3 and g2.scheduler.telemetry == 16


@pytest.mark.parametrize("block,msg", [
    ("scheduler: {policy: lifo}", "policy 'lifo' is invalid"),
    ("scheduler: {quantum: 0}", "quantum must be >= 1"),
    ("scheduler: {tick_every: 0}", "tick_every must be >= 1"),
    ("scheduler: {telemetry: -1}", "telemetry capacity must be >= 0"),
    ("scheduler: {bogus: 1}", "unknown keys"),
    ("scheduler: [fair]", "must be a mapping"),
])
def test_scheduler_block_rejects_bad_values(block, msg):
    with pytest.raises(ValueError, match=msg):
        WorkflowGraph.from_yaml(_yaml(scheduler=block))


def test_port_weight_and_autotune_parse_and_reach_channel():
    g = WorkflowGraph.from_yaml(
        _yaml(inport_extra="weight: 3\n        autotune: {min: 2, max: 5}"))
    inp = g.tasks["consumer"].inports[0]
    assert inp.weight == 3 and inp.autotune == (2, 5)
    w = Wilkins(g, {"producer": lambda: None, "consumer": lambda: None},
                devices=[CPU])
    (ch,) = w.channels
    assert ch.weight == 3 and ch.autotune == (2, 5)
    assert ch.prefetch == 2          # autotune implies prefetch: clamps to min
    assert ch.max_prefetch_depth == 5


def test_autotune_shorthand_spellings():
    g = WorkflowGraph.from_yaml(_yaml(inport_extra="autotune: 1"))
    assert g.tasks["consumer"].inports[0].autotune == (1, 8)
    g2 = WorkflowGraph.from_yaml(_yaml(inport_extra="autotune: 6"))
    assert g2.tasks["consumer"].inports[0].autotune == (1, 6)


@pytest.mark.parametrize("extra,msg", [
    ("weight: 0", "weight must be >= 1"),
    ("autotune: {min: 0, max: 4}", "autotune min must be >= 1"),
    ("autotune: {min: 3, max: 2}", "min <= max"),
    ("autotune: {max: 4, turbo: 1}", "unknown autotune keys"),
    ("autotune: {min: fast, max: 4}", "autotune min must be an integer"),
    ("autotune: {min: 1, max: 2.7}", "autotune max must be an integer"),
    ("autotune: 1\n        prefetch: 0", "autotune needs prefetch enabled"),
])
def test_port_knobs_reject_bad_values(extra, msg):
    with pytest.raises(ValueError, match=msg):
        WorkflowGraph.from_yaml(_yaml(inport_extra=extra))


def test_weight_and_autotune_rejected_on_outports():
    bad_weight = """
tasks:
  - func: producer
    outports:
      - filename: o.h5
        weight: 2
        dsets: [{name: /g, memory: 1}]
"""
    with pytest.raises(ValueError, match="weight is an inport declaration"):
        WorkflowGraph.from_yaml(bad_weight)
    with pytest.raises(ValueError, match="autotune is an inport declaration"):
        WorkflowGraph.from_yaml(bad_weight.replace("weight: 2", "autotune: 1"))


# ---------------------------------------------------------------------------
# runtime wiring (driver / vol / comm step hooks)
# ---------------------------------------------------------------------------
def _pipeline_yaml(steps_extra="", scheduler=""):
    return f"""
{scheduler}
tasks:
  - func: producer
    nprocs: 2
    outports:
      - filename: o.h5
        ownership: {{axis: 0}}
        dsets: [{{name: /g, memory: 1}}]
  - func: consumer
    nprocs: 2
    inports:
      - filename: o.h5
        redistribute: 1
        {steps_extra}
        dsets: [{{name: /g, memory: 1}}]
"""


def _pipeline(s, yaml, steps=6):
    def producer(comm):
        for t in range(steps):
            with s.h5.File("o.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/g", data=s.data(np.arange(64.0) + t))

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                return
            _ = f["/g"][0]
            s.record(("consumer", comm.instance, 0, int(f.attrs["step"])),
                     f["/g"])

    w = s.wilkins(yaml, {"producer": producer, "consumer": consumer})
    return w, w.run(timeout=60)


def _run_pipeline(yaml, steps=6):
    """The pipeline through both packages: equal deliveries and counters;
    returns the port's workflow and report."""
    t, j = run_both(_pipeline, yaml, steps)
    (w, rep), (_, jrep) = t.result, j.result
    t.result, j.result = rep, jrep
    assert len(t.side.got) == steps
    assert_same(t, j)
    assert rep.scheduler["policy"] == jrep.scheduler["policy"]
    assert (rep.scheduler["steps"] > 0) == (jrep.scheduler["steps"] > 0)
    return w, rep


def test_run_report_carries_scheduler_snapshot_and_timeline():
    w, rep = _run_pipeline(_pipeline_yaml(
        scheduler="scheduler: {policy: fair, tick_every: 2}"))
    assert rep.scheduler["policy"] == "fair"
    assert rep.scheduler["steps"] >= 12       # closes + opens both count
    assert rep.scheduler["ticks"] >= 1
    assert rep.timeline is not None and len(rep.timeline) >= 1
    s = rep.summary()
    assert "scheduler: policy=fair" in s and "telemetry_samples=" in s
    assert all(v.scheduler is None for v in w.vols.values())
    assert w._sched_runtime is None


def test_run_default_policy_is_fifo_and_still_reports():
    _, rep = _run_pipeline(_pipeline_yaml())
    assert rep.scheduler["policy"] == "fifo"
    assert rep.scheduler["decisions"] == []
    assert rep.timeline is not None
    assert len(rep.timeline) >= 1
    assert rep.scheduler["steps"] == 0


def test_autotuned_edge_wires_step_hooks_without_scheduler_block():
    _, rep = _run_pipeline(_pipeline_yaml(steps_extra="autotune: 1"))
    assert rep.scheduler["policy"] == "fifo"
    assert rep.scheduler["steps"] > 0


def test_comm_step_feeds_the_runtime():
    cfg = SchedulerConfig(tick_every=2, telemetry=8)
    ch = _mk_channel(prefetch=1)
    rt = SchedulerRuntime(cfg, [ch])
    from repro_torch.core.comm import TaskComm
    comm = TaskComm(task="t", scheduler=rt)
    for _ in range(4):
        comm.step()
    assert rt.steps == 4
    assert rt.snapshot()["step_sources"] == {"comm_step": 4}
    assert len(rt.timeline) == 2              # a tick every 2 steps
    rt.close()
    assert len(rt.timeline) == 3              # final sample
    comm.step()                               # closed: ignored, no tick
    assert rt.steps == 4


def test_error_report_still_carries_scheduler_state():
    yaml = _pipeline_yaml(scheduler="scheduler: {policy: fair}")
    from repro_torch.core import h5

    def producer():
        raise RuntimeError("boom")

    def consumer():
        while h5.File("o.h5", "r") is not None:
            pass

    w = Wilkins(yaml, {"producer": producer, "consumer": consumer},
                devices=[CPU])
    with pytest.raises(RuntimeError, match="boom") as ei:
        w.run(timeout=60)
    rep = ei.value.report
    assert rep.scheduler["policy"] == "fair"
    assert rep.timeline is not None


# ---------------------------------------------------------------------------
# fairness + convergence under real threads (slow)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_fair_weights_shift_prep_completions_disparate_rates():
    """2-edge disparate-rate contention on a 1-worker pool: weights 3:1
    shift prep completions toward the heavy edge by >= 2:1 while both edges
    stay backlogged."""
    done = {"hot": 0, "cold": 0}
    window = []
    lock = threading.Lock()
    pool = PrefetchPool(max_workers=1, policy=FairPolicy())
    gate = threading.Event()
    pool.submit(gate.wait)          # park the worker; queues build behind it
    futs = []
    for i in range(12):
        for edge, wgt in (("hot", 3), ("cold", 1)):
            def prep(edge=edge):
                with lock:
                    done[edge] += 1
                    if len(window) < 12:
                        window.append(edge)
            futs.append(pool.submit(prep, edge=edge, weight=wgt))
    gate.set()
    for f in futs:
        f.result(timeout=10)
    hot = window.count("hot")
    cold = window.count("cold")
    assert hot >= 2 * cold, f"completion window {window}"
    assert done == {"hot": 12, "cold": 12}   # everything still completes
    pool.shutdown()


def _blocked_edge(s):
    yaml = _pipeline_yaml(
        steps_extra="prefetch: 1\n        queue_depth: 4\n        "
                    "autotune: {min: 1, max: 4}",
        scheduler="scheduler: {policy: fair, tick_every: 2}")

    def producer():
        for t in range(12):
            with s.h5.File("o.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/g", data=s.data(np.arange(4096.0) + t))

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                return
            _ = f["/g"][0]
            s.record(("consumer", comm.instance, 0, int(f.attrs["step"])),
                     f["/g"])

    w = s.wilkins(yaml, {"producer": producer, "consumer": consumer})
    (ch,) = w.channels
    orig = ch._prepare

    def slow_prepare(*a, **kw):
        time.sleep(0.03)            # slower than the consumer: misses pile up
        return orig(*a, **kw)

    ch._prepare = slow_prepare
    rep = w.run(timeout=120)
    grew = [d for d in rep.scheduler["decisions"] if "grow" in d["reason"]]
    assert grew, rep.scheduler["decisions"]
    assert 1 < rep.scheduler["depths"][ch.name] <= 4
    return rep


@pytest.mark.slow
def test_autotuner_raises_depth_on_blocked_edge_in_real_workflow():
    """Fast producer -> slow-prep edge under autotune: the depth rises from
    its floor within the bound, in both packages, which deliver the same
    bytes."""
    t, j = run_both(_blocked_edge)
    assert len(t.side.got) == 12
    assert_same(t, j)
