"""The port's run-wide tracing, critical-path analysis and flight recorder
(``repro_torch.obs``) beside the JAX package's: the twin of
``tests/test_obs.py``.

``obs/`` is a copy of the reference's (it imports no JAX), so the
recorder, exporter, attribution and CLI cases run on the port alone.
Every traced or untraced workflow carries data and runs through both
packages on the same inputs -- numpy arrays on the reference's side,
tensors on the port's -- holding the deliveries (keyed by task,
instance, producer and step; a replay after a restart must deliver the
same bytes again), the served and moved totals and the transport
counters equal (``torch_twins``), beside the reference's own assertions
on each package's report and trace.  Each reference case has a twin of
the same name.  By design:

* the exported Perfetto document names its exporter ``repro_torch.obs``;
* where a fault's timing decides what a consumer sees (which steps a
  restarted or rescaled instance replays), only the per-(instance,
  producer, step) deliveries both packages made are compared.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Wilkins  # noqa: E402
from repro_torch.core.channel import (_in_mux_wait_scope,  # noqa: E402
                                      enter_mux_wait_scope,
                                      exit_mux_wait_scope)
from repro_torch.obs import (SpanRecorder, TraceConfig, attribute,  # noqa: E402
                             critical_path, export_trace, flow_id,
                             format_report, load_trace, per_edge,
                             span_categories)
from repro_torch.obs.recorder import created_count  # noqa: E402
from torch_twins import (COPY_COUNTERS, CPU, assert_same,  # noqa: E402
                         assert_same_deliveries, run_both)

STEPS = 4
N = 64


# ---------------------------------------------------------------------------
# workflows
# ---------------------------------------------------------------------------
TRACED_YAML = """
tasks:
  - func: producer
    taskCount: 2
    on_failure:
      restart: {max_retries: 2}
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    taskCount: 2
    nprocs: 2
    on_failure:
      restart: {max_retries: 2}
    inports:
      - filename: o.h5
        redistribute: 1
        prefetch: 2
        dsets: [{name: /g, memory: 1}]
"""


def _traced(s, tmp_path, tag, **run_kw):
    """The traced workflow through one package; returns (workflow, report
    or the raised error)."""
    def producer(comm):
        start = 0
        r = comm.restore({"t": np.zeros((), np.int64)})
        if r is not None:
            start = int(r[1]["t"])
        for t in range(start, STEPS):
            with s.h5.File("o.h5", "w") as f:
                f.attrs["producer"] = comm.instance
                f.attrs["step"] = t
                f.create_dataset("/g", data=s.data(
                    np.arange(N, dtype=np.float64) + t))
            comm.checkpoint({"t": np.array(t + 1, np.int64)})

    def consumer(comm):
        n = 0
        r = comm.restore({"n": np.zeros((), np.int64)})
        if r is not None:
            n = int(r[1]["n"])
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            blocks = comm.reshard(f["/g"])
            s.record(("consumer", comm.instance, int(f.attrs["producer"]),
                      int(f.attrs["step"])), np.concatenate(
                          [s.host(b) for b in blocks]))
            n += 1
            comm.checkpoint({"n": np.array(n, np.int64)})

    if isinstance(run_kw.get("trace"), str):
        run_kw["trace"] = run_kw["trace"].format(side=s.name)
    w = s.wilkins(TRACED_YAML, {"producer": producer, "consumer": consumer},
                  spill_dir=str(tmp_path / s.name / tag))
    return w, w.run(timeout=60, **run_kw)


def _traced_both(tmp_path, tag, **run_kw):
    t, j = run_both(_traced, tmp_path, tag, **run_kw)
    (w, rep), (_, jrep) = t.result, j.result
    t.result, j.result = rep, jrep
    return w, rep, t, j


# ---------------------------------------------------------------------------
# TraceConfig parsing / validation
# ---------------------------------------------------------------------------
def test_traceconfig_spellings():
    assert TraceConfig.from_yaml(None) is None
    assert TraceConfig.from_yaml(False) is None
    assert TraceConfig.from_yaml(True).flight_len == 256
    c = TraceConfig.from_yaml({"path": "t.json", "flight_len": 8,
                               "max_spans": 100, "shards": 4})
    assert (c.path, c.flight_len, c.max_spans, c.shards) == \
           ("t.json", 8, 100, 4)
    assert TraceConfig.coerce(None) is None
    assert TraceConfig.coerce("x.json").path == "x.json"
    assert TraceConfig.coerce(c) is c


@pytest.mark.parametrize("doc, err", [
    ({"bogus": 1}, "unknown tracing keys"),
    ({"shards": 3}, "power of two"),
    ({"flight_len": 0}, "flight_len"),
    ({"max_spans": 0}, "max_spans"),
    ("nope", "boolean or a mapping"),
])
def test_traceconfig_rejects(doc, err):
    with pytest.raises(ValueError, match=err):
        TraceConfig.from_yaml(doc)


def test_yaml_tracing_block_parses():
    from repro_torch.core import WorkflowGraph
    g = WorkflowGraph.from_yaml("""
tasks:
  - func: p
tracing: {flight_len: 16}
""")
    assert g.tracing is not None and g.tracing.flight_len == 16


# ---------------------------------------------------------------------------
# zero-cost default
# ---------------------------------------------------------------------------
def test_untraced_run_allocates_no_recorder(tmp_path):
    from repro.obs.recorder import created_count as jcreated_count
    n0, j0 = created_count(), jcreated_count()
    w, rep, t, j = _traced_both(tmp_path, "off")
    assert created_count() == n0, "untraced run constructed a SpanRecorder"
    assert jcreated_count() == j0
    assert len(t.side.got) == 2 * STEPS       # NxN: producer i feeds consumer i
    assert_same(t, j)
    assert rep.trace_spans == 0 and rep.trace_path is None
    assert rep.critical_path == {} and rep.flight_recorder == []
    for vol in w.vols.values():
        assert vol.tracer is None
    for ch in w.channels:
        assert ch._tracer is None
    assert w._run_tracer is None


# ---------------------------------------------------------------------------
# layer coverage + export round-trip on a fault-injected run
# ---------------------------------------------------------------------------
def test_traced_faulted_run_covers_six_layers(tmp_path):
    w, rep, t, j = _traced_both(
        tmp_path, "layers", trace=str(tmp_path / "trace-{side}.json"),
        faults=dict(task="consumer", point="recv", step=1, instance=1))
    path = str(tmp_path / "trace-torch.json")
    assert rep.trace_path == path and rep.trace_spans > 0
    assert len(rep.restarts) == len(j.report.restarts) == 1
    # every (instance, producer, step) reached its consumer in both
    assert len(t.side.got) == 2 * STEPS       # NxN: producer i feeds consumer i
    assert_same_deliveries(t, j)
    assert rep.total_bytes_moved == j.report.total_bytes_moved
    spans = load_trace(path)
    cats = set(span_categories(spans))
    assert {"vol", "channel", "prefetch", "reshard", "checkpoint",
            "recovery"} <= cats, cats
    # teardown symmetry: tracer detached everywhere after the run
    for vol in w.vols.values():
        assert vol.tracer is None
    for ch in w.channels:
        assert ch._tracer is None

    # the Perfetto document is structurally loadable: metadata tracks,
    # duration events, paired flow arrows, instants, counters
    doc = json.load(open(path))
    phs = {ev["ph"] for ev in doc["traceEvents"]}
    assert {"M", "X", "s", "f", "i"} <= phs, phs
    assert doc["otherData"]["exporter"] == "repro_torch.obs"

    # round-trip: flow arrows pair producer offers with consumer receives
    offers = {s["flow"][1] for s in spans
              if s["flow"] and s["flow"][0] == "s"}
    recvs = {s["flow"][1] for s in spans
             if s["flow"] and s["flow"][0] == "f"}
    assert offers and offers & recvs

    # every span is closed; aborted intervals are flagged, not dangling
    for s in spans:
        assert s["t1"] >= s["t0"]
    # the injected crash aborts the consumer's blocked get
    aborted = [s for s in spans if (s["args"] or {}).get("aborted")]
    assert all(s["args"].get("why") in ("timeout", "interrupt", "poison",
                                        None) or True for s in aborted)

    # summary carries the attribution tables
    text = rep.summary()
    assert "critical-path attribution" in text
    assert "per-edge hand-off costs" in text
    assert f"trace: spans={rep.trace_spans}" in text


def test_export_roundtrip_exact(tmp_path):
    rec = SpanRecorder(TraceConfig(shards=1))
    t = rec.t_origin
    rec.record("channel", "channel.offer", "p", 0, t, t + 0.5, step=3,
               flow=("s", flow_id("e", 3)), edge="e", bytes=64)
    rec.record("channel", "channel.get", "c", 1, t + 0.2, t + 0.6,
               flow=("f", flow_id("e", 3)), edge="e")
    rec.instant("recovery", "task.drop", "c", 1, t=t + 0.7, reason="x")
    rec.counter("qdepth:e", 2, t=t + 0.3)
    path = str(tmp_path / "rt.json")
    export_trace(path, rec)
    back = load_trace(path)
    assert [s["name"] for s in back] == \
           ["channel.offer", "channel.get", "qdepth:e", "task.drop"]
    offer, get = back[0], back[1]
    assert offer["flow"] == ("s", flow_id("e", 3))
    assert get["flow"] == ("f", flow_id("e", 3))
    assert offer["task"] == "p" and offer["instance"] == 0
    assert offer["step"] == 3 and offer["args"]["bytes"] == 64
    assert abs((offer["t1"] - offer["t0"]) - 0.5) < 1e-5
    assert back[2]["args"]["value"] == 2


# ---------------------------------------------------------------------------
# critical-path attribution
# ---------------------------------------------------------------------------
def _span(cat, name, task, inst, t0, t1, **args):
    return {"ph": "X", "cat": cat, "name": name, "task": task,
            "instance": inst, "t0": t0, "t1": t1, "step": args.pop("step", None),
            "flow": None, "args": args or None}


def test_attribution_synthetic_known_answer():
    spans = [
        # window [0, 10]; block [1, 4]; reshard [3, 5] (overlap claimed by
        # block first -> reshard nets 1s); checkpoint [8, 9]
        _span("channel", "channel.get", "c", 0, 1.0, 4.0, edge="e"),
        _span("reshard", "reshard.numpy", "c", 0, 3.0, 5.0, edge=None),
        _span("checkpoint", "ckpt.save", "c", 0, 8.0, 9.0),
        _span("task", "task.window", "c", 0, 0.0, 10.0),
    ]
    rep = attribute(spans)
    row = rep["instances"]["c[0]"]
    assert row["window_s"] == pytest.approx(10.0)
    assert row["block"] == pytest.approx(3.0)
    assert row["reshard"] == pytest.approx(1.0)
    assert row["checkpoint"] == pytest.approx(1.0)
    assert row["compute"] == pytest.approx(5.0)
    total = sum(row[b] for b in ("block", "prep", "reshard", "checkpoint",
                                 "recovery", "rescale", "compute"))
    assert total == pytest.approx(row["window_s"], abs=1e-12)
    assert critical_path(spans) == "c[0]"
    text = format_report(rep)
    assert "c[0] *" in text


def test_attribution_vol_lifecycle_claims_nothing():
    spans = [
        # vol.close CONTAINS a nested offer wait: only the wait may claim
        _span("vol", "vol.close", "p", 0, 0.0, 5.0),
        _span("channel", "channel.offer", "p", 0, 1.0, 3.0, edge="e"),
    ]
    row = attribute(spans)["instances"]["p[0]"]
    assert row["block"] == pytest.approx(2.0)
    assert row["compute"] == pytest.approx(3.0)


def test_per_edge_rollup_separates_prep_from_blocked():
    spans = [
        _span("prefetch", "prefetch.prep", "pool", 3, 0.0, 1.0, edge="e",
              bytes=100),
        _span("prefetch", "prefetch.wait", "c", 0, 2.0, 2.5, edge="e",
              cache="miss", bytes=100),
        _span("channel", "channel.get", "c", 0, 3.0, 3.25, edge="e"),
        _span("reshard", "reshard.pack", "c", 0, 4.0, 4.1, edge="f",
              cache="hit", bytes=7),
    ]
    edges = per_edge(spans)
    assert edges["e"]["prep_s"] == pytest.approx(1.0)
    assert edges["e"]["blocked_s"] == pytest.approx(0.75)
    assert edges["e"]["bytes"] == 200 and edges["e"]["misses"] == 1
    assert edges["f"]["hits"] == 1 and edges["f"]["bytes"] == 7


RATE_YAML = """
tasks:
  - func: slow
    outports: [{filename: a.h5, dsets: [{name: /g, memory: 1}]}]
  - func: fast
    outports: [{filename: b.h5, dsets: [{name: /h, memory: 1}]}]
  - func: sink
    inports:
      - {filename: a.h5, dsets: [{name: /g, memory: 1}]}
      - {filename: b.h5, dsets: [{name: /h, memory: 1}]}
"""
DELAY = 0.05


def _rate(s, tmp_path):
    def slow():
        for t in range(STEPS):
            time.sleep(DELAY)
            with s.h5.File("a.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/g", data=s.data(np.arange(8.0) + t))

    def fast():
        for t in range(STEPS):
            with s.h5.File("b.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/h", data=s.data(np.arange(8.0) - t))

    def sink():
        while True:
            fa = s.h5.File("a.h5", "r")
            if fa is None:
                break
            s.record(("sink", 0, 0, int(fa.attrs["step"])), fa["/g"])
            fb = s.h5.File("b.h5", "r")
            if fb is not None:
                s.record(("sink", 0, 1, int(fb.attrs["step"])), fb["/h"])

    w = s.wilkins(RATE_YAML, {"slow": slow, "fast": fast, "sink": sink},
                  spill_dir=str(tmp_path / s.name / "rate"))
    return w.run(timeout=60, trace=True)


def test_disparate_rate_attribution(tmp_path):
    """2-edge fan-in with one slow producer: the consumer's blocked time
    lands on the slow edge, and the fast producer blocks in its offers --
    a known answer the analyzer must reproduce from the spans alone, in
    both packages."""
    t, j = run_both(_rate, tmp_path)
    assert len(t.side.got) == 2 * STEPS
    assert_same(t, j)
    rep = t.report
    att = rep.critical_path
    assert att["instances"]
    for key, row in att["instances"].items():
        total = sum(row[b] for b in ("block", "prep", "reshard",
                                     "checkpoint", "recovery", "rescale",
                                     "compute"))
        assert total == pytest.approx(row["window_s"], abs=1e-9), key
    edges = att["edges"]
    assert sorted(edges) == sorted(j.report.critical_path["edges"])
    slow_edge = next(e for e in edges if "a.h5" in e)
    fast_edge = next(e for e in edges if "b.h5" in e)
    assert edges[slow_edge]["blocked_s"] > 2 * DELAY
    assert edges[slow_edge]["blocked_s"] > edges[fast_edge]["blocked_s"]
    crit = att["critical"]
    assert crit.startswith(("slow", "sink"))
    for step, row in att["steps"].items():
        total = sum(row[b] for b in ("block", "prep", "reshard",
                                     "checkpoint", "recovery", "rescale",
                                     "compute"))
        assert total == pytest.approx(row["latency_s"], rel=0.05), step


# ---------------------------------------------------------------------------
# flight recorder: all four failure paths
# ---------------------------------------------------------------------------
FAIL_YAML = """
tasks:
  - func: p
    outports: [{filename: o.h5, dsets: [{name: /g, memory: 1}]}]
  - func: c
    %s
    inports: [{filename: o.h5, dsets: [{name: /g, memory: 1}]}]
"""


def _fail(s, tmp_path, tag, extra, **run_kw):
    """p writes 3 steps; c records what it received and dies.  Returns the
    error the run raised."""
    def p():
        for t in range(3):
            with s.h5.File("o.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/g", data=s.data(np.arange(8.0) + t))

    def c(comm):
        f = s.h5.File("o.h5", "r")
        if f is not None:
            s.record(("c", comm.instance, 0, int(f.attrs["step"])), f["/g"])
        raise RuntimeError("dies every attempt")

    w = s.wilkins(FAIL_YAML % extra, {"p": p, "c": c},
                  spill_dir=str(tmp_path / s.name / tag))
    with pytest.raises(RuntimeError) as ei:
        w.run(timeout=60, **run_kw)
    return ei.value


def test_flight_dump_on_terminal_task_failure(tmp_path):
    t, j = run_both(_fail, tmp_path, "fail", "", trace=True)
    assert_same_deliveries(t, j)
    assert list(t.side.got) == [("c", 0, 0, 0)]
    for run in (t, j):
        rep = run.result.report
        assert rep.flight_recorder, "no flight dump on terminal failure"
        d = rep.flight_recorder[0]
        assert d["task"] == "c" and "task failure" in d["reason"]
        assert d["spans"], "dump carries no recent spans"
        assert "FLIGHT-DUMP" in rep.summary()


def test_flight_dump_on_restart_exhaustion(tmp_path):
    t, j = run_both(_fail, tmp_path, "exh",
                    "on_failure: {restart: {max_retries: 1}}", trace=True)
    assert_same_deliveries(t, j)
    for run in (t, j):
        rep = run.result.report
        assert any("restarts exhausted" in d["reason"]
                   for d in rep.flight_recorder), rep.flight_recorder
        assert len(rep.flight_recorder) == 1


STALL_YAML = """
tasks:
  - func: p1
    outports: [{filename: a.h5, dsets: [{name: /g, memory: 1}]}]
    on_failure: {restart: {max_retries: 3}}
  - func: c1
    taskCount: 2
    stall_timeout_s: 0.25
    inports:
      - {filename: a.h5, redistribute: 1, dsets: [{name: /g, memory: 1}]}
    on_failure: {rescale: {nslots: 1, max_retries: 3}}
"""


def _stall(s, tmp_path):
    red = s.red
    final = {}

    def p1(comm):
        comm.restore({"t": np.zeros((), np.int64)})
        for t in range(STEPS):
            with s.h5.File("a.h5", "w") as f:
                f.create_dataset("/g", data=s.data(np.arange(16.0) + t))
            comm.checkpoint({"t": np.array(t + 1, np.int64)})

    def c1(comm):
        spec = comm.resolve_redist_spec(port="a.h5")
        _, shape = red.even_blocks((16,), spec.nslots)[spec.slot]
        state = {"acc": np.zeros(shape, np.float64),
                 "n": np.zeros((), np.int64)}
        r = comm.restore(state)
        if r is not None:
            state = r[1]
        acc, n = np.asarray(state["acc"]).copy(), int(state["n"])
        while True:
            f = s.h5.File("a.h5", "r")
            if f is None:
                break
            acc = acc + s.host(f["/g"][...])
            n += 1
            comm.checkpoint({"acc": acc, "n": np.array(n, np.int64)},
                            sharded_axes={"acc": 0})
        with s.lock:
            final[(spec.nslots, spec.slot)] = (acc, n)

    path = str(tmp_path / f"stall-{s.name}.json")
    w = s.wilkins(STALL_YAML, {"p1": p1, "c1": c1},
                  spill_dir=str(tmp_path / s.name / "st"))
    rep = w.run(timeout=60, trace=path,
                faults=dict(task="c1", kind="stall", point="recv", step=1,
                            instance=0, seconds=1.5))
    return rep, path, final


def test_flight_dump_on_stall(tmp_path):
    t, j = run_both(_stall, tmp_path)
    for run in (t, j):
        rep, path, final = run.result
        assert len(rep.stalls) == 1
        assert any("stall declared" in d["reason"] for d in rep.flight_recorder)
        # after the 2 -> 1 rescale one instance holds every step's sum
        acc, n = final[(1, 0)]
        assert n == STEPS
        np.testing.assert_array_equal(
            acc, sum(np.arange(16.0) + t for t in range(STEPS)))
        spans = load_trace(path)
        stages = {s["name"] for s in spans if s["cat"] == "rescale"}
        assert {"rescale.grace", "rescale.snapshot", "rescale.recut",
                "rescale.rebuild", "rescale.swap"} <= stages, stages
        t_swap = max(s["t1"] for s in spans if s["name"] == "rescale.swap")
        assert any(s["cat"] in ("vol", "counter") and s["t0"] >= t_swap
                   for s in spans), \
            "rebuilt channels/VOLs recorded nothing after the surgery"


def test_flight_dump_on_join_timeout(tmp_path):
    ev = threading.Event()

    def hang(comm):
        ev.wait(10)

    w = Wilkins("tasks:\n  - func: hang\n", {"hang": hang},
                spill_dir=str(tmp_path / "hang"), devices=[CPU])
    try:
        with pytest.raises(TimeoutError) as ei:
            w.run(timeout=0.3, trace=True)
    finally:
        ev.set()
    rep = ei.value.report
    assert any("join timeout" in d["reason"] for d in rep.flight_recorder)


def test_flight_ring_is_bounded():
    rec = SpanRecorder(TraceConfig(flight_len=8, shards=1, max_spans=10))
    for i in range(100):
        rec.record("task", "t", "a", 0, float(i), float(i) + 0.5)
    assert len(rec.flight()) == 8
    assert len(rec) == 10 and rec.dropped == 90
    for i in range(20):
        rec.mark_failure(f"r{i}")
    assert len(rec.dumps()) == 8  # bounded dump list


# ---------------------------------------------------------------------------
# span lifecycle under crash/restart/rescale
# ---------------------------------------------------------------------------
def test_restart_spans_closed_and_marked(tmp_path):
    w, rep, t, j = _traced_both(
        tmp_path, "life", trace=str(tmp_path / "life-{side}.json"),
        faults=dict(task="producer", point="close", step=1, instance=0))
    assert len(rep.restarts) == len(j.report.restarts) == 1
    assert len(t.side.got) == 2 * STEPS       # NxN: producer i feeds consumer i
    assert_same_deliveries(t, j)
    spans = load_trace(str(tmp_path / "life-torch.json"))
    assert all(s["t1"] >= s["t0"] for s in spans)
    assert any(s["name"] == "recovery.restart" for s in spans)
    assert any(s["name"] == "channel.quarantine_producer" for s in spans)
    t_restart = max(s["t1"] for s in spans
                    if s["name"] == "recovery.restart")
    assert any(s["name"] == "channel.offer" and s["t0"] >= t_restart
               for s in spans), "no spans recorded after the restart"


# ---------------------------------------------------------------------------
# counter consistency
# ---------------------------------------------------------------------------
def test_channel_stats_snapshot_locked(tmp_path):
    w, rep, t, j = _traced_both(tmp_path, "snap")
    assert_same(t, j)
    for ch in w.channels:
        snap = ch.stats_snapshot()
        assert snap["served"] == ch.stats.served
        assert snap["bytes_moved"] == ch.stats.bytes_moved
        for k, v in snap.items():
            assert isinstance(v, (int, float)), (k, type(v))


def test_error_report_carries_transport_snapshots(tmp_path):
    t, j = run_both(_fail, tmp_path, "errsnap", "")
    assert_same_deliveries(t, j)
    for run in (t, j):
        rep = run.result.report
        assert rep.transport, "error-path report lost the transport snapshot"
        assert rep.plan_cache, "error-path report lost the plan-cache snapshot"
        assert rep.scheduler
    assert t.result.report.transport["copies"] == j.result.report.transport["copies"]


def test_mux_wait_scope_prevents_double_count():
    from repro_torch.core.channel import Channel
    from repro_torch.core.datamodel import File

    def mk():
        return Channel(name="p[0]->c[0]:o.h5", producer=("p", 0),
                       consumer=("c", 0), filename_pattern="o.h5",
                       dset_patterns=["/g"], io_freq=1, queue_depth=2,
                       prefetch=0, record_events=False)

    ch = mk()
    f = File("o.h5")
    f.create_dataset("/g", data=torch.zeros(4))
    ch.offer(f)
    # inside the vol's mux-wait scope, get() must NOT add consumer_wait_s
    # (the vol accounts the scan wait itself); outside it must
    token = enter_mux_wait_scope([ch])
    try:
        assert _in_mux_wait_scope(ch)
        assert ch.get() is not None
        assert ch.stats.consumer_wait_s == 0.0
    finally:
        exit_mux_wait_scope(token)
    assert not _in_mux_wait_scope(ch)
    ch2 = mk()
    f2 = File("o.h5")
    f2.create_dataset("/g", data=torch.zeros(4))
    ch2.offer(f2)
    assert ch2.get() is not None
    assert ch2.stats.consumer_wait_s > 0.0


MUX_YAML = """
tasks:
  - func: p
    outports: [{filename: o.h5, dsets: [{name: /g, memory: 1}]}]
  - func: c
    inports: [{filename: o.h5, dsets: [{name: /g, memory: 1}]}]
"""
MUX_DELAY = 0.08


def _mux(s, tmp_path):
    def p():
        for t in range(3):
            time.sleep(MUX_DELAY)
            with s.h5.File("o.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/g", data=s.data(np.arange(4.0) + t))

    def c():
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            s.record(("c", 0, 0, int(f.attrs["step"])), f["/g"])

    w = s.wilkins(MUX_YAML, {"p": p, "c": c},
                  spill_dir=str(tmp_path / s.name / "mux"))
    rep = w.run(timeout=60)
    wait = sum(ch.stats.consumer_wait_s for ch in w.channels)
    assert wait <= rep.wall_time_s + 0.01, \
        f"consumer_wait_s {wait:.3f} exceeds wall {rep.wall_time_s:.3f}"
    assert wait >= 2 * MUX_DELAY * 0.5, f"mux waits not accounted: {wait:.4f}"
    return rep


def test_mux_wait_not_double_counted_end_to_end(tmp_path):
    """One slow producer, one consumer waiting through the vol mux: the
    per-edge wait is counted once, in both packages."""
    t, j = run_both(_mux, tmp_path)
    assert len(t.side.got) == 3
    assert_same(t, j)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_obs_report_cli(tmp_path, capsys):
    rec = SpanRecorder(TraceConfig(shards=1))
    t = rec.t_origin
    rec.record("channel", "channel.offer", "p", 0, t, t + 0.2,
               step=0, edge="e")
    rec.record("channel", "channel.get", "c", 0, t + 0.1, t + 0.3,
               step=0, edge="e")
    path = str(tmp_path / "cli.json")
    export_trace(path, rec)
    from repro_torch.obs.__main__ import main
    assert main(["report", path]) == 0
    out = capsys.readouterr().out
    assert "critical-path attribution" in out
    assert "spans" in out
    assert main(["report", path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "instances" in doc and "edges" in doc


def test_obs_report_cli_empty_trace(tmp_path, capsys):
    path = str(tmp_path / "empty.json")
    json.dump({"traceEvents": []}, open(path, "w"))
    from repro_torch.obs.__main__ import main
    assert main(["report", path]) == 1


# ---------------------------------------------------------------------------
# the main path traced: the 4->2 workflow of ``chip_smoke.py`` phase 17
# ---------------------------------------------------------------------------
MAIN_SHAPE = (16, 16, 16)
MAIN_STEPS = 2
MAIN_YAML = """
tasks:
  - func: nyx
    taskCount: 4
    outports:
      - filename: plt.h5
        dsets: [{name: /density, memory: 1}]
  - func: reeber
    taskCount: 2
    nprocs: 2
    inports:
      - filename: plt.h5
        redistribute: 1
        dsets: [{name: /density, memory: 1}]
  - func: viz
    taskCount: 2
    nprocs: 2
    inports:
      - filename: plt.h5
        redistribute: {axis: 1}
        dsets: [{name: /density, memory: 1}]
"""


def _main_path(s, tmp_path):
    """The 4->2 workflow through one package, traced into a file: four
    producers of a seeded field each step, ``reeber`` resharding along axis
    0 and ``viz`` along axis 1, both on the pack path.  Returns (report,
    trace path)."""
    import jax.numpy as jnp

    from repro.core.redistribute import even_blocks

    own = s.dm.BlockOwnership()
    for r, (st, sh) in enumerate(even_blocks(MAIN_SHAPE, 4)):
        own.add(r, st, sh)

    def nyx(comm):
        for t in range(MAIN_STEPS):
            a = np.random.default_rng(100 * comm.instance + t) \
                .random(MAIN_SHAPE).astype(np.float32)
            with s.h5.File("plt.h5", "w") as f:
                f.attrs["producer"] = comm.instance
                f.attrs["step"] = t
                if s.port:
                    f.create_dataset("/density", data=s.data(a),
                                     ownership=own, copy=False)
                else:
                    ds = f.inner.create_dataset("/density", data=jnp.asarray(a),
                                                copy=False)
                    ds.ownership = own

    def consumer(comm):
        while True:
            f = s.h5.File("plt.h5", "r")
            if f is None:
                break
            blocks = comm.reshard(f["/density"], prefer="pack")
            s.record((comm.task, comm.instance, int(f.attrs["producer"]),
                      int(f.attrs["step"])),
                     np.concatenate([s.host(b).ravel() for b in blocks]))

    path = str(tmp_path / f"main-{s.name}.json")
    w = s.wilkins(MAIN_YAML, {"nyx": nyx, "reeber": consumer, "viz": consumer},
                  spill_dir=str(tmp_path / s.name))
    return w.run(timeout=60, trace=path), path


def _span_counts(spans, cats=("reshard", "channel")):
    out = {}
    for sp in spans:
        if sp["cat"] in cats and sp["ph"] == "X":
            key = (sp["task"], sp["instance"], sp["cat"])
            out[key] = out.get(key, 0) + 1
    return out


def test_traced_main_path_matches_jax_and_the_cli(tmp_path):
    """Both packages trace the 4->2 workflow alike: the same deliveries,
    the same layers, the same reshard and channel spans per instance, and
    each instance's buckets summing to its window; the port's offline CLI
    (``python -m repro_torch.obs report --json``, a fresh interpreter)
    gives the attribution of the trace it reads, which is the run's own
    within the export's 1 ns rounding."""
    import os
    import subprocess
    import sys

    from repro_torch.obs.critical import PRECEDENCE

    t, j = run_both(_main_path, tmp_path)
    (rep, path), (jrep, jpath) = t.result, j.result
    t.result, j.result = rep, jrep
    assert len(t.side.got) == 2 * 2 * 2 * MAIN_STEPS   # 2 tasks x 2 inst x 2 prod
    # viz's slab along axis 1 is a strided view of a tensor: the port's pack
    # executor copies it once, counted, where a jax.Array has no strides
    assert_same(t, j, counters=tuple(c for c in COPY_COUNTERS
                                     if c not in ("copies", "bytes_copied")))
    assert t.stats["copies"] == 4 * MAIN_STEPS and j.stats["copies"] == 0
    assert t.stats["reshard_pack"] == len(t.side.got)
    spans, jspans = load_trace(path), load_trace(jpath)
    assert set(span_categories(spans)) == set(span_categories(jspans))
    assert {"vol", "channel", "reshard"} <= set(span_categories(spans))
    counts = _span_counts(spans)
    assert counts == _span_counts(jspans)
    assert all(counts[(task, i, "reshard")] == 2 * MAIN_STEPS
               for task in ("reeber", "viz") for i in range(2))
    buckets = PRECEDENCE + ("compute",)
    for report in (rep, jrep):
        rows = report.critical_path["instances"]
        assert sorted(rows) == sorted(f"{task}[{i}]" for task, n in
                                      (("nyx", 4), ("reeber", 2), ("viz", 2))
                                      for i in range(n))
        for row in rows.values():
            assert abs(sum(row[b] for b in buckets) - row["window_s"]) <= 1e-9
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report", path,
                        "--json"], capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    cli = json.loads(p.stdout)
    assert cli == json.loads(json.dumps(attribute(spans)))
    run = json.loads(json.dumps(rep.critical_path))
    assert cli["critical"] == run["critical"]
    for key in ("instances", "steps", "edges"):
        assert sorted(cli[key]) == sorted(run[key])
        for k, row in run[key].items():
            for field, v in row.items():
                if isinstance(v, float):
                    assert abs(cli[key][k][field] - v) <= 1e-6, (key, k, field)
                else:
                    assert cli[key][k][field] == v, (key, k, field)
