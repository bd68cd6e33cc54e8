"""The training step's spans and the snapshot's ``vol.file`` span inside the
port's tracing (``repro_torch.train.trainer``, ``repro_torch.core.vol``,
``repro_torch.obs``): what a traced run records, what an untraced step
costs, how device intervals are resolved from CUDA events, and
``obs.last_run_spans()``.

The card's path runs here with ``torch.cuda``'s events, streams and
synchronisation replaced by fakes whose times the test chooses, so the
two-anchor map and the rule that no event object leaves the recorder are
checked without a card."""

import os
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Wilkins, h5  # noqa: E402
from repro_torch.obs import (SpanRecorder, TraceConfig, attribute,  # noqa: E402
                             export_trace, load_trace)
from repro_torch.obs import recorder as rec_mod  # noqa: E402
from repro_torch.obs.critical import PRECEDENCE  # noqa: E402
from repro_torch.obs.recorder import created_count, device_to_monotonic  # noqa: E402
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticCorpus,  # noqa: E402
                               init_state, make_train_step)
from repro_torch.train import trainer as trainer_mod  # noqa: E402

CPU = torch.device("cpu")
CFG = get_config("tinyllama-1.1b", reduced=True)
OCFG = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
PHASES = ("train.forward", "train.backward", "train.optimizer")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKFLOW = {"tasks": [
    {"func": "trainer", "nprocs": 1,
     "outports": [{"filename": "ckpt*.h5", "dsets": [{"name": "/model/*", "memory": 1}]}]},
    {"func": "evaluator", "nprocs": 1,
     "inports": [{"filename": "ckpt*.h5", "dsets": [{"name": "/model/*", "memory": 1}]}]},
]}


def _batch(step, b=4, s=16):
    return SyntheticCorpus(DataConfig(vocab=CFG.vocab, seq_len=s,
                                      global_batch=b)).batch(step)


def _run(tmp_path, steps=3, accum_steps=1, trace=True):
    """A trainer that takes ``steps`` steps, writing every parameter after
    each, and an evaluator that reads them; returns (report, the bytes
    each written file held)."""
    written = []
    tmp_path.mkdir(parents=True, exist_ok=True)

    def trainer():
        state = init_state(torch.Generator().manual_seed(0), CFG, OCFG, CPU)
        step_fn = make_train_step(CFG, OCFG, accum_steps=accum_steps)
        for i in range(steps):
            state, _ = step_fn(state, _batch(i))
            params = [p.detach().clone() for p in state.params.parameters()]
            with h5.File(f"ckpt{i:03d}.h5", "w") as f:
                for j, p in enumerate(params):
                    f.create_dataset(f"/model/p{j}", data=p)
            written.append(sum(p.numel() * p.element_size() for p in params))

    def evaluator():
        while h5.File("ckpt*.h5", "r") is not None:
            pass

    w = Wilkins(WORKFLOW, {"trainer": trainer, "evaluator": evaluator},
                devices=[CPU], spill_dir=str(tmp_path / "spill"))
    rep = w.run(timeout=120, trace=str(tmp_path / "trace.json") if trace else None)
    return rep, written


def _train_spans(spans):
    return [s for s in spans if s["cat"] == "train"]


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_each_step_has_one_parent_with_its_phases_inside(tmp_path, accum_steps):
    rep, _ = _run(tmp_path, steps=3, accum_steps=accum_steps)
    spans = load_trace(rep.trace_path)
    train = _train_spans(spans)
    parents = [s for s in train if s["name"] == "train.step"]
    assert [s["step"] for s in parents] == [1, 2, 3]
    for parent in parents:
        kids = [s for s in train if s["name"] != "train.step"
                and s["step"] == parent["step"]]
        assert [s["name"] for s in kids] == \
            ["train.forward", "train.backward"] * accum_steps + ["train.optimizer"]
        assert all(s["task"] == "trainer" and s["instance"] == 0 for s in kids)
        for s in kids:
            assert parent["t0"] - 1e-6 <= s["t0"] <= s["t1"] <= parent["t1"] + 1e-6
        # the phases tile the step: each starts where the one before ended
        assert abs(kids[0]["t0"] - parent["t0"]) < 1e-5
        assert abs(kids[-1]["t1"] - parent["t1"]) < 1e-5
        for a, b in zip(kids, kids[1:]):
            assert abs(b["t0"] - a["t1"]) < 1e-5
        # on the CPU no phase carries a device interval
        assert all("dev_t0" not in (s["args"] or {}) for s in kids + [parent])


def test_the_optimizer_span_counts_leaves_and_launches(tmp_path):
    """``train.optimizer`` carries the update's leaves (the model's
    parameter tensors) and the fused AdamW's launches: none on the CPU,
    whose update is the plain loop."""
    rep, _ = _run(tmp_path, steps=2)
    model = init_state(torch.Generator().manual_seed(0), CFG, OCFG, CPU).params
    n = len(dict(model.named_parameters()))
    opt = [s for s in load_trace(rep.trace_path) if s["name"] == "train.optimizer"]
    assert [(s["args"]["leaves"], s["args"]["launches"]) for s in opt] == [(n, 0)] * 2
    assert n > 1


def test_vol_file_carries_the_files_bytes(tmp_path):
    rep, written = _run(tmp_path, steps=3)
    spans = load_trace(rep.trace_path)
    files = [s for s in spans if s["name"] == "vol.file"]
    closes = {s["step"]: s for s in spans if s["name"] == "vol.close"}
    assert [s["args"]["filename"] for s in files] == \
        [f"ckpt{i:03d}.h5" for i in range(3)]
    assert [s["args"]["bytes"] for s in files] == written
    for s in files:
        assert s["cat"] == "vol" and s["task"] == "trainer"
        # from the file's creation to the end of its close
        close = closes[s["step"]]
        assert s["t0"] < close["t0"] and abs(s["t1"] - close["t1"]) < 1e-5


def test_attribution_sums_to_the_window_with_train_spans_in_compute(tmp_path):
    rep, _ = _run(tmp_path, steps=3)
    spans = load_trace(rep.trace_path)
    report = attribute(spans)
    buckets = PRECEDENCE + ("compute",)
    row = report["instances"]["trainer[0]"]
    assert abs(sum(row[b] for b in buckets) - row["window_s"]) <= 1e-9
    # train and vol.file spans claim nothing: dropping them changes nothing
    rest = [s for s in spans if s["cat"] != "train" and s["name"] != "vol.file"]
    assert attribute(rest)["instances"]["trainer[0]"]["block"] == row["block"]
    steps = sum(s["t1"] - s["t0"] for s in spans if s["name"] == "train.step")
    assert row["compute"] >= steps - 1e-6


# ------------------------------------------------- the card's path, faked
class FakeEvent:
    """A timing event whose device time (ms) the test's clock gives."""
    made = 0
    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.ms = None

    def record(self, stream=None):
        self.ms = FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s events, streams and synchronisation as fakes; the
    host's monotonic clock and the device's run at rates the test sets."""
    FakeEvent.made, FakeEvent.clock = 0, [0.0]
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    host = [100.0]

    class Clock:            # the recorder's and the step's ``time`` module
        @staticmethod
        def monotonic():
            return host[0]

    monkeypatch.setattr(rec_mod, "time", Clock)
    monkeypatch.setattr(trainer_mod, "time", Clock)
    return host


def _walk(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _walk(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _walk(v)
    else:
        yield obj


def test_device_intervals_follow_the_two_anchor_map(fake_cuda):
    """The first anchor at the first mark, the second at collection: an
    event's time maps linearly between them (the device clock here runs at
    1.001 times the host's, from another origin)."""
    assert device_to_monotonic(0.0, 5.0, 2000.0, 7.0) == 5.0
    assert device_to_monotonic(1000.0, 5.0, 2000.0, 7.0) == 6.0

    host = fake_cuda
    dev = torch.device("cuda", 0)

    def at(t_host):                 # both clocks at host second t_host
        host[0] = t_host
        FakeEvent.clock[0] = 7000.0 + 1.001e3 * (t_host - 100.0)

    rec = SpanRecorder(TraceConfig(shards=2))
    at(100.0)
    ev0 = rec.device_mark(dev)      # takes the first anchor at 100.0
    at(100.5)
    ev1 = rec.device_mark(dev)
    rec.record_device("train", "train.forward", "t", 0, 100.0, 100.5, dev,
                      ev0, ev1, step=1)
    at(110.0)                       # the second anchor, at collection
    (span,) = rec.spans()
    assert span["args"]["dev_t0"] == pytest.approx(100.0, abs=1e-9)
    assert span["args"]["dev_t1"] == pytest.approx(100.5, abs=1e-9)
    # a second collection resolves nothing again and keeps the values
    at(120.0)
    assert rec.spans()[0]["args"] == span["args"]


def test_phases_on_a_cuda_device_record_four_events_a_step(fake_cuda):
    host = fake_cuda
    rec = SpanRecorder(TraceConfig(shards=1))

    class Vol:
        task, instance, tracer = "trainer", 0, rec

    dev = torch.device("cuda", 0)
    for step in (1, 2):
        made = FakeEvent.made
        ph = trainer_mod._Phases(rec, Vol, step, dev)
        for name in PHASES:
            host[0] += 1.0
            FakeEvent.clock[0] += 1000.0
            ph.mark(name)
        ph.close()
        # the run's first anchor, then four events a step
        assert FakeEvent.made - made == 4 + (step == 1)
    spans = rec.spans()
    assert sorted(s["name"] for s in spans) == sorted(
        ["train.step", *PHASES] * 2)
    for s in spans:
        a = s["args"]
        assert a["dev_t1"] - a["dev_t0"] == pytest.approx(s["t1"] - s["t0"])


def test_no_event_reaches_the_export_or_a_flight_dump(fake_cuda, tmp_path):
    dev = torch.device("cuda", 0)
    rec = SpanRecorder(TraceConfig(shards=2))
    ev0 = rec.device_mark(dev)
    fake_cuda[0] += 1.0
    FakeEvent.clock[0] += 1000.0
    ev1 = rec.device_mark(dev)
    rec.record_device("train", "train.backward", "t", 0, 100.0, 101.0, dev,
                      ev0, ev1, step=4)
    dump = rec.mark_failure("test")               # before collection
    path = str(tmp_path / "dev.json")
    export_trace(path, rec)
    back = load_trace(path)
    for tree in (rec.spans(), back, dump, rec.dumps()):
        assert not any(isinstance(v, FakeEvent) for v in _walk(tree))
    (got,) = [s for s in back if s["name"] == "train.backward"]
    assert got["step"] == 4 and got["cat"] == "train"
    assert got["args"]["dev_t1"] - got["args"]["dev_t0"] == pytest.approx(1.0)


# ------------------------------------------------------------- zero cost
def test_untraced_step_makes_no_recorder_and_no_event(monkeypatch, tmp_path):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(a))
    n0 = created_count()
    state = init_state(torch.Generator().manual_seed(0), CFG, OCFG, CPU)
    step_fn = make_train_step(CFG, OCFG)
    step_fn(state, _batch(0))                     # outside any workflow
    _run(tmp_path, steps=2, trace=False)           # inside an untraced one
    assert created_count() == n0 and made == []


def test_last_run_spans_is_the_newest_traced_run(tmp_path):
    rep, _ = _run(tmp_path / "a", steps=1)
    first = obs.last_run_spans()
    assert first is not None and len(first) == rep.trace_spans
    rep, _ = _run(tmp_path / "b", steps=2)
    second = obs.last_run_spans()
    assert second is not first and len(second) == rep.trace_spans
    assert len([s for s in second if s["name"] == "train.step"]) == 2
    _run(tmp_path / "c", steps=1, trace=False)
    assert obs.last_run_spans() is second


def test_the_program_calls_no_profiler():
    """The port's tracing is the host's clock and CUDA events only."""
    pat = re.compile(r"torch\.profiler|record_function|nvtx|cupti|kineto", re.I)
    hits = []
    for base, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(base, name)
                with open(path) as f:
                    hits += [(path, i) for i, line in enumerate(f, 1)
                             if pat.search(line)]
    assert hits == []


def test_train_is_a_category():
    assert "train" in obs.CATEGORIES
