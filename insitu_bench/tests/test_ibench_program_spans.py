"""The readers of the program's own spans (``lib/program_spans.py`` and the
seven metrics on it: ``train.forward_ms``, ``train.backward_ms``,
``train.optimizer_ms``, ``train.backward_idle_share``,
``train.optimizer_idle_share``, ``insitu.write_ms``,
``insitu.write_gb_per_s``), on synthetic spans
and a synthetic device trace with known answers, and on a traced run of
the tiny cell on the CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from insitu_bench.lib import spec  # noqa: E402
from insitu_bench.lib.devtrace import Trace  # noqa: E402

DEVICE = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms",
          "train.backward_idle_share", "train.optimizer_idle_share")
WRITE = ("insitu.write_ms", "insitu.write_gb_per_s")
NEW = DEVICE + WRITE


def read(name, raw):
    return spec.reader(name).read(raw)


def _span(name, step, t0, t1, dev=None, **args):
    if dev is not None:
        args.update(dev_t0=dev[0], dev_t1=dev[1])
    return {"ph": "X", "cat": "vol" if name.startswith("vol") else "train",
            "name": name, "task": "trainer", "instance": 0, "t0": t0, "t1": t1,
            "step": step, "flow": None, "args": args}


def _step(step, host0, forward_ms, backward_ms=1000.0, optimizer_ms=None,
          split_forward=False):
    """A step's four spans: its host interval starts at ``host0``, its device
    interval 0.05 s later; the phases tile it."""
    optimizer_ms = 200.0 + step if optimizer_ms is None else optimizer_ms
    d = host0 + 0.05
    out = []
    if split_forward:          # two microbatches' forwards, halves of one
        half = forward_ms / 2e3
        out += [_span("train.forward", step, host0, host0 + 0.01, (d, d + half)),
                _span("train.forward", step, host0 + 0.01, host0 + 0.02,
                      (d + half, d + 2 * half))]
    else:
        out.append(_span("train.forward", step, host0, host0 + 0.02,
                         (d, d + forward_ms / 1e3)))
    b0 = d + forward_ms / 1e3
    b1 = b0 + backward_ms / 1e3
    o1 = b1 + optimizer_ms / 1e3
    out += [_span("train.backward", step, host0 + 0.02, host0 + 0.03, (b0, b1)),
            _span("train.optimizer", step, host0 + 0.03, host0 + 0.04, (b1, o1)),
            _span("train.step", step, host0, host0 + 0.04, (d, o1))]
    return out


@pytest.fixture
def program(monkeypatch):
    """The program's ``obs`` module with ``last_run_spans`` giving the
    spans the test sets."""
    from repro_torch import obs

    box = {"spans": None}
    monkeypatch.setattr(obs, "last_run_spans", lambda: box["spans"])
    return box


def _window():
    """Window 10-30 s; steps 1-9 start at 10 + 2(k-1) + 0.1 and end (their
    loss read) at 10 + 2k; the profiled sub-window opens at 26, so steps 1-8
    are the window steps.  Step 0 lies before the window.  Forward takes
    100 + 10k ms (step 8's in two microbatches), step 9's and step 0's far
    more; optimizer 200 + k ms."""
    spans = _step(0, 8.1, 5000.0)
    for k in range(1, 9):
        spans += _step(k, 10 + 2 * (k - 1) + 0.1, 100.0 + 10 * k,
                       split_forward=(k == 8))
    spans += _step(9, 26.1, 1000.0)
    spans += [_span("vol.file", 0, 9.0, 9.5, bytes=7),
              _span("vol.file", 1, 12.0, 12.020, bytes=1_000_000_000),
              _span("vol.file", 2, 22.0, 22.030, bytes=4_000_000_000),
              _span("vol.file", 3, 31.0, 31.5, bytes=7)]
    raw = {"t0": 10.0, "t_end": 30.0, "steps": 9,
           "step_ends": [10.0 + 2 * k for k in range(1, 10)],
           "trace": Trace(26.0, 30.0, [("k", 26.0, 26.1)])}
    return spans, raw


def test_phase_medians_over_the_window_steps(program):
    program["spans"], raw = _window()
    assert read("train.forward_ms", raw) == pytest.approx(145.0)   # 110..180
    assert read("train.backward_ms", raw) == pytest.approx(1000.0)
    assert read("train.optimizer_ms", raw) == pytest.approx(204.5)  # 201..208
    # with no trace every step of the window counts, step 9 too
    raw["trace"] = None
    assert read("train.forward_ms", raw) == pytest.approx(150.0)
    assert read("train.optimizer_ms", raw) == pytest.approx(205.0)


def test_idle_shares_join_the_intervals_to_the_trace(program):
    raw = {"t0": 10.0, "t_end": 30.0, "steps": 3, "step_ends": [12.0, 14.0, 29.0],
           "trace": Trace(26.0, 30.0, [("k", 26.0, 26.2), ("k", 26.3, 26.6),
                                       ("k", 27.0, 27.4)])}
    program["spans"] = [
        # clipped to the sub-window: 26.0-26.4, busy 0.2 + 0.1 of 0.4
        _span("train.backward", 2, 25.0, 25.1, (25.8, 26.4)),
        # busy 0.4 of 0.6
        _span("train.backward", 3, 26.0, 26.1, (26.9, 27.5)),
        # outside the sub-window: not read
        _span("train.backward", 1, 20.0, 20.1, (20.0, 21.0)),
        _span("train.optimizer", 3, 26.1, 26.2, (28.0, 29.0)),
    ]
    assert read("train.backward_idle_share", raw) == pytest.approx(30.0)
    assert read("train.optimizer_idle_share", raw) == pytest.approx(100.0)
    raw["trace"] = None
    assert read("train.backward_idle_share", raw) is None


def test_write_ms_is_the_mean_of_the_windows_files(program):
    program["spans"], raw = _window()
    assert read("insitu.write_ms", raw) == pytest.approx(25.0)


def test_write_gb_per_s_is_the_windows_bytes_over_their_seconds(program):
    spans, raw = _window()
    program["spans"] = spans
    # 5e9 bytes in 20 + 30 ms; the files outside the window left out
    assert read("insitu.write_gb_per_s", raw) == pytest.approx(100.0)
    for s in spans:                    # files that carry no byte count
        s["args"].pop("bytes", None)
    assert read("insitu.write_gb_per_s", raw) is None
    assert read("insitu.write_ms", raw) == pytest.approx(25.0)


def test_no_device_intervals_read_nothing_but_the_write(program):
    spans, raw = _window()
    for s in spans:
        s["args"].pop("dev_t0", None)
        s["args"].pop("dev_t1", None)
    program["spans"] = spans
    assert [read(n, raw) for n in DEVICE] == [None] * 5
    assert read("insitu.write_ms", raw) == pytest.approx(25.0)
    assert read("insitu.write_gb_per_s", raw) == pytest.approx(100.0)


def test_missing_inputs_read_none(program, monkeypatch):
    _, raw = _window()
    program["spans"] = None                   # no traced run has finished
    assert [read(n, raw) for n in NEW] == [None] * 7
    program["spans"] = []
    assert [read(n, raw) for n in NEW] == [None] * 7
    spans, _ = _window()
    program["spans"] = spans
    assert read("train.forward_ms", {}) is None          # no window
    from repro_torch import obs
    monkeypatch.delattr(obs, "last_run_spans")          # an older program
    assert [read(n, raw) for n in NEW] == [None] * 7
    monkeypatch.delitem(sys.modules, "repro_torch.obs")  # no program loaded
    assert [read(n, raw) for n in NEW] == [None] * 7


def test_the_benchmark_declares_the_seven_readers():
    doc = spec.benchmark()
    got = {m["name"]: m for m in doc["per_layer"]}
    for name in NEW:
        m = got[name]
        assert m["moves"] == "train_tokens_per_s"
        assert m["workloads"] == ["mamba2-2.7b.insitu_train"]
        assert os.path.exists(os.path.join(spec.HERE, "metrics", f"{name}.py"))
    assert [m["name"] for m in doc["per_layer"]][-7:] == list(NEW)


def test_traced_cpu_run_reads_the_write_and_no_device_metric():
    from test_ibench_harness import TRAIN, measure, tiny

    result = measure(tiny(TRAIN), seconds=1.0, trace=True)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["insitu.write_ms"]["value"] > 0
    assert m["insitu.write_ms"]["unit"] == "ms"
    assert m["insitu.write_gb_per_s"]["value"] > 0
    assert m["insitu.write_gb_per_s"]["unit"] == "GB/s"
    assert not set(DEVICE) & set(m)


def test_clock_check_reports_how_far_each_boundary_lies_inside_an_operation(program):
    """``tools/span_clock_check.py``'s report on the synthetic window: of
    step 9's four phase boundaries in the sub-window, the one after its
    forward (27.15 s) lies 50 ms inside an operation, nearer its start."""
    import importlib.util

    path = os.path.join(ROOT, "tools", "span_clock_check.py")
    spec_ = importlib.util.spec_from_file_location("span_clock_check", path)
    tool = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(tool)
    spans, raw = _window()
    program["spans"] = spans
    raw["window_s"] = 20.0
    raw["trace"] = Trace(26.0, 30.0, [("k", 26.0, 26.1), ("gemm", 27.1, 27.3)])
    got = tool.report(raw, spans)
    b = got["boundaries"]
    assert b["n"] == 4
    assert b["worst_us"] == pytest.approx(5e4)
    assert b["share_within_50us"] == pytest.approx(0.75)
    assert [o[0] for o in b["over_50us"]] == ["train.forward.end"]
    assert b["over_50us"][0][1] > 0                  # nearer the start
    ph = got["phases"]
    assert ph["train.forward"]["device_ms"] == pytest.approx(145.0)
    assert ph["train.forward"]["host_ms"] == pytest.approx(20.0)
    assert got["s_per_step_ms"] == pytest.approx(20e3 / 9)
    assert tool.report(raw, []) is None
