"""``tools/alloc_probe.py`` without a card: its wrappers count the
allocator's counters around the driver's ``trainer.step`` and
``trainer.snapshot`` spans and around the ssm family's loss inside a step
only (not the evaluator's), time a snapshot's ``h5`` close, keep every
host span, and its report sums and medians them."""

import dataclasses
import importlib.util
import os
import threading
import types

import pytest

pytest.importorskip("torch")

from insitu_bench.lib import host  # noqa: E402
from repro_torch.core import h5  # noqa: E402
from repro_torch.models import registry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "_alloc_probe", os.path.join(REPO, "tools", "alloc_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Event:
    def __init__(self, **kwargs):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 2.5


def _fake_torch():
    """Each read of the allocator has made one more ``cudaMalloc``."""
    reads = {"n": 0}

    def memory_stats():
        reads["n"] += 1
        return {"num_device_alloc": reads["n"], "reserved_bytes.all.current": 7}

    return types.SimpleNamespace(cuda=types.SimpleNamespace(
        memory_stats=memory_stats, Event=_Event, synchronize=lambda: None,
        max_memory_reserved=lambda: 9))


def test_the_probe_counts_steps_snapshots_and_the_trainers_losses(monkeypatch):
    mod = _probe_module()
    losses = []
    fam = dataclasses.replace(registry._FAMILIES["ssm"],
                              loss_fn=lambda *a: losses.append(a) or 1.0)
    monkeypatch.setitem(registry._FAMILIES, "ssm", fam)
    monkeypatch.setattr(host.HostSpans, "span", host.HostSpans.span)
    monkeypatch.setattr(h5._H5File, "close", lambda self: None)
    probe = mod.Probe(_fake_torch())
    mod.install(probe)
    loss_fn = registry._FAMILIES["ssm"].loss_fn
    spans = host.HostSpans(False)
    for _ in range(2):
        with spans.span("trainer.step"):
            assert loss_fn("model", "cfg", "batch") == 1.0
    with spans.span("trainer.snapshot"):
        loss_fn("model", "cfg", "batch")        # not in a step: not a forward
        h5._H5File.close(None)
    with spans.span("evaluator.score"):
        loss_fn("model", "cfg", "batch")
    scorer = threading.Thread(target=loss_fn, args=("model", "cfg", "held"))
    with spans.span("trainer.step"):            # another thread's loss
        scorer.start()
        scorer.join()
    out = probe.report()
    assert len(losses) == 5
    assert [out[k]["n"] for k in ("forward", "step", "snapshot")] == [2, 3, 1]
    # one read on entry and one on exit: one cudaMalloc an event, and a step
    # that holds a forward sees the forward's two reads besides
    assert out["forward"]["sums"]["num_device_alloc"] == 2
    assert out["step"]["sums"]["num_device_alloc"] == 3 + 2 * 2
    assert out["forward"]["device_ms_median"] == 2.5
    assert out["step"]["device_ms_median"] is None
    assert out["snapshot"]["at_entry_median"]["reserved_bytes.all.current"] == 7
    assert out["run"]["num_device_alloc"] == 12    # 12 reads in events, then the last
    assert out["peak_reserved_bytes"] == 9
    assert out["snapshot"]["events"][0]["close_ms"] >= 0
    assert out["step"]["events"][0]["close_ms"] is None
    assert [s[0] for s in out["spans"]] == ["trainer.step"] * 2 + [
        "trainer.snapshot", "evaluator.score", "trainer.step"]
