"""The port's examples run to their end on the CPU (``--device cpu``), their
own asserts included: halo counts identical to a crash-free run after
restarts, a drop, a policy rescale and a watchdog rescale, a traced run
that exports all six span layers, a trainer coupled in situ to an
evaluator whose held-out loss must not diverge, an NxN nucleation
ensemble whose detectors each see every snapshot of their own instance,
and the fair-scheduled cosmology workflow whose two consumers analyse
every snapshot -- the last two at the reference examples' sizes."""

import os
import runpy
import sys

import pytest

pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.mark.parametrize("name", [
    "torch_quickstart", "torch_cosmology_flowcontrol",
    "torch_cosmology_faulttolerant", "torch_cosmology_elastic",
    "torch_cosmology_traced", "torch_train_insitu_eval",
    "torch_nucleation_ensemble", "torch_cosmology_scheduler"])
def test_example_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    argv = [name, "--device", "cpu"]
    if name == "torch_cosmology_traced":
        argv += ["--trace", str(tmp_path / "trace.json")]
    if name == "torch_train_insitu_eval":  # the demo model, two evaluations
        argv += ["--steps", "20"]
    if name == "torch_cosmology_scheduler":
        argv += ["--timeline", str(tmp_path / "timeline.json")]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "wall_time_s=" in out


def test_insitu_evaluator_loads_the_trainers_bytes():
    """``torch_train_insitu_eval.run`` on the CPU: every snapshot the
    evaluator scored holds, tensor for tensor, the bytes of the copy the
    trainer took when it wrote it (the step updates the weights in place
    right after the write), and each snapshot written was either scored or
    dropped by ``latest`` flow control."""
    import importlib.util

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        "_insitu_eval", os.path.join(EXAMPLES, "torch_train_insitu_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    a = torch.arange(6, dtype=torch.float32)
    b = a.clone()
    assert mod._same_bits(a, b)
    b[3] = float(np.nextafter(np.float32(3), np.float32(4)))
    assert not mod._same_bits(a, b)          # one ulp apart is not the same
    assert not mod._same_bits(torch.zeros(1), -torch.zeros(1))
    report, evals, snaps = mod.run("demo", steps=30, device="cpu",
                                   log=lambda *_: None)
    assert snaps["written"] == [10, 20, 30] and snaps["steps"] == 30
    assert evals and sorted(snaps["equal"]) == [s for s, _ in evals]
    assert all(snaps["equal"].values())
    assert report.total_dropped == len(snaps["written"]) - len(evals)
