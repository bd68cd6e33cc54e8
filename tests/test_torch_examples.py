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
