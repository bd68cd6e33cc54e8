"""The harness driven on the CPU at tiny sizes, the look for a card skipped
(``run.measure`` with a CPU device): a sound run of each cell is correct;
the same run with the timed path broken underneath is not, once for each
fault the cell can have; the control (the reference in the precision below
the configuration's, in the program's place) reads above the program; and
a cell and a metric added as files alone are found and run."""

import json
import os
import shutil
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from insitu_bench import run  # noqa: E402
from insitu_bench.lib import spec  # noqa: E402

TRAIN = "mamba2-2.7b.insitu_train"
SEED = 2**33 + 12345          # beyond 32 bits, as a run's seed may be


def shrink(config, traffic):
    """A Mamba-2 configuration and traffic cut, in place, to a 2-layer model
    of width 64 over 64 tokens, which the CPU runs in a second."""
    config.update(d_model=64, n_layer=2)
    config["mamba2_defaults"].update(d_state=16, headdim=16, chunk_size=32)
    config["run"]["vocab"] = 256
    traffic.update(seq=64, eval_seq=64, token_vocab=250)


def tiny(name, root=spec.ROOT, bench_dir=spec.HERE):
    cell = spec.load_cell(name, root, bench_dir)
    shrink(cell.config, cell.traffic)
    return cell


def measure(cell, seconds=0.5, trace=False, seed=SEED):
    return run.measure(cell, seed, seconds, trace, torch.device("cpu"), time.monotonic())


def checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.mark.parametrize("name", [TRAIN])
def test_sound_run_is_correct(name):
    result = measure(tiny(name))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    ends = {m["name"] for m in spec.load_cell(name).end_to_end}
    assert set(result["metrics"]) == ends
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_traced_train_run_reads_its_layers():
    result = measure(tiny(TRAIN), seconds=1.0, trace=True)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["insitu.snapshot_ms"]["value"] > 0
    assert "ssd_roofline" not in m and "train.mfu" not in m   # no card: no peaks
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(result["end_to_end_traced"]) == {"train_tokens_per_s", "setup_s"}


# ----------------------------------------------------------- faults, train
def _train_fault(monkeypatch, kind):
    import repro_torch.train.trainer as trainer
    from repro_torch.core.datamodel import Dataset

    real_update, real_family = trainer.adamw_update, trainer.get_family
    if kind == "unchanged":
        def update(model, grads, opt, cfg):
            zero = torch.zeros(())
            return dict(model.named_parameters()), opt, {"lr": zero, "grad_norm": zero}
        monkeypatch.setattr(trainer, "adamw_update", update)
    elif kind == "half_batch":
        def family(cfg):
            fam = real_family(cfg)
            half = lambda model, c, b: fam.loss_fn(  # noqa: E731
                model, c, {k: v[: v.shape[0] // 2] for k, v in b.items()})
            return type(fam)(**{**fam.__dict__, "loss_fn": half})
        monkeypatch.setattr(trainer, "get_family", family)
    elif kind == "altered":
        def update(model, grads, opt, cfg):
            name = next(iter(grads))
            grads = {**grads, name: torch.zeros_like(grads[name])}
            return real_update(model, grads, opt, cfg)
        monkeypatch.setattr(trainer, "adamw_update", update)
    else:  # a snapshot altered in transit
        real_get = Dataset.__getitem__

        def get(self, key):
            out = real_get(self, key)
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                out = out.clone()
                out.view(-1)[0] += 1.0
            return out
        monkeypatch.setattr(Dataset, "__getitem__", get)


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered", "snapshot"])
def test_train_fault_is_not_correct(monkeypatch, kind):
    _train_fault(monkeypatch, kind)
    result = measure(tiny(TRAIN))
    assert not result["correct"], result["checks"]


def test_train_control_fails():
    """The reference in float8 in the program's place reads at least three
    times what the sound program reads, at this size, on one of the cell's
    numbers (at the cell's size it fails the cell's limits: PERF.md); the
    zeroed gradient reads as a leaf that never moved."""
    from insitu_bench.controls.train_control import readings

    rows = readings(tiny(TRAIN), SEED, torch.device("cpu"))
    got = {**rows[0], **rows[1]}
    assert [r["variant"] for r in rows] == ["control", "control", "half_batch", "zero_grad"]
    result = measure(tiny(TRAIN))
    program = {**checks(result), "eval_loss_gap": result["readings"]["eval_loss_gap"]}
    assert any(got[k] > 3 * program[k] for k in ("grad_gap", "change_gap", "eval_loss_gap")), \
        (got, program)
    assert rows[3]["grad_gap"] == 1.0 and rows[3]["change_gap"] > 0.9


# ------------------------------------------------- added by files alone
def test_cell_and_metric_added_as_files_alone(tmp_path):
    """A copy of the benchmark with one more configuration, traffic mix,
    cell and metric, each a new file and an entry in BENCHMARK.json: the
    harness finds and runs them with no other edit."""
    bench = tmp_path / "insitu_bench"
    shutil.copytree(spec.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads(open(os.path.join(spec.ROOT, "BENCHMARK.json")).read())
    cfg = json.loads((bench / "configs" / "mamba2-2.7b.json").read_text())
    traffic = json.loads((bench / "traffic" / "insitu_train.json").read_text())
    shrink(cfg, traffic)
    cfg["name"] = "mamba2-tiny"
    traffic.update(snapshot_every=2)
    (bench / "configs" / "mamba2-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "insitu_train.eval2.json").write_text(json.dumps(traffic))
    wl = json.loads((bench / "workloads" / f"{TRAIN}.json").read_text())
    wl.update(config="mamba2-tiny", traffic="insitu_train.eval2", why="a smaller model")
    (bench / "workloads" / "mamba2-tiny.insitu_train.eval2.json").write_text(json.dumps(wl))
    (bench / "metrics" / "steps_per_s.py").write_text(
        "def read(raw):\n    return raw['steps'] / raw['window_s']\n")
    doc["configs"].append({"name": "mamba2-tiny", "source": "test", "file": "x",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "mamba2-tiny.insitu_train.eval2",
                             "config": "mamba2-tiny", "traffic": "insitu_train.eval2",
                             "chips": 1, "why": "test"})
    doc["end_to_end"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["mamba2-tiny.insitu_train.eval2"]})
    for m in doc["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("mamba2-tiny.insitu_train.eval2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.load_cell("mamba2-tiny.insitu_train.eval2", str(tmp_path), str(bench))
    assert cell.traffic["snapshot_every"] == 2 and cell.config["d_model"] == 64
    result = measure(cell)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s", "steps_per_s"}
    assert result["metrics"]["steps_per_s"]["value"] > 0
