"""The port stands alone: importing all of ``repro_torch`` loads no JAX, no
``ml_dtypes`` and nothing of the JAX package, and its entry points do not
fall back to the CPU on their own."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_every_port_module_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    expected = {
        "repro_torch.convert",
        "repro_torch.analysis.diagnostics", "repro_torch.analysis.lockcheck",
        "repro_torch.analysis.rules", "repro_torch.analysis.workflow",
        "repro_torch.analysis.plancheck", "repro_torch.analysis.astlint",
        "repro_torch.analysis.cli", "repro_torch.analysis.__main__",
        "repro_torch.analysis.explore", "repro_torch.analysis.explore.control",
        "repro_torch.analysis.explore.instrument",
        "repro_torch.analysis.explore.scenarios",
        "repro_torch.parallel", "repro_torch.parallel.sharding",
        "repro_torch.launch.mesh", "repro_torch.models.moe_a2a",
        "repro_torch.obs.recorder", "repro_torch.obs.critical",
        "repro_torch.obs.export",
        "repro_torch.kernels.pack", "repro_torch.kernels.ops",
        "repro_torch.kernels.ref", "repro_torch.kernels.build",
        "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
        "repro_torch.models.config", "repro_torch.models.layers",
        "repro_torch.models.transformer", "repro_torch.models.ssm",
        "repro_torch.models.registry",
        "repro_torch.serve", "repro_torch.serve.engine",
        "repro_torch.launch", "repro_torch.launch.serve",
        "repro_torch.launch.train", "repro_torch.launch.hlo",
        "repro_torch.launch.specs", "repro_torch.launch.dryrun",
        "repro_torch.configs",
        "repro_torch.train", "repro_torch.train.checkpoint",
        "repro_torch.train.data", "repro_torch.train.optim",
        "repro_torch.train.trainer",
        "repro_torch.obs.__main__",
    } | {f"repro_torch.core.{m}" for m in (
        "scheduler", "datamodel", "redistribute", "comm", "recovery",
        "channel", "vol", "h5", "actions", "graph", "driver", "rescale")} | {
        f"repro_torch.configs.{m}" for m in (
            "arctic_480b", "deepseek_coder_33b", "internvl2_76b", "llama32_3b",
            "mamba2_2_7b", "phi35_moe", "phi3_mini", "tinyllama_1_1b",
            "whisper_base", "zamba2_2_7b")}
    assert expected <= set(res["modules"])


_FIXTURE_PROBE = """
import glob, importlib.util, json, os, sys
paths = sorted(glob.glob(os.path.join(sys.argv[1], "wlk*.py")))
for p in paths:
    spec = importlib.util.spec_from_file_location(
        "_race_" + os.path.basename(p)[:-3], p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(json.dumps({"fixtures": [os.path.basename(p) for p in paths], "bad": bad}))
"""


def test_port_race_fixtures_load_no_jax_or_reference():
    """The explorer's seeded races for the port import the port only."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    races = os.path.join(os.path.dirname(__file__), "analysis_fixtures",
                         "races_torch")
    out = subprocess.run([sys.executable, "-c", _FIXTURE_PROBE, races], env=env,
                         check=True, capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["fixtures"] == [
        "wlk320_tensor_view.py", "wlk320_torn_capture.py",
        "wlk320_torn_stats.py", "wlk321_lock_order.py",
        "wlk322_notify_outside_lock.py", "wlk323_missed_epoch_dedup.py"]


_RESTORE_PROBE = """
import json, sys
import repro_torch.core
before = set(sys.modules)
import repro_torch.train.checkpoint
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def test_restore_imports_only_the_checkpoint_module():
    """A task's first ``restore`` imports ``repro_torch.train.checkpoint``
    inside the stall watchdog's window: it must bring nothing else of the
    package (the JAX package's brings its trainer; ROADMAP Queue 3)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _RESTORE_PROBE], env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120)
    new = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in new if m.startswith("repro_torch")] == \
        ["repro_torch.train", "repro_torch.train.checkpoint"]


_BLOCKED_CLI = """
import importlib.abc, runpy, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
sys.argv = ["python -m repro_torch.analysis"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.analysis", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    print("RC", e.code)
"""


@pytest.mark.parametrize("argv", [
    ["check", "examples/torch_quickstart.py"],
    ["lint"],
])
def test_analysis_cli_runs_with_jax_and_reference_unimportable(argv):
    """``python -m repro_torch.analysis check|lint`` in a fresh interpreter
    whose import system refuses ``jax``, ``ml_dtypes`` and ``repro``."""
    repo = os.path.abspath(os.path.join(SRC, ".."))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CLI, *argv], env=env,
                         cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "RC 0", out.stdout + out.stderr
    assert "no findings" in lines


def test_explore_cli_runs_with_jax_and_reference_unimportable():
    """``python -m repro_torch.analysis explore --device cpu`` in a fresh
    interpreter that refuses ``jax``, ``ml_dtypes`` and ``repro``."""
    repo = os.path.abspath(os.path.join(SRC, ".."))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    argv = ["explore", "--device", "cpu", "--scenario", "latest_fanin"]
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CLI, *argv], env=env,
                         cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "RC 0", out.stdout + out.stderr
    assert lines[0].startswith("latest_fanin") and lines[0].endswith("clean")


def test_explorer_and_mesh_default_to_cuda_and_never_fall_back():
    """The explorer's payloads and the host mesh are on the card unless the
    caller asks for the CPU; without CUDA they raise."""
    from repro_torch.analysis.explore import build_scenario
    from repro_torch.launch.mesh import make_host_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scenario("rendezvous_depth1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(("data", "model"))


_MESH_OVER_GLOO = """
import torch, torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    make_host_mesh(("data", "model"))
except RuntimeError as e:
    print("RAISED", e)
else:
    print("BUILT", torch.cuda.is_available())
finally:
    dist.destroy_process_group()
"""


def test_cuda_mesh_over_a_running_gloo_group_raises():
    """A running gloo group does not make the default (``"cuda"``) host mesh
    fall back to the CPU: without a card it raises for want of CUDA, and
    with one for the gloo backend."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _MESH_OVER_GLOO], env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120)
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("RAISED"), last
    assert ("CUDA is not available" in last
            or "over a running 'gloo' group" in last), last


def test_port_sources_name_no_jax_import():
    root = os.path.dirname(repro_torch.__file__)
    for mod in pkgutil.walk_packages([root], "repro_torch."):
        path = mod.module_finder.find_spec(mod.name.rsplit(".", 1)[-1]).origin
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    assert "jax" not in s and "ml_dtypes" not in s, (path, s)
                    assert not s.startswith(("import repro.", "from repro.",
                                             "from repro ", "import repro ")), (path, s)


_YAML = """
tasks:
  - func: a
    outports: [{filename: o.h5, dsets: [{name: /g, memory: 1}]}]
  - func: b
    inports: [{filename: o.h5, dsets: [{name: /g, memory: 1}]}]
"""


def test_wilkins_defaults_to_cuda_and_never_falls_back_to_cpu():
    from repro_torch.core import Wilkins

    funcs = {"a": lambda: None, "b": lambda: None}
    if torch.cuda.is_available():
        w = Wilkins(_YAML, funcs)
        assert all(g == [torch.device("cuda", 0)] for g in w.device_groups.values())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Wilkins(_YAML, funcs)
    w = Wilkins(_YAML, funcs, devices=[torch.device("cpu")])
    assert all(g == [torch.device("cpu")] for g in w.device_groups.values())


def test_explorer_flag_raises_until_the_explorer_is_ported(monkeypatch):
    """The explorer is ported: under the flag the factories hand out its
    cooperative primitives (the name is kept from when they raised)."""
    from repro_torch.analysis import lockcheck
    from repro_torch.analysis.explore import instrument

    monkeypatch.setenv("WILKINS_EXPLORE", "1")
    for make, cls in ((lockcheck.make_lock, instrument.ExploreLock),
                      (lockcheck.make_condition, instrument.ExploreCondition),
                      (lockcheck.make_semaphore, instrument.ExploreSemaphore)):
        assert isinstance(make("leaf:x"), cls)
    monkeypatch.delenv("WILKINS_EXPLORE")
    assert not isinstance(lockcheck.make_lock("leaf:x"), instrument.ExploreLock)


_RESCALE_YAML = """
tasks:
  - func: a
    outports: [{filename: o.h5, dsets: [{name: /g, memory: 1}]}]
  - func: b
    taskCount: 2
    inports: [{filename: o.h5, redistribute: 1, dsets: [{name: /g, memory: 1}]}]
    on_failure: {rescale: {nslots: 1}}
"""


def test_policy_rescale_2_to_1_completes(tmp_path):
    """A crashed instance of a two-instance consumer brings the task back
    at one instance, which gets every step's whole field as a tensor."""
    from repro_torch.core import FaultSpec, Wilkins, h5, world

    cpu = torch.device("cpu")
    got = {}

    def a():
        for t in range(3):
            with h5.File("o.h5", "w") as f:
                f.create_dataset("/g", data=torch.full((6,), float(t)), copy=False)

    def b():
        comm = world()
        sizes = []
        while True:
            f = h5.File("o.h5", "r")
            if f is None:
                break
            slab = f["/g"][...]
            assert isinstance(slab, torch.Tensor)
            sizes.append(slab.numel())
        got[comm.instance] = sizes

    w = Wilkins(_RESCALE_YAML, {"a": a, "b": b}, devices=[cpu],
                spill_dir=str(tmp_path))
    rep = w.run(timeout=60, faults=FaultSpec(task="b", point="recv", step=1,
                                             instance=0))
    assert [(e["old_nslots"], e["new_nslots"], e["trigger"])
            for e in rep.rescales] == [(2, 1, "policy")]
    assert w.graph.tasks["b"].task_count == 1
    assert w.device_groups[("b", 0)] == [cpu]
    assert got == {0: [6, 6, 6]}  # no checkpoint: every step replayed whole
