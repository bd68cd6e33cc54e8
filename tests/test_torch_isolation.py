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
        "repro_torch.analysis.rules",
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
        "repro_torch.configs",
    } | {f"repro_torch.core.{m}" for m in (
        "scheduler", "datamodel", "redistribute", "comm", "recovery",
        "channel", "vol", "h5", "actions", "graph", "driver")} | {
        f"repro_torch.configs.{m}" for m in (
            "arctic_480b", "deepseek_coder_33b", "internvl2_76b", "llama32_3b",
            "mamba2_2_7b", "phi35_moe", "phi3_mini", "tinyllama_1_1b",
            "whisper_base", "zamba2_2_7b")}
    assert expected <= set(res["modules"])


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
    from repro_torch.analysis import lockcheck

    monkeypatch.setenv("WILKINS_EXPLORE", "1")
    for make in (lockcheck.make_lock, lockcheck.make_condition,
                 lockcheck.make_semaphore):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            make("leaf:x")
    monkeypatch.delenv("WILKINS_EXPLORE")
    assert lockcheck.make_lock("leaf:x") is not None


def test_rescale_is_not_yet_ported():
    from repro_torch.core import Wilkins

    w = Wilkins(_YAML, {"a": lambda: None, "b": lambda: None},
                devices=[torch.device("cpu")])
    with pytest.raises(NotImplementedError, match="rescale"):
        w._execute_rescale(None)
