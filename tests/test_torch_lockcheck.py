"""The port's core under the runtime lock recorder, as the reference's CI
runs its own (``WILKINS_LOCKCHECK=1`` over ``test_rescale``,
``test_recovery`` and ``test_scheduler``, ``-m "not slow"``).

The port's three twin files run in a fresh pytest process with the flag
set, so every lock either package's core builds is a checked wrapper.  A
plugin loaded into that process writes both recorders' state at session
end: the port's registry (``repro_torch.analysis.lockcheck.registry()``)
must hold no finding -- no lock-order cycle, rank inversion or blocking
call under a fine-grained lock -- and the lock-order edges the port's
core recorded must be the ones the reference's recorded over the same
workflows.  ``tests/conftest.py`` fails that session on the reference's
own findings, so its exit code holds the reference too."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["tests/test_torch_rescale.py", "tests/test_torch_recovery.py",
         "tests/test_torch_scheduler.py"]

PLUGIN = '''
import json
import os


def pytest_sessionfinish(session, exitstatus):
    from repro.analysis.lockcheck import registry as jregistry
    from repro_torch.analysis.lockcheck import registry

    reg, jreg = registry(), jregistry()
    with open(os.environ["WILKINS_LOCKCHECK_DUMP"], "w") as f:
        json.dump({"errors": [str(d) for d in reg.findings().errors()],
                   "findings": len(reg.findings()),
                   "edges": sorted(map(list, reg.edges)),
                   "jax_edges": sorted(map(list, jreg.edges))}, f)
'''


def test_port_core_records_no_finding_and_the_reference_lock_order(tmp_path):
    (tmp_path / "lockdump.py").write_text(PLUGIN)
    dump = tmp_path / "lockcheck.json"
    # the checker's own switches come from here only: a WILKINS_EXPLORE=1
    # left in this process (the explore CLI sets it in-process) would hand
    # out the explorer's locks, which record no edges
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "COV_", "WILKINS_"))}
    env.update(WILKINS_LOCKCHECK="1", WILKINS_LOCKCHECK_DUMP=str(dump),
               PYTHONPATH=os.pathsep.join(
                   [str(tmp_path), os.path.join(ROOT, "src")]
                   + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x", "-m", "not slow",
         "-p", "lockdump", "-p", "no:cacheprovider",
         "--basetemp", str(tmp_path / "inner")] + FILES,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-3000:])
    got = json.loads(dump.read_text())
    assert got["findings"] == 0 and got["errors"] == [], got["errors"]
    edges = {tuple(e) for e in got["edges"]}
    assert edges and edges == {tuple(e) for e in got["jax_edges"]}, (
        sorted(edges), got["jax_edges"])
