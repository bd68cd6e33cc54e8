"""The port's schedule explorer (``repro_torch.analysis.explore``) beside
the JAX package's: the twin of ``tests/test_explore.py``.

Every reference case has a twin of the same name here, run on the port
with the port's copies of the seeded races
(``tests/analysis_fixtures/races_torch/``) and its scenarios' payloads on
the CPU.  On top of the twins:

* the same corpus under both packages' explorers gives equal (schedules,
  pruned, steps, codes, schedule IDs), each package in a fresh interpreter
  with ``WILKINS_EXPLORE=1`` set before its core is imported (the
  module-level locks are then explore primitives too, as in the CLI).  The
  counts depend on the payload in both packages: a host array copied into
  the file (the JAX package's corpus) takes the transport-stats lock at
  the copy and the share lock at each read, a device buffer adopted in
  place (the port's corpus) takes neither.  So the port with host copies
  is held to the JAX package's CLI, and the port as shipped (tensors
  adopted in place) to the JAX package's corpus with ``jax.Array``
  payloads adopted in place;
* each of the five copied races is found with the reference's schedule ID;
* the tensor-view race (``wlk320_tensor_view``) is found with the
  storage-keyed ``_buffer_key`` and missed with the key the port first
  copied from the JAX package, which gives a tensor view a key of its own.
"""

import functools
import glob
import importlib.util
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.explore import explore as jexplore  # noqa: E402
from repro_torch.analysis import lockcheck  # noqa: E402
from repro_torch.analysis.cli import main as cli_main  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
RACEDIR = os.path.join(HERE, "analysis_fixtures", "races_torch")
REF_RACEDIR = os.path.join(HERE, "analysis_fixtures", "races")
RACE_FIXTURES = sorted(glob.glob(os.path.join(RACEDIR, "wlk*.py")))
COPIED = sorted(os.path.basename(p)
                for p in glob.glob(os.path.join(REF_RACEDIR, "wlk*.py")))
CPU = torch.device("cpu")


@pytest.fixture
def explore_on(monkeypatch):
    monkeypatch.setenv("WILKINS_EXPLORE", "1")
    monkeypatch.delenv("WILKINS_LOCKCHECK", raising=False)


def _load(path):
    name = "_race_" + os.path.basename(os.path.dirname(path)) + "_" + \
        os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _codes(findings):
    return {d.code for d in findings}


# ---------------------------------------------------------------------------
# clean corpus: bounded exploration, zero findings
# ---------------------------------------------------------------------------
def _corpus_names():
    from repro_torch.analysis.explore import names
    return names()


@pytest.mark.parametrize("name", _corpus_names())
def test_clean_scenario_explores_without_findings(explore_on, name):
    from repro_torch.analysis.explore import build_scenario, explore
    rep = explore(build_scenario(name, CPU), scenario=name, max_schedules=4000)
    assert not rep.found, "\n" + rep.findings.render_text()
    assert rep.schedules > 1, "exploration degenerated to one schedule"
    assert rep.complete, f"{name} did not exhaust {rep.schedules} schedules"


def test_build_scenario_binds_the_device():
    from repro_torch.analysis.explore import build_scenario
    assert build_scenario("cow_share", "cpu").args == (CPU,)
    with pytest.raises(KeyError, match="unknown scenario"):
        build_scenario("nope", CPU)


# ---------------------------------------------------------------------------
# seeded races: every historical bug is re-found within budget
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", RACE_FIXTURES,
                         ids=lambda p: os.path.basename(p))
def test_race_fixture_found_within_budget(explore_on, path):
    from repro_torch.analysis.explore import explore, replay
    mod = _load(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    rep = explore(mod.build, scenario=stem, max_schedules=mod.BUDGET)
    assert rep.found, (f"{stem}: seeded bug not found in {rep.schedules} "
                       f"schedules (budget {mod.BUDGET})")
    assert mod.CODE in _codes(rep.findings), \
        f"{stem}: expected {mod.CODE}, got {sorted(_codes(rep.findings))}"
    assert rep.schedule_id, "finding carries no replayable schedule ID"
    assert rep.schedule_id.startswith(stem + "@")

    # the schedule ID replays the same finding, deterministically
    first = replay(mod.build, rep.schedule_id)
    again = replay(mod.build, rep.schedule_id)
    assert mod.CODE in _codes(first.findings), \
        f"replay lost the finding: {sorted(_codes(first.findings))}"
    assert sorted(d.code for d in first.findings) == \
        sorted(d.code for d in again.findings)
    assert first.decisions == again.decisions


@pytest.mark.parametrize("path", RACE_FIXTURES,
                         ids=lambda p: os.path.basename(p))
def test_race_fixture_discovery_is_deterministic(explore_on, path):
    from repro_torch.analysis.explore import explore
    mod = _load(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    a = explore(mod.build, scenario=stem, max_schedules=mod.BUDGET)
    b = explore(mod.build, scenario=stem, max_schedules=mod.BUDGET)
    assert a.schedule_id == b.schedule_id
    assert a.schedules == b.schedules


@pytest.mark.parametrize("fixture", COPIED)
def test_copied_race_matches_the_references_schedule_id(explore_on, fixture):
    from repro_torch.analysis.explore import explore
    stem = os.path.splitext(fixture)[0]
    ref = _load(os.path.join(REF_RACEDIR, fixture))
    mod = _load(os.path.join(RACEDIR, fixture))
    assert (mod.CODE, mod.BUDGET) == (ref.CODE, ref.BUDGET)
    want = jexplore(ref.build, scenario=stem, max_schedules=ref.BUDGET)
    got = explore(mod.build, scenario=stem, max_schedules=mod.BUDGET)
    assert (got.schedule_id, got.schedules, sorted(_codes(got.findings))) == \
        (want.schedule_id, want.schedules, sorted(_codes(want.findings)))


def test_race_finding_carries_both_stacks(explore_on):
    from repro_torch.analysis.explore import explore
    mod = _load(os.path.join(RACEDIR, "wlk320_torn_stats.py"))
    rep = explore(mod.build, scenario="torn_stats", max_schedules=16)
    (d,) = [d for d in rep.findings if d.code == "WLK320"]
    # the message names both racing threads and where each accessed
    assert "producer" in d.message and "drainer" in d.message
    assert "wlk320_torn_stats" in d.message


# ---------------------------------------------------------------------------
# the tensor-view race and the storage key
# ---------------------------------------------------------------------------
def _id_keyed_buffer_key(arr):
    """``_buffer_key`` as first copied from the JAX package: walks an
    ndarray's ``.base`` chain and falls back to ``id()`` for anything
    without ``__array_interface__`` -- every tensor view then has a key of
    its own."""
    base = arr
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    try:
        return base.__array_interface__["data"][0]
    except (AttributeError, TypeError, KeyError):
        return id(base)


def test_buffer_key_is_the_storage_of_a_tensor():
    from repro_torch.core.datamodel import _buffer_key
    t = torch.arange(16.)
    assert _buffer_key(t) == _buffer_key(t[4:8]) == _buffer_key(t.view(4, 4))
    assert _buffer_key(t) != _buffer_key(t.clone())
    assert _id_keyed_buffer_key(t) != _id_keyed_buffer_key(t[4:8])
    a = np.arange(16.)
    assert _buffer_key(a) == _buffer_key(a[4:8]) == _id_keyed_buffer_key(a[4:8])


@pytest.mark.parametrize("key", ["storage", "id"])
@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_tensor_view_race_needs_the_storage_key(explore_on, monkeypatch,
                                                payload, key):
    from repro_torch.analysis.explore import explore
    from repro_torch.core import datamodel
    mod = _load(os.path.join(RACEDIR, "wlk320_tensor_view.py"))
    if key == "id":
        monkeypatch.setattr(datamodel, "_buffer_key", _id_keyed_buffer_key)
    rep = explore(functools.partial(mod.build, payload, CPU),
                  scenario="tensor_view", max_schedules=mod.BUDGET)
    if payload == "tensor" and key == "id":
        # the race goes unseen; the writer's in-place write is caught only
        # later, by the adoption version check at the reader's read
        assert "WLK320" not in _codes(rep.findings)
        assert all("modified in place" in d.message for d in rep.findings)
    else:
        assert _codes(rep.findings) == {"WLK320"}
        assert rep.schedule_id == "tensor_view@s1.0"


# ---------------------------------------------------------------------------
# ResizableSemaphore audit regression
# ---------------------------------------------------------------------------
def _sem_grow_scenario(sem_cls):
    def build():
        sem = sem_cls(1, name="channel.sem:audit")

        def holder():
            assert sem.acquire()
            # holds its slot to the end: only the resize can free the peer

        def blocked():
            assert sem.acquire(), "acquire after grow returned False"
            sem.release()

        def resizer():
            sem.resize(2)

        return [("holder", holder), ("blocked", blocked),
                ("resizer", resizer)]
    return build


def test_semaphore_resize_grow_wakes_waiters(explore_on):
    from repro_torch.analysis.explore import explore
    from repro_torch.core.scheduler import ResizableSemaphore
    rep = explore(_sem_grow_scenario(ResizableSemaphore),
                  scenario="sem_grow", max_schedules=128)
    assert not rep.found, "\n" + rep.findings.render_text()
    assert rep.complete


def test_semaphore_resize_without_notify_is_caught(explore_on):
    from repro_torch.analysis.explore import explore
    from repro_torch.core.scheduler import ResizableSemaphore

    class _SilentGrow(ResizableSemaphore):
        # the exact hazard the audit checked for: growing the limit
        # without waking blocked acquirers
        def resize(self, limit):
            with self._cond:
                self._limit = int(limit)

    rep = explore(_sem_grow_scenario(_SilentGrow),
                  scenario="sem_grow_silent", max_schedules=128)
    assert rep.found, "silent grow was not caught"
    assert "WLK322" in _codes(rep.findings), sorted(_codes(rep.findings))


def test_resizable_semaphore_shrink_races_release_real_threads():
    from repro_torch.core.scheduler import ResizableSemaphore
    sem = ResizableSemaphore(8, name="channel.sem:stress")
    errs = []

    def worker():
        try:
            for _ in range(200):
                assert sem.acquire(timeout=10.0)
                sem.release()
        except BaseException as e:   # noqa: BLE001 -- surface to the test
            errs.append(e)

    def resizer():
        try:
            for limit in (4, 1, 6, 2, 8) * 40:
                sem.resize(limit)
        except BaseException as e:
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    threads.append(threading.Thread(target=resizer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads), "stress run wedged"
    assert not errs, errs
    assert sem.in_use == 0
    assert sem.limit == 8
    assert sem.acquire(timeout=1.0)
    sem.release()


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------
def test_cli_explore_clean_scenario(explore_on, capsys):
    assert cli_main(["explore", "--scenario", "latest_fanin",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "latest_fanin" in out and "clean" in out


def test_cli_explore_list(explore_on, capsys):
    assert cli_main(["explore", "--list"]) == 0
    assert "rendezvous_depth1" in capsys.readouterr().out


def test_cli_explore_json(explore_on, capsys):
    assert cli_main(["explore", "--json", "--scenario", "cow_share",
                     "--budget", "32", "--device", "cpu"]) == 0
    (doc,) = [d for d in json.loads(capsys.readouterr().out)]
    assert doc["scenario"] == "cow_share"
    assert doc["found"] is False


def test_cli_explore_replays_a_schedule(explore_on, capsys):
    assert cli_main(["explore", "--json", "--device", "cpu", "--schedule",
                     "latest_fanin@s1.1"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc == {"scenario": "latest_fanin",
                   "schedule_id": "latest_fanin@s1.1", "found": False,
                   "codes": []}
    assert cli_main(["explore", "--scenario", "cow_share", "--schedule",
                     "latest_fanin@s1.1"]) == 2


# ---------------------------------------------------------------------------
# the same corpus under both packages, each in a fresh interpreter
# ---------------------------------------------------------------------------
_REF_DEVICE_PAYLOADS = """
import json, os, sys
os.environ["WILKINS_EXPLORE"] = "1"
import jax.numpy as jnp
from repro.analysis.explore import explore, names, scenarios
def _mk_file(step):
    from repro.core.datamodel import File
    f = File("out.h5")
    f.create_dataset("/data", data=jnp.full(4, step, dtype=jnp.int32),
                     copy=False)
    return f
scenarios._mk_file = _mk_file
print(json.dumps([explore(scenarios.build_scenario(n), scenario=n).as_dict()
                  for n in names()]))
"""

_PORT_HOST_PAYLOADS = """
import json, os, sys
os.environ["WILKINS_EXPLORE"] = "1"
import numpy as np
from repro_torch.analysis.explore import explore, names, scenarios
def _payloads(device):
    from repro_torch.core.datamodel import File
    def make(step):
        f = File("out.h5")
        f.create_dataset("/data", data=np.full(4, step, dtype=np.int32))
        return f
    return make
scenarios._payloads = _payloads
print(json.dumps([explore(scenarios.build_scenario(n, "cpu"), scenario=n).as_dict()
                  for n in names()]))
"""

_PROBES = {
    "ref_host": ["-m", "repro.analysis", "explore", "--json"],
    "ref_device": ["-c", _REF_DEVICE_PAYLOADS],
    "port_host": ["-c", _PORT_HOST_PAYLOADS],
    "port_device": ["-m", "repro_torch.analysis", "explore", "--json",
                    "--device", "cpu"],
}
_KEYS = ("scenario", "schedules", "pruned", "steps_total", "complete",
         "found", "codes", "schedule_id")


@pytest.fixture(scope="module")
def corpus_runs():
    """The clean corpus at the CLI's budget (256), four ways at once."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WILKINS_EXPLORE", "WILKINS_LOCKCHECK")}
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = {k: subprocess.Popen([sys.executable, *argv], env=env, cwd=REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
             for k, argv in _PROBES.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, (k, stderr[-2000:])
            out[k] = [{key: d[key] for key in _KEYS}
                      for d in json.loads(stdout)]
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    return out


def test_port_core_yields_where_the_reference_does(corpus_runs):
    """Host payloads copied into the file, as in the JAX package's corpus:
    the port reproduces its CLI's counts exactly."""
    assert corpus_runs["port_host"] == corpus_runs["ref_host"]
    assert not any(d["found"] for d in corpus_runs["ref_host"])


def test_cli_explore_device_cpu_matches_the_reference(corpus_runs):
    """``explore --device cpu``: tensors adopted in place give exactly the
    JAX package's counts for ``jax.Array`` payloads adopted in place, and
    the numbers the card's smoke run is gated on."""
    spec = importlib.util.spec_from_file_location(
        "_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert corpus_runs["port_device"] == corpus_runs["ref_device"]
    assert not any(d["found"] for d in corpus_runs["port_device"])
    assert {d["scenario"]: [d["schedules"], d["pruned"], d["steps_total"]]
            for d in corpus_runs["ref_device"]} == smoke.EXPLORE_COUNTS


# ---------------------------------------------------------------------------
# zero-cost contract: WILKINS_EXPLORE unset -> plain primitives, no-ops
# ---------------------------------------------------------------------------
def test_factories_plain_when_explore_unset(monkeypatch):
    monkeypatch.delenv("WILKINS_EXPLORE", raising=False)
    monkeypatch.delenv("WILKINS_LOCKCHECK", raising=False)
    assert isinstance(lockcheck.make_lock("leaf:x"), type(threading.Lock()))
    assert isinstance(lockcheck.make_condition("leaf:x"),
                      threading.Condition)
    assert isinstance(lockcheck.make_semaphore("leaf:x", 2),
                      threading.Semaphore)
    # the hooks are no-ops with no controller installed
    lockcheck.sched_point("noop", key=("x", 0), access="w")
    lockcheck.access_point("noop", ("x", 0), "r")
    lockcheck.hb_publish(("x", 1))
    lockcheck.hb_consume(("x", 1))


def test_explore_primitives_fall_back_off_scenario(explore_on):
    lk = lockcheck.make_lock("leaf:x")
    with lk:
        assert lk.locked()
    assert not lk.locked()
    cv = lockcheck.make_condition("leaf:x")
    with cv:
        assert not cv.wait(timeout=0.01)
    sem = lockcheck.make_semaphore("leaf:x", 1)
    assert sem.acquire()
    sem.release()
