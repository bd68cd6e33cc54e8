"""The port's example workflows against the JAX package's, on the
reference's own inputs and sizes: each twin's ``run`` beside the reference
example's own task functions and workflow, on the CPU.

* quickstart (Listing 1, N = 1,000,000, 5 timesteps): consumer1's total of
  grid[0], and consumer2's particle means (float64) within 1e-6 relative
  -- the twin draws its particles with the reference's
  ``np.random.default_rng(t)``;
* faulttolerant, elastic, traced: the halo cells of every snapshot, equal,
  crash-free and under each example's faults -- each twin starts from the
  reference's uniform float64 field;
* flowcontrol: the snapshots reeber analysed, and the served and dropped
  (skipped by ``io_freq``) counts, equal.  The fields differ (the twin's
  noise is a ``torch.Generator``'s, the reference's ``jax.random``'s), so
  the halo counts are not compared.

The reference examples print what they compute, so their module-level
``print`` is replaced by a recorder; where the reference keeps a count
local (the traced example's reeber), its ``comm.reshard`` is wrapped to
count the halo cells of the blocks it returns.  Before the twins took the
reference's field they started from ``1.0 + 0.05 * randn`` under a
``torch.Generator`` seeded 0: ``test_the_seeded_field_gives_other_counts``
shows that this field computes another workload.  Every workflow keeps
its checkpoints under the test's ``tmp_path``: the reference's default
directory is a fixed per-pid path that ignores ``TMPDIR``.
"""

import functools
import importlib.util
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
# the reference's checkpointer imports this module (and with it JAX) at a
# run's first checkpoint; seconds of import inside the elastic example's
# 0.3 s stall window would make its watchdog rescale a crash-free run
import repro.train.checkpoint  # noqa: E402,F401

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
CPU = "cpu"


def _load(name, tmp_path):
    """The example ``name``, its workflows keeping their checkpoints under
    ``tmp_path / name`` rather than each package's default per-pid
    directory."""
    spec = importlib.util.spec_from_file_location(
        f"_conformance_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.Wilkins = functools.partial(mod.Wilkins, spill_dir=str(tmp_path / name))
    return mod


def _printed(mod):
    """Replace ``mod``'s ``print`` with a recorder; returns its lines."""
    lines = []
    mod.print = lambda *a, **kw: lines.append(" ".join(map(str, a)))
    return lines


def _seeded(grid):
    """The field the twins started from before they took the reference's."""
    g = torch.Generator(device="cpu").manual_seed(0)
    return 1.0 + 0.05 * torch.randn((grid,) * 3, generator=g,
                                    dtype=torch.float64)


# ---------------------------------------------------------------- quickstart
def test_quickstart_matches_the_reference(tmp_path):
    ref, twin = _load("quickstart", tmp_path), _load("torch_quickstart", tmp_path)
    lines = _printed(ref)
    means = []

    def consumer2():
        """The reference's consumer2, keeping the mean it prints rounded,
        taken in float64 as the twin takes it: numpy's float32 mean along
        axis 0 adds the million rows one by one, 6.9e-6 relative off the
        exact mean of timestep 0's particles."""
        f = jcore.h5.File("outfile.h5", "r")
        if f is None:
            return
        parts = f["/group1/particles"][:]
        means.append(np.asarray(parts).mean(axis=0, dtype=np.float64))

    ref.Wilkins(ref.WORKFLOW, {"producer": ref.producer,
                               "consumer1": ref.consumer1,
                               "consumer2": consumer2}).run(timeout=120)
    total = [int(s.rsplit("=", 1)[1]) for s in lines if "[consumer1]" in s]
    out = twin.run(CPU)
    assert total == [out["total"]] == [10]
    assert len(means) == len(out["means"]) == twin.STEPS
    for want, got in zip(means, out["means"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert all(out["shared"]) and len(out["shared"]) == 2 * twin.STEPS
    assert out["stats"]["bytes_copied"] == 0


# ------------------------------------------------- the checkpointing examples
def _faulttolerant_reference(ref, faults):
    lines = _printed(ref)
    report = ref.Wilkins(ref.WORKFLOW, {"nyx": ref.nyx, "reeber": ref.reeber,
                                        "viz": ref.viz}).run(
        timeout=300, faults=faults)
    got = [s for s in lines if s.startswith("[reeber] halo cells")]
    return report, [int(x) for x in got[-1].split("[", 2)[2].strip("]").split(",")]


@pytest.mark.parametrize("faulted", [False, True], ids=["crash_free", "faulted"])
def test_faulttolerant_counts_match_the_reference(faulted, tmp_path):
    ref = _load("cosmology_faulttolerant", tmp_path)
    twin = _load("torch_cosmology_faulttolerant", tmp_path)
    faults = [jcore.FaultSpec(task=f.task, point=f.point, step=f.step)
              for f in twin.FAULTS] if faulted else None
    jrep, want = _faulttolerant_reference(ref, faults)
    rep, got = twin.run(CPU, faults=twin.FAULTS if faulted else None)
    assert got == want and len(got) == twin.SNAPSHOTS
    assert len(set(got)) > 1          # the threshold splits the snapshots
    assert sorted(r["task"] for r in rep.restarts) == \
        sorted(r["task"] for r in jrep.restarts) == (
            ["nyx", "reeber"] if faulted else [])
    assert rep.dropped_tasks == jrep.dropped_tasks


@pytest.mark.parametrize("run", ["crash_free", "crash", "stall"])
def test_elastic_counts_match_the_reference(run, tmp_path):
    ref = _load("cosmology_elastic", tmp_path)
    twin = _load("torch_cosmology_elastic", tmp_path)
    _printed(ref)
    fault = twin.FAULTS.get(run)
    jfault = None if fault is None else jcore.FaultSpec(
        task=fault.task, kind=fault.kind, point=fault.point, step=fault.step,
        instance=fault.instance, seconds=fault.seconds)
    jrep, want = ref.run(run, faults=jfault)
    rep, got = twin.run(run, CPU, faults=fault)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert len(set(got.sum(axis=0).tolist())) > 1
    assert [(e["old_nslots"], e["new_nslots"], e["trigger"]) for e in rep.rescales] \
        == [(e["old_nslots"], e["new_nslots"], e["trigger"]) for e in jrep.rescales] \
        == ([] if fault is None else [(2, 1, "policy" if run == "crash" else "stall")])


def _traced_reference(ref, faults):
    """The reference's traced workflow; returns (report, halo cells per
    snapshot summed over reeber's instances)."""
    lock = threading.Lock()
    calls = {}

    def reeber(comm):
        real = type(comm).reshard.__get__(comm)

        def counted(x, *a, **kw):
            blocks = real(x, *a, **kw)
            with lock:
                calls.setdefault(comm.instance, []).append(
                    int(sum((np.asarray(b) > 1.01).sum() for b in blocks)))
            return blocks
        comm.reshard = counted
        return ref.reeber(comm)

    report = ref.Wilkins(ref.WORKFLOW, {"nyx": ref.nyx, "reeber": reeber}).run(
        timeout=300, faults=faults)
    assert sorted(calls) == [0, 1]
    assert all(len(c) == ref.SNAPSHOTS for c in calls.values()), calls
    return report, [sum(c[t] for c in calls.values())
                    for t in range(ref.SNAPSHOTS)]


@pytest.mark.parametrize("faulted", [False, True], ids=["crash_free", "faulted"])
def test_traced_counts_match_the_reference(faulted, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)       # the reference traces into ./trace.json
    ref = _load("cosmology_traced", tmp_path)
    twin = _load("torch_cosmology_traced", tmp_path)
    f = twin.FAULT
    jfaults = jcore.FaultSpec(task=f.task, point=f.point, step=f.step,
                              instance=f.instance) if faulted else None
    jrep, want = _traced_reference(ref, jfaults)
    trace = str(tmp_path / "torch_trace.json")
    rep, got, blocks = twin.run(CPU, faults=f if faulted else None, trace=trace)
    assert got == want and len(set(got)) > 1
    assert blocks == 2 * 2 * twin.SNAPSHOTS     # 2 instances x 2 ranks
    assert len(rep.restarts) == len(jrep.restarts) == int(faulted)
    if faulted:
        twin.accept(rep, trace)


# -------------------------------------------------------------- flow control
def test_flowcontrol_serves_and_analyses_as_the_reference(tmp_path):
    ref = _load("cosmology_flowcontrol", tmp_path)
    twin = _load("torch_cosmology_flowcontrol", tmp_path)
    lines = _printed(ref)
    d = tmp_path / "ref_actions"
    d.mkdir()
    (d / "nyx_actions.py").write_text(ref.ACTION_SCRIPT)
    w = ref.Wilkins(ref.WORKFLOW, {"nyx": ref.nyx, "reeber": ref.reeber},
                    action_dirs=[str(d)])
    jrep = w.run(timeout=300)
    want = sorted(int(s.split("plt", 1)[1][:5]) for s in lines
                  if s.startswith("[reeber] plt"))
    analysed, rep, broadcasts = twin.run(CPU)
    assert sorted(analysed) == want == list(range(1, twin.SNAPSHOTS, 2))
    assert (rep.total_served, rep.total_dropped) == \
        (jrep.total_served, jrep.total_dropped) == (5, 5)
    # the action script served each snapshot at its second close only
    assert broadcasts == w.vols[("nyx", 0)]._broadcast_log
    assert len(broadcasts) == twin.SNAPSHOTS
    assert all(shape == (twin.GRID,) * 3 and shared
               for _, _, shape, shared in analysed.values())


# ------------------------------------------------------ the old seeded field
@pytest.mark.parametrize("name", ["faulttolerant", "elastic", "traced"])
def test_the_seeded_field_gives_other_counts(name, tmp_path):
    """The twins' old start, a seeded ``1.0 + 0.05 * randn`` field, gives
    other halo counts than the reference's uniform field, which they now
    take by default."""
    twin = _load(f"torch_cosmology_{name}", tmp_path)
    kw = {"faults": None}
    if name == "elastic":
        kw.update(tag=name)
    uniform = twin.run(device=CPU, **kw)[1]
    seeded = twin.run(device=CPU, rho0=_seeded(twin.GRID), **kw)[1]
    uniform, seeded = np.asarray(uniform), np.asarray(seeded)
    assert uniform.shape == seeded.shape
    assert not np.array_equal(uniform, seeded)


def test_the_packages_keep_their_checkpoints_apart(tmp_path):
    """Both packages number their drivers from 1 and key each run's
    checkpoints by (driver, run) under the spill directory, so the port's
    default spill directory must not be the reference's: in one process
    the port's first faulted fault-tolerant run otherwise restored the
    reference's finished checkpoints ("attempt 0: resumed after 8
    snapshots"), and no fault fired."""
    import repro_torch.core as tcore

    ft = _load("torch_cosmology_faulttolerant", tmp_path)
    funcs = {"nyx": lambda: None, "reeber": lambda: None, "viz": lambda: None}
    j = jcore.Wilkins(ft.WORKFLOW, funcs)
    t = tcore.Wilkins(ft.WORKFLOW, funcs, devices=[torch.device("cpu")])
    assert os.path.realpath(j.spill_dir) != os.path.realpath(t.spill_dir)
