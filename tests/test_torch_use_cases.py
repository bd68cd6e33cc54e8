"""The two use cases of ``examples/nucleation_ensemble.py`` and
``examples/cosmology_scheduler.py`` through both packages: each port
example's workflow YAML is the reference's, byte for byte, and the same
seeded data driven through it by ``repro.core.Wilkins`` and
``repro_torch.core.Wilkins`` reaches every consumer instance as the same
bytes (``torch_twins``).

* The ensemble, N = 3: every ``freeze`` instance writes positions made
  with numpy from (seed, instance, t); each detector instance must
  receive its own instance's positions, byte-equal across packages, and
  count the same nucleated atoms with the port's ``diamond_detector`` as
  with the JAX one.  No pair of atoms in the seed's snapshots lies within
  1e-4 of the cutoff, so equal counts are not luck.
* The scheduler: each consumer's slab per snapshot is byte-equal across
  packages, both consumers analyse every snapshot, and reeber's final
  autotuned prefetch depth lies in [1, 4] in both.  Its redistribution
  counters are compared per slab: both edges ask for the same slab of a
  step, and the second normally takes the first's filtered payload from
  the fan-out cache (``Channel._prepare``), but when their prefetches run
  at once both miss it and the step's slab is planned twice.  Both
  packages do this, as often as the thread timing makes them
  (``test_scheduler_fanout_cache_race_in_both_packages`` forces it).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_twins import (COPY_COUNTERS, assert_same,  # noqa: E402
                         assert_same_deliveries, run_both)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

N = 3                 # ensemble instances
ATOMS, STEPS, SEED = 64, 5, 12
GRID, SNAPSHOTS = 32, 12
# counted once for each slab a channel filters
REDIST = ("redist_planned_bytes", "redist_shipped_bytes",
          "redist_baseline_bytes", "redist_aligned", "redist_slabs")


def _example(name, argv=()):
    spec = importlib.util.spec_from_file_location(
        "_use_case_" + name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    old = sys.argv
    sys.argv = [name, *argv]      # the reference reads argv at import
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = old
    return mod


def _positions(instance, t):
    return np.random.default_rng((SEED, instance, t)).random(
        (ATOMS, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the nucleation ensemble
# ---------------------------------------------------------------------------
def test_seed_keeps_every_pair_off_the_cutoff():
    gap = 1.0
    iu = np.triu_indices(ATOMS, 1)
    for i in range(N):
        for t in range(STEPS):
            p = _positions(i, t)
            d = p[:, None] - p[None]
            r = np.sqrt((d * d).sum(-1))[iu]
            gap = min(gap, float(np.abs(r - 0.25).min()))
    assert gap > 1e-4, gap


def _ensemble(s, yaml):
    def freeze(comm):
        for t in range(STEPS):
            if comm.is_io_proc():
                with s.h5.File("dump-h5md.h5", "w") as f:
                    ds = f.create_dataset("/particles/pos",
                                          data=s.data(_positions(comm.instance, t)))
                    ds.attrs["timestep"] = t
                    ds.attrs["instance"] = comm.instance

    def detector(comm):
        f = s.h5.File("dump-h5md.h5", "r")
        if f is None:
            return
        ds = f["/particles/pos"]
        assert ds.attrs["instance"] == comm.instance
        s.record(("detector", comm.instance, int(ds.attrs["instance"]),
                  int(ds.attrs["timestep"])), ds)

    return s.wilkins(yaml, {"freeze": freeze, "detector": detector}).run(
        timeout=120)


def test_nucleation_ensemble_matches_jax():
    port = _example("torch_nucleation_ensemble")
    ref = _example("nucleation_ensemble", [str(N)])
    yaml = port.workflow(N)
    assert yaml == ref.WORKFLOW
    t, j = run_both(_ensemble, yaml)
    assert sorted((i, ts) for (_, i, _, ts) in t.side.got) == \
        [(i, ts) for i in range(N) for ts in range(STEPS)]
    assert_same(t, j)
    counts = []
    for (_, inst, _, ts), (dt, shape, raw) in sorted(t.side.got.items()):
        pos = np.frombuffer(raw, dt).reshape(shape)
        np.testing.assert_array_equal(pos, _positions(inst, ts))
        n = int(port.diamond_detector(torch.from_numpy(pos.copy())))
        assert n == int(ref.diamond_detector(ref.jnp.asarray(pos)))
        counts.append(n)
    assert max(counts) > 0          # the detector has something to count


def test_nucleation_dynamics_match_jax_without_the_kicks():
    """``md_step`` at zero temperature is the deterministic repulsion in
    both packages (their random kicks come from different generators): the
    port's update is the reference's to float32 rounding."""
    port = _example("torch_nucleation_ensemble")
    ref = _example("nucleation_ensemble", [str(N)])
    pos = _positions(0, 0)
    gen = torch.Generator().manual_seed(SEED)
    got = port.md_step(torch.from_numpy(pos.copy()), gen, 0.0).numpy()
    want = np.asarray(ref.md_step(ref.jnp.asarray(pos),
                                  ref.jax.random.PRNGKey(SEED), 0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        port.relax(torch.from_numpy(pos.copy())).numpy(), got)


# ---------------------------------------------------------------------------
# the adaptive scheduler
# ---------------------------------------------------------------------------
def _field(t):
    return np.random.default_rng((SEED, t)).random(
        (GRID, GRID * GRID)).astype(np.float32) * 2


def _scheduler(s, yaml):
    import time

    def nyx():
        for t in range(SNAPSHOTS):
            with s.h5.File(f"plt{t:05d}.h5", "w") as f:
                f.attrs["step"] = t
                f.create_dataset("/level_0/density", data=s.data(_field(t)))

    def consumer(task, slow):
        def body():
            while True:
                f = s.h5.File("plt*.h5", "r")
                if f is None:
                    break
                time.sleep(slow)
                s.record((task, 0, 0, int(f.attrs["step"])),
                         f["/level_0/density"])
        return body

    return s.wilkins(yaml, {"nyx": nyx, "reeber": consumer("reeber", 0.02),
                            "spectrum": consumer("spectrum", 0.0)}).run(
        timeout=120)


def test_cosmology_scheduler_matches_jax():
    port = _example("torch_cosmology_scheduler")
    ref = _example("cosmology_scheduler")
    assert port.WORKFLOW == ref.WORKFLOW
    t, j = run_both(_scheduler, port.WORKFLOW)
    for run in (t, j):
        got = run.side.got
        for task in ("reeber", "spectrum"):
            assert sorted(k[3] for k in got if k[0] == task) == \
                list(range(SNAPSHOTS))
        depths = run.report.scheduler["depths"]
        (edge,) = [e for e in depths if "reeber" in e]
        assert 1 <= depths[edge] <= 4
        assert run.report.scheduler["policy"] == "fair"
    _assert_same_net_of_refilters(t, j)
    for (task, _, _, ts), (dt, shape, raw) in t.side.got.items():
        np.testing.assert_array_equal(
            np.frombuffer(raw, dt).reshape(shape), _field(ts))


def _net(run, k):
    """Counter ``k`` as if every step's slab had been filtered once."""
    n = run.stats["redist_slabs"]
    assert run.stats[k] * SNAPSHOTS % n == 0, (k, run.stats[k], n)
    return run.stats[k] * SNAPSHOTS // n


def _assert_same_net_of_refilters(t, j):
    """Deliveries, report totals and every other counter equal; the
    redistribution counters equal per slab, with each step's slab filtered
    once by the first edge and at most once more by the second (a lost
    fan-out cache race), and no prefetch cancelled; the plan cache's
    distinct plans equal, and its calls (one per filter) net of the
    repeats."""
    assert_same_deliveries(t, j)
    assert t.report.total_served == j.report.total_served
    assert t.report.total_bytes_moved == j.report.total_bytes_moved
    for k in COPY_COUNTERS:
        if k not in REDIST:
            assert t.stats[k] == j.stats[k], (k, t.stats[k], j.stats[k])
    assert t.plans["size"] == j.plans["size"]
    calls = [r.plans["hits"] + r.plans["misses"] - r.stats["redist_slabs"]
             for r in (t, j)]
    assert calls[0] == calls[1], calls
    for run in (t, j):
        assert SNAPSHOTS <= run.stats["redist_slabs"] <= 2 * SNAPSHOTS
        assert run.stats["prefetch_cancelled"] == 0
        assert _net(run, "redist_planned_bytes") == \
            _net(run, "redist_shipped_bytes") == SNAPSHOTS * _field(0).nbytes
    for k in REDIST:
        assert _net(t, k) == _net(j, k), (k, t.stats[k], j.stats[k])


def test_scheduler_fanout_cache_race_in_both_packages(monkeypatch):
    """A slow filter keeps both edges' preparations of a step running at
    once: in both packages the second edge misses the fan-out cache and
    plans the step's slab again, and what reaches each consumer, the
    reports and the counters net of the repeats stay equal."""
    import time

    from repro.core import channel as jch
    from repro_torch.core import channel as tch

    for mod in (jch, tch):
        def slow(self, f, _filter=mod.Channel.filter_file):
            time.sleep(0.03)
            return _filter(self, f)
        monkeypatch.setattr(mod.Channel, "filter_file", slow)
    port = _example("torch_cosmology_scheduler")
    t, j = run_both(_scheduler, port.WORKFLOW)
    for run in (t, j):
        assert run.stats["redist_slabs"] > SNAPSHOTS   # the race was lost
    _assert_same_net_of_refilters(t, j)


def test_cosmology_analyses_match_jax():
    """The halo count and the density update on the same field: the port's
    functions against the reference's jitted ones."""
    port = _example("torch_cosmology_scheduler")
    ref = _example("cosmology_scheduler")
    rho = _field(3).reshape(GRID, GRID, GRID)
    assert int(port.find_halos(torch.from_numpy(rho.copy()))) == \
        int(ref.find_halos(ref.jnp.asarray(rho)))
    assert float(port.mean_density(torch.from_numpy(rho.copy()))) == \
        pytest.approx(float(np.asarray(rho, np.float64).mean()), rel=1e-6)
