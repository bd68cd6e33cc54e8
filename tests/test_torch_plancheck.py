"""The port's reshard-plan coverage verifier (``repro_torch.analysis.
plancheck``, WLK225 exactly-once coverage and WLK226 bounds) beside the
JAX package's: the twin of ``tests/test_plancheck.py``.

Each case builds the same plan (or the same seeded defect) in both
packages and holds the two verifiers' findings equal; the runtime
fixtures run against the port with their ``repro.`` imports pointed at
``repro_torch.``.  Each reference case has a twin of the same name.
"""

import dataclasses
import os
import re

import pytest

from hypcompat import HAVE_HYPOTHESIS, given, settings, st
from repro.analysis import plancheck as jplancheck
from repro.core import redistribute as jred
from repro_torch.analysis import plancheck
from repro_torch.core.redistribute import CompiledPlan, even_blocks

HERE = os.path.dirname(os.path.abspath(__file__))
RUNDIR = os.path.join(HERE, "analysis_fixtures", "runtime")


def _codes(findings):
    return sorted(d.code for d in findings)


def _rows(findings):
    return [(d.code, d.severity, d.message) for d in findings]


def _transfers(plan):
    return [[dataclasses.astuple(t) for t in d] for d in plan.per_dst]


def _plan(shape, m, n, axis=0):
    return CompiledPlan(even_blocks(shape, m, axis=axis),
                        even_blocks(shape, n, axis=axis), shape)


def _jplan(shape, m, n, axis=0):
    return jred.CompiledPlan(jred.even_blocks(shape, m, axis=axis),
                             jred.even_blocks(shape, n, axis=axis), shape)


def _both(shape, m, n, corrupt, axis=0, **kw):
    """Apply the same corruption to both packages' plans; returns the
    port's findings after holding them equal to the reference's."""
    outs = []
    for make, check in ((_plan, plancheck), (_jplan, jplancheck)):
        plan = make(shape, m, n, axis=axis)
        corrupt(plan)
        outs.append(check.verify_plan(plan, **kw))
    assert _rows(outs[0]) == _rows(outs[1])
    return outs[0]


# ---------------------------------------------------------------------------
# verify_plan: clean plans verify clean
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,m,n,axis", [
    ((12, 8), 3, 2, 0),
    ((12, 8), 2, 5, 0),
    ((7,), 3, 4, 0),
    ((6, 10), 4, 3, 1),
    ((5, 5), 1, 1, 0),
    ((4, 4, 4), 2, 3, 2),
])
def test_planner_output_verifies_clean(shape, m, n, axis):
    plan, jplan = _plan(shape, m, n, axis=axis), _jplan(shape, m, n, axis=axis)
    assert _transfers(plan) == _transfers(jplan) and plan.dst == jplan.dst
    out = plancheck.verify_plan(plan)
    assert not list(out), out.render_text()
    assert not list(jplancheck.verify_plan(jplan))


def test_verify_edge_clean_and_context():
    out = plancheck.verify_edge((12, 8), 0, 3, 2, context="edge a->b")
    assert not list(out)
    assert _rows(out) == _rows(jplancheck.verify_edge((12, 8), 0, 3, 2,
                                                      context="edge a->b"))


# ---------------------------------------------------------------------------
# verify_plan: seeded defects produce the right codes, in both packages
# ---------------------------------------------------------------------------
def test_dropped_transfer_is_a_coverage_hole():
    def drop(plan):
        victim = plan.per_dst[0]
        assert len(victim) > 1, "scenario needs a multi-source dst rank"
        object.__setattr__(plan, "per_dst", (victim[1:],) + plan.per_dst[1:])

    out = _both((12, 8), 3, 2, drop, context="dropped transfer")
    assert "WLK225" in _codes(out)
    assert any("never written" in d.message for d in out)
    assert all(d.message.startswith("dropped transfer: ") for d in out)


def test_duplicated_transfer_is_written_twice():
    def dup(plan):
        d = plan.per_dst[0]
        object.__setattr__(plan, "per_dst", (d + d[:1],) + plan.per_dst[1:])

    out = _both((12, 8), 3, 2, dup)
    assert "WLK225" in _codes(out)
    assert any("written twice" in d.message for d in out)


def test_shifted_transfer_escapes_extent():
    def shift(plan):
        t = plan.per_dst[1][0]
        bad = dataclasses.replace(
            t, global_starts=(plan.shape[0] - t.shape[0] + 1, 0))
        object.__setattr__(plan, "per_dst",
                           (plan.per_dst[0], (bad,) + plan.per_dst[1][1:]))

    out = _both((12, 8), 2, 2, shift)
    assert "WLK226" in _codes(out)
    assert any("out of bounds" in d.message for d in out)


def test_transfer_escaping_its_dst_block_is_flagged():
    def misplace(plan):
        t = plan.per_dst[1][0]
        bad = dataclasses.replace(t, global_starts=(0, 0))
        object.__setattr__(plan, "per_dst",
                           (plan.per_dst[0], (bad,) + plan.per_dst[1][1:]))

    out = _both((12, 8), 2, 2, misplace)
    assert "WLK226" in _codes(out)
    assert any("escapes the destination block" in d.message for d in out)


def test_corrupt_dst_box_is_out_of_bounds():
    def grow(plan):
        (s0, sh0), _ = plan.dst
        object.__setattr__(plan, "dst",
                           ((s0, (sh0[0] + 99, sh0[1])), plan.dst[1]))

    out = _both((12, 8), 2, 2, grow)
    assert "WLK226" in _codes(out)
    assert any("dst rank 0 block" in d.message for d in out)


@pytest.mark.parametrize("axis", [0, 1])
def test_slab_plan_holes_lie_outside_the_slab(axis):
    """Not in the reference: the plan ``TaskComm.reshard`` compiles for a
    received slab maps the slab to every rank of the decomposition, and
    runs only the ranks inside it.  Both verifiers report the other ranks
    as never written, with the same findings; on the ranks that run the
    plan verifies clean."""
    import types

    shape = (16, 12, 4)
    spec = jred.RedistSpec(axis=axis, nslots=2, slot=1, nranks=2)
    dst, slots = spec.dst_boxes(shape)
    slab = (tuple(slots[1][0]), tuple(slots[1][1]))
    plan = CompiledPlan([slab], dst, shape)
    out = plancheck.verify_plan(plan)
    assert _rows(out) == _rows(jplancheck.verify_plan(
        jred.CompiledPlan([slab], dst, shape)))
    assert _codes(out) == ["WLK225", "WLK225"]
    assert all("never written" in d.message for d in out)
    mine = list(spec.my_ranks())
    ran = types.SimpleNamespace(shape=plan.shape, src=plan.src,
                                dst=[plan.dst[r] for r in mine],
                                per_dst=[plan.per_dst[r] for r in mine])
    assert not list(plancheck.verify_plan(ran))


# ---------------------------------------------------------------------------
# the seeded runtime fixtures trigger end to end, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stem,code", [
    ("wlk225_plan_coverage", "WLK225"),
    ("wlk226_plan_bounds", "WLK226"),
])
def test_runtime_fixture_triggers(stem, code):
    path = os.path.join(RUNDIR, stem + ".py")
    with open(path) as f:
        text = f.read()
    ns = {"__name__": "_torch_pc_" + stem}
    exec(compile(re.sub(r"\bfrom repro\.", "from repro_torch.", text),
                 path, "exec"), ns)
    findings = ns["trigger"]()
    assert type(findings).__module__.startswith("repro_torch.")
    assert code in _codes(findings)


# ---------------------------------------------------------------------------
# property: every planner-generated (shape, axis, M, N) edge verifies clean
# ---------------------------------------------------------------------------
@settings(max_examples=80, deadline=None)
@given(st.data())
def test_every_planned_edge_verifies_clean(data):
    ndim = data.draw(st.integers(min_value=1, max_value=3), label="ndim")
    shape = tuple(data.draw(
        st.lists(st.integers(min_value=1, max_value=24),
                 min_size=ndim, max_size=ndim), label="shape"))
    axis = data.draw(st.integers(min_value=0, max_value=ndim - 1),
                     label="axis")
    m = data.draw(st.integers(min_value=1, max_value=8), label="src_nranks")
    n = data.draw(st.integers(min_value=1, max_value=8), label="dst_nranks")
    ctx = f"{shape}/{axis} {m}->{n}"
    out = plancheck.verify_edge(shape, axis, m, n, context=ctx)
    assert not list(out), out.render_text()
    assert not list(jplancheck.verify_edge(shape, axis, m, n, context=ctx))


def test_hypothesis_availability_is_reported():
    assert HAVE_HYPOTHESIS in (True, False)
