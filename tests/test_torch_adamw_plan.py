"""The fused AdamW's host-side plan (``repro_torch.kernels.adamw.make_plan``),
a pure function, checked here without a card: every element of every leaf
covered exactly once by each pass, each launch homogeneous in its dtype
triple, the decay flags those of ``optim.decays``, the norm's finish in
``optim.reference_order``'s order with its groups, and no launch's table
beyond the kernel-parameter limit.  The finish's order is also replayed on
per-leaf sums of squares and held bit for bit to ``optim.global_norm``.
Last, ``chip_smoke.adamw_check``, the card's check of the update against
the plain loop, is rehearsed with the loop on both sides."""

import importlib.util
import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import adamw as fused  # noqa: E402
from repro_torch.models.ssm import MambaLM  # noqa: E402
from repro_torch.train import optim  # noqa: E402

DT = ("float32", "bfloat16")
PARAM_LIMIT = 4096           # bytes of kernel parameters every toolkit takes
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(named, grad_dt=None, state_dt="float32"):
    names = list(named)
    name = lambda t: str(t.dtype).removeprefix("torch.")  # noqa: E731
    leaves = [fused.Leaf(t.numel(), (name(t), grad_dt or name(t), state_dt),
                         optim.decays(n, t)) for n, t in named.items()]
    index = {n: i for i, n in enumerate(names)}
    groups = [[index[n] for n in g] for g in optim.reference_order(names)]
    return names, leaves, groups


def _mixed_tree(n_layers=200):
    """Many layers of leaves of every dtype triple and awkward size: 0, 1,
    odd, a chunk and one past it, several chunks."""
    sizes = [0, 1, 7, 1001, fused.CHUNK, fused.CHUNK + 1, 3 * fused.CHUNK + 5]
    named, triples = {}, {}
    for i in range(n_layers):
        for j, (size, dts) in enumerate(zip(itertools.cycle(sizes),
                                            itertools.product(DT, repeat=3))):
            name = f"layers.{i}.w{j}"
            shape = (size,) if j % 2 else (1, size)
            named[name] = torch.empty(shape, dtype=getattr(torch, dts[0]),
                                      device="meta")
            triples[name] = dts
    named["ln_f.scale"] = torch.empty(9, device="meta")
    triples["ln_f.scale"] = ("float32",) * 3
    names = list(named)
    index = {n: i for i, n in enumerate(names)}
    leaves = [fused.Leaf(t.numel(), triples[n], optim.decays(n, t))
              for n, t in named.items()]
    groups = [[index[n] for n in g] for g in optim.reference_order(names)]
    return names, leaves, groups


def _trees():
    mamba = MambaLM(get_config("mamba2-2.7b"), torch.device("meta"))
    small = MambaLM(get_config("mamba2-2.7b", reduced=True), torch.device("meta"))
    yield "mamba2-2.7b", _leaves(dict(mamba.named_parameters()))
    yield "mamba2-2.7b bf16 moments", _leaves(dict(mamba.named_parameters()),
                                             state_dt="bfloat16")
    yield "mamba2 reduced, float32 accumulated grads", _leaves(
        dict(small.named_parameters()), grad_dt="float32")
    yield "mixed", _mixed_tree()


TREES = dict(_trees())


def _covered(launches, leaves):
    """leaf -> the blocks that cover it, over ``launches``; each launch's
    blocks tile its grid in entry order."""
    seen = {}
    for ln in launches:
        e = ln.entries
        chunks = [-(-int(n) // fused.CHUNK) for n in e["n"]]
        assert list(e["block0"]) == list(np.cumsum([0] + chunks[:-1]))
        assert ln.blocks == sum(chunks) <= fused.MAX_GRID
        for i, n, c in zip(ln.leaves, e["n"], chunks):
            assert n == leaves[i].numel
            assert i not in seen, f"leaf {i} in two launches"
            seen[int(i)] = c
    return seen


@pytest.mark.parametrize("tree", list(TREES))
def test_every_element_is_covered_once_by_each_pass(tree):
    names, leaves, groups = TREES[tree]
    plan = fused.make_plan(leaves, groups)
    for launches in (plan.norm, plan.update):
        seen = _covered(launches, leaves)
        assert set(seen) == {i for i, leaf in enumerate(leaves) if leaf.numel}
        for i, c in seen.items():   # chunks of CHUNK elements, the last ragged
            assert (c - 1) * fused.CHUNK < leaves[i].numel <= c * fused.CHUNK
    # the norm's partials: one per chunk, each slot written once
    slots = np.concatenate([
        np.concatenate([np.arange(int(p0), int(p0) - (-int(n) // fused.CHUNK))
                        for p0, n in zip(ln.entries["partial0"], ln.entries["n"])])
        for ln in plan.norm])
    assert sorted(slots.tolist()) == list(range(plan.partials))


@pytest.mark.parametrize("tree", list(TREES))
def test_each_launch_is_one_dtype_triple_and_decays_as_optim(tree):
    names, leaves, groups = TREES[tree]
    plan = fused.make_plan(leaves, groups)
    for ln in plan.update:
        assert {leaves[i].dtypes for i in ln.leaves} == {ln.dtypes}
        assert [bool(d) for d in ln.entries["decay"]] == \
            [leaves[i].decays for i in ln.leaves]
    for ln in plan.norm:
        assert {leaves[i].dtypes[1] for i in ln.leaves} == {ln.gdt}
    # the flags are optim.decays: a stacked 1-D leaf decays, ln_f does not
    decay = {names[i]: leaves[i].decays for i in range(len(names))}
    assert decay["ln_f.scale"] is False
    assert all(v for n, v in decay.items() if n.startswith("layers."))


@pytest.mark.parametrize("tree", list(TREES))
def test_the_finish_follows_reference_order(tree):
    names, leaves, groups = TREES[tree]
    plan = fused.make_plan(leaves, groups)
    order = [names[i] for ln in plan.finish for i in ln.leaves]
    assert order == [n for g in optim.reference_order(names) for n in g]
    counts = np.concatenate([ln.counts for ln in plan.finish]).astype(np.int64)
    ends = [bool(c & fused.GROUP_END) for c in counts]
    assert ends == [k == len(g) - 1 for g in groups for k in range(len(g))]
    n_partials = counts & ((1 << fused.CLASS_SHIFT) - 1)
    assert n_partials.tolist() == [-(-leaves[i].numel // fused.CHUNK)
                                   for g in groups for i in g]
    assert all(((c >> fused.CLASS_SHIFT) & 7) == 0 for c in counts)
    # partials laid out in that order; each finish starts where it should
    starts = np.concatenate([[0], np.cumsum(n_partials)[:-1]])
    flat = [i for g in groups for i in g]
    partial0 = {int(i): int(p) for ln in plan.norm
                for i, p in zip(ln.leaves, ln.entries["partial0"])}
    for i, s in zip(flat, starts):
        if leaves[i].numel:
            assert partial0[i] == s
    k = 0
    for j, ln in enumerate(plan.finish):
        assert ln.first_partial == starts[k]
        last = j == len(plan.finish) - 1
        assert ln.flags == (j == 0) | (2 if last else 0) | (4 if last else 0)
        k += len(ln.leaves)


@pytest.mark.parametrize("tree", list(TREES))
def test_no_table_exceeds_the_kernel_parameter_limit(tree):
    names, leaves, groups = TREES[tree]
    plan = fused.make_plan(leaves, groups)
    assert fused.NORM_ENTRY.itemsize == 24 and fused.UPDATE_ENTRY.itemsize == 48
    # the tables as csrc/adamw.cu declares them, with the kernels' other
    # parameters: sumsq (table, count, partials), update (table, count,
    # four scalar pointers, six floats), finish (counts, first partial,
    # count, partials, stats, flags, clip)
    assert fused.MAX_NORM * 24 + 8 + 8 <= PARAM_LIMIT
    assert fused.MAX_UPDATE * 48 + 8 + 4 * 8 + 6 * 4 <= PARAM_LIMIT
    assert fused.MAX_FINISH * 4 + 8 + 8 + 2 * 8 + 2 * 4 <= PARAM_LIMIT
    assert all(len(ln.entries) <= fused.MAX_NORM for ln in plan.norm)
    assert all(len(ln.entries) <= fused.MAX_UPDATE for ln in plan.update)
    assert all(len(ln.counts) <= fused.MAX_FINISH for ln in plan.finish)


def test_mamba2_updates_in_at_most_16_launches():
    """The benchmark's model: 578-579 leaves in bf16 and float32, a few
    launches of each kernel, one finish."""
    for tree in ("mamba2-2.7b", "mamba2-2.7b bf16 moments"):
        n = fused.launches(fused.make_plan(*TREES[tree][1:]))
        assert n["adamw_finish"] == 1 and sum(n.values()) <= 16, n
    # a longer table takes more launches of each, the finish carrying over
    n = fused.launches(fused.make_plan(*TREES["mixed"][1:]))
    assert n["adamw_finish"] == 2 and n["adamw_update"] > 8


def test_classes_split_groups_and_leave_the_norm_to_the_host():
    leaves = [fused.Leaf(10, ("float32",) * 3, True, c) for c in (0, 0, 1, 1, 0)]
    plan = fused.make_plan(leaves, [[0, 1, 2], [3, 4]], finalize=False)
    (ln,) = plan.finish
    assert [(int(c) >> fused.CLASS_SHIFT) & 7 for c in ln.counts] == [0, 0, 1, 1, 0]
    assert [bool(int(c) & fused.GROUP_END) for c in ln.counts] == \
        [False, True, True, True, True]
    assert ln.flags == 3
    with pytest.raises(ValueError, match="one class"):
        fused.make_plan(leaves, [[0, 1, 2], [3, 4]])


@pytest.mark.parametrize("bad", [
    ([fused.Leaf(4, ("float16", "float32", "float32"), True)], [[0]]),
    ([fused.Leaf(4, ("float32",) * 3, True)], [[0, 0]]),
    ([fused.Leaf(4, ("float32",) * 3, True, 9)], [[0]]),
    ([], []),
])
def test_the_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        fused.make_plan(*bad, finalize=False)


def _replay_finish(plan, sums):
    """The finish kernel's order on per-leaf float32 sums: leaves into their
    group, groups into the total."""
    total, group, open_ = torch.zeros((), dtype=torch.float32), None, False
    for ln in plan.finish:
        for i, c in zip(ln.leaves, ln.counts):
            group = group + sums[i] if open_ else sums[i]
            open_ = True
            if int(c) & fused.GROUP_END:
                total, open_ = total + group, False
    return torch.sqrt(total)


def test_the_finish_order_is_global_norms():
    g = torch.Generator().manual_seed(3)
    model = MambaLM(get_config("mamba2-2.7b", reduced=True), torch.device("cpu"))
    grads = {n: torch.randn(p.shape, generator=g).to(p.dtype) * (1 + i % 5)
             for i, (n, p) in enumerate(model.named_parameters())}
    names, leaves, groups = _leaves(grads)
    plan = fused.make_plan(leaves, groups)
    sums = [torch.sum(torch.square(grads[n].float())) for n in names]
    got, want = _replay_finish(plan, sums), optim.global_norm(grads)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_cpu_tensors_keep_the_plain_loop():
    g = torch.Generator().manual_seed(5)
    model = MambaLM(get_config("mamba2-2.7b", reduced=True), torch.device("cpu"))
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1)
    named = dict(model.named_parameters())
    with torch.no_grad():
        for p in named.values():
            p.copy_(torch.randn(p.shape, generator=g))
    grads = {n: torch.randn(p.shape, generator=g).to(p.dtype)
             for n, p in named.items()}
    twin = {n: p.detach().clone() for n, p in named.items()}
    s1, s2 = optim.adamw_init(named, cfg), optim.adamw_init(twin, cfg)
    _, _, m1 = optim.adamw_update(model, grads, s1, cfg)
    _, _, m2 = optim.adamw_update_plain(twin, grads, s2, cfg)
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for n, p in named.items():
        assert torch.equal(p.detach(), twin[n])
        assert torch.equal(s1.m[n], s2.m[n]) and torch.equal(s1.v[n], s2.v[n])


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("fault", [None, "clip_on", "clip_off", "bf16_step"])
def test_the_smoke_check_holds_the_update_to_the_plain_loop(monkeypatch, fault):
    """``chip_smoke.adamw_check``, which holds the fused update to the loop
    at mamba2-2.7b's leaves on the card, rehearsed on the CPU with the
    loop on both sides: it passes them equal and names a fault planted on
    the fused side (a float32 leaf moved with clipping on, or off; a bf16
    leaf moved two rounding steps)."""
    smoke = _smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    plain = optim.adamw_update_plain

    def fused_side(params, grads, state, cfg):
        out = plain(params, grads, state, cfg)
        if fault == "bf16_step" and cfg.grad_clip:
            w = params["layers.0.w"]
            w.view(-1)[0] = w.view(-1)[0].float() * (1 + 2**-6)
        elif fault == ("clip_on" if cfg.grad_clip else "clip_off"):
            params["layers.0.scale"].add_(1e-3)
        return out

    monkeypatch.setattr(optim, "adamw_update", fused_side)
    g = torch.Generator().manual_seed(6)
    params = {"layers.0.w": torch.randn(64, 32, generator=g).bfloat16(),
              "layers.0.scale": torch.randn(32, generator=g),
              "ln_f.scale": torch.randn(32, generator=g)}
    grads = {n: torch.randn(t.shape, generator=g).to(t.dtype) for n, t in params.items()}
    cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=10, grad_clip=1.0)
    report, problems, state, _ = smoke.adamw_check(
        params, grads, optim.adamw_init(params, cfg), cfg)
    assert int(state.step) == 2
    check = report["check"]
    if fault is None:
        assert problems == [] and report["max_share_of_limit"] == 0.0
        assert check["clip_off_mismatched_elements"] == 0
    elif fault == "clip_on":
        assert report["max_share_of_limit"] > 1 and len(problems) == 1
        assert problems[0].startswith("float32 at")
    elif fault == "clip_off":
        assert report["max_share_of_limit"] == 0.0
        assert check["clip_off_mismatched_elements"] == 32 and len(problems) == 1
    else:
        assert check["bf16_beyond_one_step"] == ["p layers.0.w"]
        assert check["clip_off_mismatched_elements"] == 0
