"""The port's AdamW (``repro_torch.train.optim``) against the JAX package's
``repro.train.optim`` on the same numbers.

The parameter trees are the reference's, stacked over two layers, and the
port's, the same leaves cut per layer (``layers.<i>.<name>``), so the
weight-decay rule (rank of the *reference* leaf) and the global norm's
order (the reference's flatten order) are both exercised: a stacked 1-D
layer leaf must be decayed, the final norm's scale must not.  Tolerances:
1e-6 relative for parameters and moments over 5 steps, the learning rate
within 1e-6 relative (float32) at every step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optim as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.train import optim  # noqa: E402

STEPS = 5
TOL = 1e-6


def _tree(rng):
    """The reference's stacked tree: 2 layers of a matrix and a 1-D scale,
    an embedding matrix and a final 1-D scale."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"embed": {"tok": f(16, 8)},
            "layers": {"attn": {"wq": f(2, 8, 8)},
                       "ln1": {"scale": f(2, 8)}},
            "ln_f": {"scale": f(8)}}


def _named(tree):
    """The port's flat, per-layer tree of the same leaves."""
    return {n: torch.from_numpy(np.ascontiguousarray(a))
            for n, a in convert._unstack(tree).items()}


def _jax_params(tree, dtype):
    """The matrices in the parameter dtype, the scales float32 (as in the
    models)."""
    mat = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return {"embed": {"tok": mat(tree["embed"]["tok"])},
            "layers": {"attn": {"wq": mat(tree["layers"]["attn"]["wq"])},
                       "ln1": {"scale": jnp.asarray(tree["layers"]["ln1"]["scale"])}},
            "ln_f": {"scale": jnp.asarray(tree["ln_f"]["scale"])}}


def _port(jtree):
    """A JAX tree as the port's per-layer tensors (bfloat16 by its bits)."""
    return {n: convert.tensor_from_numpy(a, "cpu")
            for n, a in convert._unstack(jax.tree.map(np.asarray, jtree)).items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_over_five_steps(param_dtype, state_dtype):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jparams = _jax_params(tree, jnp.dtype(param_dtype))
    params = _port(jparams)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    jstate, tstate = jopt.adamw_init(jparams, jcfg), optim.adamw_init(params, tcfg)
    jupd = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jcfg))
    for step in range(STEPS):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32),
                             tree)
        jgrads = jax.tree.map(lambda g, p: jnp.asarray(g, p.dtype), grads, jparams)
        tgrads = _port(jgrads)
        jparams, jstate, jm = jupd(jparams, jgrads, jstate)
        params, tstate, tm = optim.adamw_update(params, tgrads, tstate, tcfg)
        assert int(tstate.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=TOL)
        for what, jt, tt in (("params", jparams, params), ("m", jstate.m, tstate.m),
                             ("v", jstate.v, tstate.v)):
            back = convert._stack(tt)
            for (path, want), got in zip(
                    jax.tree_util.tree_flatten_with_path(jt)[0],
                    jax.tree.leaves(back)):
                assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
                assert _rel(got.float().numpy(), want) <= TOL, (what, path, step)


def test_cosine_lr_matches_jax_at_every_step():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    for s in range(0, 45):
        got = optim.cosine_lr(tcfg, torch.tensor(s, dtype=torch.int32))
        want = jopt.cosine_lr(jcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=TOL, err_msg=str(s))


def test_decay_follows_the_reference_leaf_rank():
    """Zero gradients, weight decay 1: every per-layer leaf (the 1-D ones
    too, stacked to rank 2 in the reference) is decayed; ``ln_f`` is not."""
    named = {"layers.0.ln1.scale": torch.ones(4), "layers.1.ln1.scale": torch.ones(4),
             "layers.0.mamba.A_log": torch.ones(4), "ln_f.scale": torch.ones(4),
             "embed.tok": torch.ones(4, 4)}
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=1.0, grad_clip=0)
    st = optim.adamw_init(named, cfg)
    new, _, _ = optim.adamw_update(named, {n: torch.zeros_like(p)
                                           for n, p in named.items()}, st, cfg)
    for n, p in new.items():
        assert (float(p.flatten()[0]) < 1.0) == (n != "ln_f.scale"), n
    # the same rule as the JAX package on its stacked tree
    jparams = {"layers": {"ln1": {"scale": jnp.ones((2, 4))}},
               "ln_f": {"scale": jnp.ones((4,))}}
    jnew, _, _ = jopt.adamw_update(jparams, jax.tree.map(jnp.zeros_like, jparams),
                                   jopt.adamw_init(jparams, jopt.AdamWConfig()),
                                   jopt.AdamWConfig(lr=0.1, weight_decay=1.0,
                                                    grad_clip=0))
    assert float(jnew["layers"]["ln1"]["scale"][0, 0]) < 1.0
    assert float(jnew["ln_f"]["scale"][0]) == 1.0


def test_global_norm_adds_leaves_in_the_reference_order():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    named = _named(tree)
    groups = optim.reference_order(named)
    assert groups == [["embed.tok"], ["layers.0.attn.wq", "layers.1.attn.wq"],
                      ["layers.0.ln1.scale", "layers.1.ln1.scale"], ["ln_f.scale"]]
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(optim.global_norm(named)), float(want), rtol=TOL)
    clipped, n = optim.clip_by_global_norm(named, 1.0)
    jclipped, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    np.testing.assert_allclose(float(n), float(jn), rtol=TOL)
    for name, a in convert._unstack(jax.tree.map(np.asarray, jclipped)).items():
        np.testing.assert_allclose(clipped[name].numpy(), a, rtol=TOL, atol=1e-9)
