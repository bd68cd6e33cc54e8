"""Training of the port's hybrid, encdec, moe and vlm families against the
JAX package, and the conversions that carry every family between the two.

* ``loss_fn`` and every gradient, at the reduced configs of
  ``zamba2-2.7b``, ``whisper-base``, ``phi3.5-moe-42b-a6.6b``,
  ``arctic-480b`` and ``internvl2-76b``, with ``use_flash`` off and on:
  within 2e-4, the reference's tolerance for one function by two paths
  (``tests/test_archs.py``).
* One ``make_train_step`` step each from the same state: loss,
  ``grad_norm``, ``lr`` and every parameter and moment within ``STEP_TOL``
  (2e-4, elementwise and relative L2 per leaf), so weight decay and the
  global norm follow the reference's ``enc``/``dec`` stacks and its
  unstacked ``shared`` block.
* ``params_to_reference(params_from_reference(tree)) == tree`` bit for bit
  for every arch in bfloat16, and ``train_state_to_reference`` inverting
  ``train_state_from_reference`` for whisper (``enc.``/``dec.``) and
  zamba2 (``shared.``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.registry import get_family as j_get_family  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step  # noqa: E402
from repro_torch.train.optim import decays, reference_key  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=2e-4, rtol=2e-4)
STEP_TOL = 2e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ARCHS = ["zamba2-2.7b", "whisper-base", "phi3.5-moe-42b-a6.6b", "arctic-480b",
         "internvl2-76b"]


def _batch(cfg, seed, b=2, s=40):
    """tokens/labels plus the stub frontends' inputs of vlm/encdec."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.normal(size=(b, cfg.vision_tokens, cfg.d_model))
                                * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(b, cfg.source_len, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close_tree(got, want, what, rel_l2=False):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _close_tree(got[key], want[key], f"{what}.{key}", rel_l2)
            continue
        g = got[key].detach().float().numpy()
        np.testing.assert_allclose(g, np.asarray(want[key], np.float32),
                                   err_msg=f"{what}.{key}", **TOL)
        if rel_l2:
            assert _rel(g, want[key]) <= STEP_TOL, f"{what}.{key}"


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, use_flash):
    """A loss chunk of 16 leaves a ragged last chunk; the MoE configs add
    0.01 x their routers' aux loss, and the vlm takes its loss on the text
    positions only."""
    over = dict(use_flash=use_flash, loss_chunk=16)
    jcfg = j_get_config(arch, reduced=True).replace(**over)
    cfg = get_config(arch, reduced=True).replace(**over)
    jparams = j_get_family(jcfg).init(jax.random.PRNGKey(7), jcfg)
    model = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jparams), CPU)
    host = _batch(cfg, 2)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    want, jgrads = jax.value_and_grad(
        lambda p: j_get_family(jcfg).loss_fn(p, jcfg, jb))(jparams)
    names, params = zip(*model.named_parameters())
    loss = get_family(cfg).loss_fn(model, cfg, {k: torch.as_tensor(v).to(CPU)
                                                for k, v in host.items()})
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    _close_tree(convert._stack(dict(zip(names, grads))), jgrads, "grad")


@pytest.mark.parametrize("arch,use_flash", [
    ("zamba2-2.7b", True), ("whisper-base", True),
    ("phi3.5-moe-42b-a6.6b", False), ("arctic-480b", True),
    ("internvl2-76b", True)])
def test_train_step_matches_jax(arch, use_flash):
    over = dict(use_flash=use_flash, loss_chunk=16)
    jcfg = j_get_config(arch, reduced=True).replace(**over)
    cfg = get_config(arch, reduced=True).replace(**over)
    js = jtrain.init_state(jax.random.PRNGKey(0), jcfg, jtrain.AdamWConfig(**OPT))
    ts = convert.train_state_from_reference(cfg, jax.tree.map(np.asarray, js), CPU)
    host = _batch(cfg, 3, b=4)
    js, jm = jax.jit(jtrain.make_train_step(jcfg, jtrain.AdamWConfig(**OPT)))(
        js, {k: jnp.asarray(v) for k, v in host.items()})
    ts, tm = make_train_step(cfg, AdamWConfig(**OPT))(ts, host)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_TOL,
                                   err_msg=k)
    got = convert.train_state_to_reference(ts)
    for name, g, w in (("params", got.params, js.params),
                       ("m", got.opt.m, js.opt.m), ("v", got.opt.v, js.opt.v)):
        _close_tree(g, w, name, rel_l2=True)
    assert int(got.opt.step) == int(js.opt.step) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_round_trip_bit_exactly(arch):
    """bfloat16 weights (the norms and the router stay float32) cross
    through their bits both ways; the tree's structure is the reference's."""
    cfg = j_get_config(arch, reduced=True).replace(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, j_get_family(cfg).init(jax.random.PRNGKey(4), cfg))
    model = convert.params_from_reference(get_config(arch, reduced=True).replace(
        dtype="bfloat16"), tree, CPU)
    back = convert.params_to_reference(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree.leaves(back)):
        assert (convert.numpy_from_tensor(got).tobytes() == want.tobytes()
                and got.dtype == convert.torch_dtype(want.dtype)), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ["whisper-base", "zamba2-2.7b"])
def test_train_state_round_trips(arch):
    """A JAX ``TrainState`` after one step (non-zero moments) into the
    port and back: the same tree, bit for bit."""
    jcfg = j_get_config(arch, reduced=True)
    js = jtrain.init_state(jax.random.PRNGKey(1), jcfg, jtrain.AdamWConfig(**OPT))
    host = _batch(jcfg, 4)
    js, _ = jax.jit(jtrain.make_train_step(jcfg, jtrain.AdamWConfig(**OPT)))(
        js, {k: jnp.asarray(v) for k, v in host.items()})
    jhost = jax.tree.map(np.asarray, js)
    ts = convert.train_state_from_reference(get_config(arch, reduced=True), jhost, CPU)
    back = convert.train_state_to_reference(ts)     # the port's named tuples
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    want = jax.tree_util.tree_flatten_with_path(jhost)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert any(jax.tree_util.keystr(p).startswith(
        ".params['shared']" if arch == "zamba2-2.7b" else ".opt.m['dec']")
        for p, _ in want)
    for (path, a), (_, b) in zip(got, want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), \
            jax.tree_util.keystr(path)


def test_decay_and_leaves_follow_the_reference_stacks():
    """``enc.<i>``/``dec.<i>`` are slices of stacked leaves (so a per-layer
    norm scale is decayed), ``shared.*`` and ``ln_enc`` are not."""
    one = torch.ones(4)
    assert reference_key("dec.3.ln3.scale") == (("dec", "ln3", "scale"), True)
    assert reference_key("enc.0.attn.wq") == (("enc", "attn", "wq"), True)
    assert reference_key("shared.ln1.scale") == (("shared", "ln1", "scale"), False)
    assert decays("enc.1.ln1.scale", one) and decays("layers.2.ln.scale", one)
    assert not decays("shared.ln2.scale", one) and not decays("ln_enc.scale", one)
    assert decays("shared.attn.wq", torch.ones(4, 4))
