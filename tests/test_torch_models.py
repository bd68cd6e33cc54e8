"""The port's dense and ssm models against the JAX package's on the same
parameters (``convert.params_from_reference``): prefill logits, the filled
caches, and three decode steps with their caches, for reduced
``llama3.2-3b``, ``tinyllama-1.1b`` and ``mamba2-2.7b``, each with
``use_flash`` off (plain attention / SSD) and on (the K3 / K4 path; the
JAX side runs its Pallas kernels in interpret mode).  Tolerance 2e-4, the
reference's own for one function by two paths (``tests/test_archs.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.registry import get_family as j_get_family  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=2e-4, rtol=2e-4)
B, S, MAX_LEN = 2, 40, 64


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what, **TOL)


def _close_cache(got, want, step):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], f"cache {key} after {step}")


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "tinyllama-1.1b",
                                  "mamba2-2.7b"])
def test_prefill_and_decode_match_jax(arch, use_flash):
    jcfg = j_get_config(arch, reduced=True).replace(use_flash=use_flash)
    cfg = get_config(arch, reduced=True).replace(use_flash=use_flash)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})
    jfam, fam = j_get_family(jcfg), get_family(cfg)
    jparams = jfam.init(jax.random.PRNGKey(7), jcfg)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, jparams), CPU)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S), dtype=np.int32)

    jprefill = jax.jit(lambda p, t, c: jfam.prefill(p, jcfg, {"tokens": t}, c))
    jdecode = jax.jit(lambda p, t, c: jfam.decode_step(p, jcfg, t, c))
    jcache = jfam.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32)
    cache = fam.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device=CPU)

    with torch.no_grad():
        jlogits, jcache = jprefill(jparams, jnp.asarray(tokens), jcache)
        logits, cache = fam.prefill(model, cfg,
                                    {"tokens": torch.from_numpy(tokens).long()},
                                    cache)
        _close(logits, jlogits, "prefill logits")
        _close_cache(cache, jcache, "prefill")
        for step in range(3):
            tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1).astype(np.int32)
            tok = tok.reshape(B, 1)
            jlogits, jcache = jdecode(jparams, jnp.asarray(tok), jcache)
            logits, cache = fam.decode_step(model, cfg,
                                            torch.from_numpy(tok).long(), cache)
            _close(logits, jlogits, f"decode {step} logits")
            _close_cache(cache, jcache, f"decode {step}")


def test_params_from_reference_is_a_copy_in_the_reference_layout():
    cfg = get_config("llama3.2-3b", reduced=True)
    jparams = j_get_family(cfg).init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = params_from_reference(cfg, tree, CPU)
    np.testing.assert_array_equal(model.layers[1].attn.wq.detach().numpy(),
                                  tree["layers"]["attn"]["wq"][1])
    np.testing.assert_array_equal(model.embed.out.detach().numpy(),
                                  tree["embed"]["out"])
    tree["layers"]["attn"].pop("wo")
    with pytest.raises(KeyError, match="layers.0.attn.wo"):
        params_from_reference(cfg, tree, CPU)


def test_bf16_params_cross_through_their_bits():
    cfg = get_config("mamba2-2.7b", reduced=True).replace(dtype="bfloat16")
    jparams = j_get_family(cfg).init(jax.random.PRNGKey(1), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = params_from_reference(cfg, tree, CPU)
    w = model.layers[0].mamba.in_proj
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.detach().view(torch.int16).numpy(),
                                  tree["layers"]["mamba"]["in_proj"][0].view(np.int16))


def test_port_init_draws_the_reference_shapes_from_a_generator():
    for arch in ("llama3.2-3b", "mamba2-2.7b"):
        cfg = get_config(arch, reduced=True)
        jshapes = {k: v.shape for k, v in jax.tree_util.tree_flatten_with_path(
            j_get_family(cfg).init(jax.random.PRNGKey(0), cfg))[0]}
        a = get_family(cfg).init(cfg, torch.Generator().manual_seed(3), CPU)
        b = get_family(cfg).init(cfg, torch.Generator().manual_seed(3), CPU)
        n_params = sum(p.numel() for p in a.parameters())
        assert n_params == sum(int(np.prod(s)) for s in jshapes.values())
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), name
            assert torch.isfinite(pa).all(), name


@pytest.mark.parametrize("arch,match", [
    ("phi3.5-moe-42b-a6.6b", "ROADMAP Queue 1 item"),
    ("zamba2-2.7b", "ROADMAP Queue 1 item 10"),
    ("whisper-base", "ROADMAP Queue 1 item 10"),
    ("internvl2-76b", "ROADMAP Queue 1 item 9"),
])
def test_unported_families_name_their_roadmap_item(arch, match):
    with pytest.raises(NotImplementedError, match=match):
        get_family(get_config(arch, reduced=True))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_remat_never_changes_a_value(arch, policy):
    """``remat`` is a memory policy: under autograd the loss and every
    gradient equal those without it, bit for bit on the CPU, with the
    kernel path and the plain one; without autograd it is not used."""
    base = get_config(arch, reduced=True).replace(loss_chunk=16)
    fam = get_family(base)
    model = fam.init(base, torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, base.vocab, (2, 33), dtype=np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for use_flash in (False, True):
        out = {}
        for remat in ("none", policy):
            cfg = base.replace(remat=remat, use_flash=use_flash)
            loss = fam.loss_fn(model, cfg, batch)
            out[remat] = (loss, torch.autograd.grad(loss, list(model.parameters())))
        (l0, g0), (l1, g1) = out["none"], out[policy]
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    with torch.no_grad():
        assert torch.equal(fam.loss_fn(model, base.replace(remat=policy), batch),
                           fam.loss_fn(model, base, batch))


@pytest.mark.parametrize("arch,op", [("llama3.2-3b", "flash_attention"),
                                     ("mamba2-2.7b", "ssd_chunked_kernel")])
def test_the_config_of_the_call_picks_the_path(monkeypatch, arch, op):
    """The model's construction config gives shapes only: a prefill called
    with use_flash off must not reach the kernel wrapper even when the
    model was built from a use_flash config (and the reverse)."""
    from repro_torch.kernels import ops

    calls = []
    real = getattr(ops, op)
    monkeypatch.setattr(ops, op, lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = get_config(arch, reduced=True)
    fam = get_family(cfg)
    model = fam.init(cfg.replace(use_flash=True), torch.Generator().manual_seed(0), CPU)
    tokens = {"tokens": torch.zeros((1, 40), dtype=torch.long)}
    with torch.no_grad():
        for use_flash, want in ((False, 0), (True, cfg.n_layers)):
            calls.clear()
            c = cfg.replace(use_flash=use_flash)
            fam.prefill(model, c, tokens, fam.init_cache(c, 1, 64, device=CPU))
            assert len(calls) == want, (use_flash, len(calls))
