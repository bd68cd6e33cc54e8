"""The port's hybrid, encdec, moe and vlm families against the JAX package
on the same parameters (``convert.params_from_reference``), at the
reduced configs of ``zamba2-2.7b``, ``whisper-base``,
``phi3.5-moe-42b-a6.6b``, ``arctic-480b`` and ``internvl2-76b``, each with
``use_flash`` off and on (the JAX side runs its Pallas kernels in
interpret mode): prefill logits, every cache entry and three decode steps;
the serving engine's greedy tokens; the MoE's capacity drops; and the
reference's ring-cache fault, which the port reproduces
(``test_torch_family_train.py`` holds their losses, gradients and training
steps).  Tolerance 2e-4, the reference's own for one function by two
paths (``tests/test_archs.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_family as j_get_family  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import hybrid as H  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=2e-4, rtol=2e-4)
B, S, MAX_LEN = 2, 40, 64
ARCHS = ["zamba2-2.7b", "whisper-base", "phi3.5-moe-42b-a6.6b", "arctic-480b",
         "internvl2-76b"]
FLASH = pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])


def _pair(arch, **over):
    jcfg = j_get_config(arch, reduced=True).replace(**over)
    cfg = get_config(arch, reduced=True).replace(**over)
    jparams = j_get_family(jcfg).init(jax.random.PRNGKey(7), jcfg)
    model = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, cfg, jparams, model


def _host_batch(cfg, seed, b=B, s=S):
    """tokens (and labels), plus the stub frontends' inputs of vlm/encdec,
    at the scale ``tests/test_archs.py`` draws them."""
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


def _both(host):
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
          else torch.from_numpy(v) for k, v in host.items()}
    return jb, tb


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what, **TOL)


def _close_tree(got, want, what):
    """Nested dicts with the same keys, every leaf within TOL."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _close_tree(got[key], want[key], f"{what}.{key}")
        else:
            _close(got[key], want[key], f"{what}.{key}")


@FLASH
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, use_flash):
    jcfg, cfg, jparams, model = _pair(arch, use_flash=use_flash)
    jfam, fam = j_get_family(jcfg), get_family(cfg)
    host = _host_batch(cfg, 1)
    host.pop("labels")
    jb, tb = _both(host)
    jcache = jfam.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32)
    cache = fam.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device=CPU)
    jprefill = jax.jit(lambda p, b, c: jfam.prefill(p, jcfg, b, c))
    jdecode = jax.jit(lambda p, t, c: jfam.decode_step(p, jcfg, t, c))
    with torch.no_grad():
        jlogits, jcache = jprefill(jparams, jb, jcache)
        logits, cache = fam.prefill(model, cfg, tb, cache)
        _close(logits, jlogits, "prefill logits")
        _close_tree(cache, jcache, "cache after prefill")
        for step in range(3):
            tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1).astype(np.int32)
            tok = tok.reshape(B, 1)
            jlogits, jcache = jdecode(jparams, jnp.asarray(tok), jcache)
            logits, cache = fam.decode_step(model, cfg,
                                            torch.from_numpy(tok).long(), cache)
            _close(logits, jlogits, f"decode {step} logits")
            _close_tree(cache, jcache, f"cache after decode {step}")


@pytest.mark.parametrize("arch,use_flash", [
    ("zamba2-2.7b", True), ("whisper-base", True),
    ("phi3.5-moe-42b-a6.6b", False), ("arctic-480b", True),
    ("internvl2-76b", True)])
def test_greedy_tokens_equal_the_jax_engine(arch, use_flash):
    """Both engines pass the same zero stub frames / vision embeddings;
    prompts of 7-16 tokens, 6 new tokens, 2 slots for 4 requests."""
    jcfg, cfg, jparams, model = _pair(arch, use_flash=use_flash)
    outs = []
    for eng, cls in ((JEngine(jcfg, JServeConfig(max_slots=2, max_len=MAX_LEN,
                                                 cache_dtype="float32"),
                              params=jparams), JRequest),
                     (Engine(cfg, ServeConfig(max_slots=2, max_len=MAX_LEN,
                                              cache_dtype="float32"),
                             params=model, device=CPU), Request)):
        rng = np.random.default_rng(5)
        reqs = [cls(rid=i, prompt=rng.integers(0, cfg.vocab, 7 + 3 * i,
                                               dtype=np.int32),
                    max_new_tokens=6) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "arctic-480b"])
def test_capacity_drops_match_jax(arch):
    """capacity_factor 0.5 makes every expert drop some of its tokens: the
    stable sort decides which, and the dropped entries add nothing.  The
    output and the aux loss equal the reference's; the dense oracle, which
    drops nothing, differs."""
    jcfg, cfg, jparams, model = _pair(arch, capacity_factor=0.5)
    p = model.layers[0].moe
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    x = (np.random.default_rng(3).normal(size=(2, 33, cfg.d_model)) * 0.5
         ).astype(np.float32)
    want, jaux = JL.moe(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, aux = L.moe(p, cfg, torch.from_numpy(x))
        dense, _ = L.moe_dense(p, cfg, torch.from_numpy(x))
    _close(got, want, "moe output")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float((got - dense).abs().max()) > 1e-2   # tokens were dropped
    n_zero = int((got.abs().amax(-1) == 0).sum())
    assert n_zero == int((np.abs(np.asarray(want)).max(-1) == 0).sum())


@pytest.mark.parametrize("prompt", [20, 40])
def test_ring_cache_fault_is_the_references(prompt):
    """The reference's ring cache (window 32, max_len 64, so R = 32) keeps
    ``len = min(R, s)`` after a prefill of s tokens, and ``decode_step``
    takes that as the next position (ROADMAP Queue 3).  With a prompt
    inside the ring the decoded logits equal the full forward's; past it
    they do not, in both packages alike, and the port agrees with the
    reference either way."""
    jcfg, cfg, jparams, model = _pair("zamba2-2.7b")
    assert cfg.window == 32
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (1, prompt + 1),
                                             dtype=np.int32)
    jfam, fam = j_get_family(jcfg), get_family(cfg)
    jcache = jfam.init_cache(jcfg, 1, MAX_LEN, dtype=jnp.float32)
    _, jcache = jfam.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :-1])},
                             jcache)
    jdec, _ = jfam.decode_step(jparams, jcfg, jnp.asarray(toks[:, -1:]), jcache)
    jh, _ = JH.forward(jparams, jcfg, jnp.asarray(toks))
    jfull = JL.unembed(jparams["embed"], jh[:, -1:])
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        cache = fam.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device=CPU)
        _, cache = fam.prefill(model, cfg, {"tokens": t[:, :-1]}, cache)
        assert int(cache["attn"]["len"][0]) == min(32, prompt)
        dec, _ = fam.decode_step(model, cfg, t[:, -1:], cache)
        h, _ = H.forward(model, cfg, t)
        full = L.unembed(model.embed, h[:, -1:])
    _close(dec, jdec, "decode after the prompt")
    _close(full, jfull, "full forward")
    for got, want in ((dec.numpy(), full.numpy()),
                      (np.asarray(jdec), np.asarray(jfull))):
        err = float(np.abs(got - want).max())
        if prompt <= 32:
            assert err < 1e-4, err
        else:
            assert err > 1e-2, err
