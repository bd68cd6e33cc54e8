"""The port's serving engine: greedy tokens equal to the JAX package's
``Engine`` on the same converted parameters (float32 caches), the four
behaviours of ``tests/test_serve.py`` on the port, and the device rules --
the engine and the serve driver run on ``cuda:0`` and raise without CUDA,
and nothing falls back to the CPU on its own."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.registry import get_family as j_get_family  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

CPU = torch.device("cpu")
CFG = get_config("tinyllama-1.1b", reduced=True)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _reqs(n, rng, cfg=CFG, max_new=5, cls=Request):
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab, 7 + 3 * i, dtype=np.int32),
                max_new_tokens=max_new) for i in range(n)]


@pytest.mark.parametrize("arch,use_flash", [
    ("tinyllama-1.1b", False), ("llama3.2-3b", True),
    ("mamba2-2.7b", False), ("mamba2-2.7b", True)])
def test_greedy_tokens_equal_the_jax_engine(arch, use_flash):
    jcfg = j_get_config(arch, reduced=True).replace(use_flash=use_flash)
    cfg = get_config(arch, reduced=True).replace(use_flash=use_flash)
    jparams = j_get_family(jcfg).init(jax.random.PRNGKey(11), jcfg)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, jparams), CPU)
    outs = []
    for eng, cls in ((JEngine(jcfg, JServeConfig(max_slots=2, max_len=64,
                                                 cache_dtype="float32"),
                              params=jparams), JRequest),
                     (Engine(cfg, ServeConfig(max_slots=2, max_len=64,
                                              cache_dtype="float32"),
                             params=model, device=CPU), Request)):
        reqs = _reqs(4, np.random.default_rng(5), cfg, max_new=6, cls=cls)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]


def test_drains_more_requests_than_slots():
    eng = Engine(CFG, ServeConfig(max_slots=2, max_len=64), device=CPU)
    reqs = _reqs(5, np.random.default_rng(0))
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 5 for r in reqs)


def test_greedy_is_deterministic():
    prompt = np.random.default_rng(1).integers(0, CFG.vocab, 7, dtype=np.int32)
    outs = []
    for _ in range(2):
        eng = Engine(CFG, ServeConfig(max_slots=1, max_len=64), device=CPU,
                     generator=_gen(3))
        r = Request(rid=0, prompt=prompt.copy(), max_new_tokens=6)
        eng.submit(r)
        eng.run_until_drained()
        outs.append(tuple(r.out_tokens))
    assert outs[0] == outs[1]


def test_batching_invariance():
    """A request's tokens do not depend on what shares the batch."""
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, CFG.vocab, 7, dtype=np.int32)
    eng1 = Engine(CFG, ServeConfig(max_slots=1, max_len=64), device=CPU,
                  generator=_gen(5))
    alone = Request(rid=0, prompt=prompt.copy(), max_new_tokens=4)
    eng1.submit(alone)
    eng1.run_until_drained()

    eng2 = Engine(CFG, ServeConfig(max_slots=3, max_len=64), device=CPU,
                  generator=_gen(5))
    shared = Request(rid=0, prompt=prompt.copy(), max_new_tokens=4)
    eng2.submit(shared)
    for r in _reqs(2, rng, max_new=4):
        r.rid += 10
        eng2.submit(r)
    eng2.run_until_drained()
    assert alone.out_tokens == shared.out_tokens


@pytest.mark.parametrize("as_state_dict", [False, True],
                         ids=["model", "state_dict"])
def test_weight_hot_swap_changes_output(as_state_dict):
    """In situ checkpoint consumption: new weights, new behaviour."""
    from repro_torch.models.registry import get_family

    prompt = np.random.default_rng(3).integers(0, CFG.vocab, 7, dtype=np.int32)
    eng = Engine(CFG, ServeConfig(max_slots=1, max_len=64), device=CPU,
                 generator=_gen(0))
    r1 = Request(rid=0, prompt=prompt.copy(), max_new_tokens=4)
    eng.submit(r1)
    eng.run_until_drained()

    new = get_family(CFG).init(CFG, _gen(99), CPU)
    eng.swap_params(new.state_dict() if as_state_dict else new)
    r2 = Request(rid=1, prompt=prompt.copy(), max_new_tokens=4)
    eng.submit(r2)
    eng.run_until_drained()
    assert r1.out_tokens != r2.out_tokens


def test_engine_and_driver_default_to_cuda_and_never_fall_back(monkeypatch):
    if torch.cuda.is_available():
        assert Engine(CFG, ServeConfig(max_slots=1, max_len=16)).device == \
            torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(CFG, ServeConfig(max_slots=1, max_len=16))
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "tinyllama-1.1b",
                                      "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main()


def test_flash_path_on_a_device_without_kernel_raises():
    """A model on a device that is neither the card nor the CPU has no
    kernel and no plain fallback: the use_flash prefill raises."""
    from repro_torch.models.registry import get_family

    cfg = CFG.replace(use_flash=True)
    meta = torch.device("meta")
    eng = Engine(cfg, ServeConfig(max_slots=1, max_len=16),
                 params=get_family(cfg).model(cfg, meta), device=meta)
    eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        eng.step()
