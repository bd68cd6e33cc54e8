"""The reference's per-architecture smoke and consistency tests on the port
(``tests/test_archs.py``, ``tests/test_decode_consistency.py``,
``tests/test_moe_a2a.py::test_a2a_unavailable_without_mesh_falls_back``):
every one of the ten arch configs, reduced, takes a training step and
decodes on the CPU; decode after prefill equals the full forward; the
sorted MoE equals its dense oracle; Arctic keeps its dense residual; the
hybrid's ring cache holds past the window; the encoder-decoder's decode
equals its full decoder; a VLM's vision prefix reaches the text.  The
port's own weights, from ``torch.Generator`` seeds; the tolerances are the
reference tests'."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import hybrid as HY  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SM  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402
from repro_torch.train import AdamWConfig, init_state, make_train_step  # noqa: E402

CPU = torch.device("cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _batch(cfg, b=2, s=16):
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(b, cfg.vision_tokens, cfg.d_model)) * 0.02).float()
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(b, cfg.source_len, cfg.d_model)) * 0.02).float()
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_train_step(arch):
    cfg = get_config(arch, reduced=True)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       state_dtype=cfg.opt_state_dtype)
    state = init_state(_gen(), cfg, ocfg, CPU)
    before = [p.detach().clone() for p in state.params.parameters()]
    state, metrics = make_train_step(cfg, ocfg)(state, _batch(cfg))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(state.opt.step) == 1
    after = list(state.params.parameters())
    assert all(torch.isfinite(p).all() for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_decode(arch):
    cfg = get_config(arch, reduced=True)
    fam = get_family(cfg)
    model = fam.init(cfg, _gen(), CPU)
    b, s, max_len = 2, 8, 32
    batch = _batch(cfg, b, s)
    batch.pop("labels")
    cache = fam.init_cache(cfg, b, max_len, dtype=torch.float32, device=CPU)
    with torch.no_grad():
        logits, cache = fam.prefill(model, cfg, batch, cache)
        assert logits.shape == (b, 1, cfg.padded_vocab)
        assert torch.isfinite(logits).all()
        tok = logits[:, -1, :cfg.vocab].argmax(-1)[:, None]
        logits2, cache = fam.decode_step(model, cfg, tok, cache)
    assert logits2.shape == (b, 1, cfg.padded_vocab)
    assert torch.isfinite(logits2).all()


def _full_logits(family, model, cfg, toks):
    if family == "dense":
        h, _, _ = TF.forward(model, cfg, toks)
    elif family == "ssm":
        h, _ = SM.forward(model, cfg, toks)
    else:
        h, _ = HY.forward(model, cfg, toks)
    return L.unembed(model.embed, h[:, -1:])


@pytest.mark.parametrize("family,arch", [
    ("dense", "tinyllama-1.1b"),
    ("ssm", "mamba2-2.7b"),
    ("hybrid", "zamba2-2.7b"),
])
def test_decode_matches_forward(family, arch):
    """prefill(t0..tk) + decode(t_{k+1}) == forward(t0..t_{k+1}) last logits."""
    cfg = get_config(arch, reduced=True)
    fam = get_family(cfg)
    model = fam.init(cfg, _gen(), CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, 12)))
    with torch.no_grad():
        full = _full_logits(family, model, cfg, toks)
        cache = fam.init_cache(cfg, 1, 32, dtype=torch.float32, device=CPU)
        _, cache = fam.prefill(model, cfg, {"tokens": toks[:, :-1]}, cache)
        dec, _ = fam.decode_step(model, cfg, toks[:, -1:], cache)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-3, rtol=2e-3)


def test_moe_sorted_matches_dense_oracle():
    """Grouped-dispatch MoE == dense-einsum oracle at high capacity."""
    cfg = get_config("phi3.5-moe-42b-a6.6b", reduced=True).replace(
        capacity_factor=8.0)  # no drops -> paths must agree exactly
    p = L.MoE(cfg, CPU)
    p.reset_parameters(_gen())
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 33, cfg.d_model))).float() * 0.1
    with torch.no_grad():
        out_d, aux_d = L.moe_dense(p, cfg, x)
        out_s, aux_s = L.moe(p, cfg, x)
    np.testing.assert_allclose(out_s.numpy(), out_d.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(aux_s), float(aux_d), rtol=1e-5)


def test_arctic_dense_residual_present():
    cfg = get_config("arctic-480b", reduced=True)
    model = get_family(cfg).init(cfg, _gen(), CPU)
    names = {n for n, _ in model.named_parameters()}
    assert "layers.0.moe.router" in names
    assert "layers.0.ffn.gate" in names  # dense residual branch
    phi = get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    assert get_family(phi).model(phi, CPU).layers[0].ffn is None


def test_a2a_unavailable_without_mesh_falls_back():
    """``moe_dispatch="a2a"`` on one device: the sorted/dense dispatch."""
    cfg = ModelConfig(name="t", family="moe", n_layers=2, d_model=32, vocab=64,
                      n_heads=2, n_kv_heads=2, d_ff=64, n_experts=8, top_k=2,
                      moe_d_ff=64, dtype="float32", capacity_factor=8.0,
                      moe_dispatch="a2a")
    p = L.MoE(cfg, CPU)
    p.reset_parameters(_gen())
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 32))).float() * 0.1
    with torch.no_grad():
        out, _ = L.moe(p, cfg, x)
        want, _ = L.moe_dense(p, cfg, x)
        sorted_out, _ = L.moe(p, dataclasses.replace(cfg, moe_dispatch="sorted"), x)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)
    assert torch.equal(out, sorted_out)


# ------------------------------------------- test_decode_consistency.py twins
def test_hybrid_ring_cache_past_window():
    """Decoding far past cfg.window matches the windowed full forward: the
    ring overwrites old slots, the full forward masks them."""
    cfg = get_config("zamba2-2.7b", reduced=True).replace(window=16)
    fam = get_family(cfg)
    model = fam.init(cfg, _gen(7), CPU)
    total = 48                            # 3x the window
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, total)))
    dec_logits = {}
    with torch.no_grad():
        cache = fam.init_cache(cfg, 1, total, dtype=torch.float32, device=CPU)
        _, cache = fam.prefill(model, cfg, {"tokens": toks[:, :8]}, cache)
        for t in range(8, total):
            logits, cache = fam.decode_step(model, cfg, toks[:, t:t + 1], cache)
            dec_logits[t] = logits[0, 0].numpy()
        for t in (20, 33, total - 1):
            h, _ = HY.forward(model, cfg, toks[:, :t + 1])
            want = L.unembed(model.embed, h[:, -1:])[0, 0].numpy()
            np.testing.assert_allclose(dec_logits[t], want, atol=5e-3, rtol=5e-3,
                                       err_msg=f"position {t}")


def test_encdec_decode_matches_forward():
    cfg = get_config("whisper-base", reduced=True)
    fam = get_family(cfg)
    model = fam.init(cfg, _gen(7), CPU)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 10)))
    frames = torch.from_numpy(rng.normal(size=(1, cfg.source_len, cfg.d_model))
                              * 0.02).float()
    with torch.no_grad():
        xkv = ED.cross_kv(model, cfg, ED.encode(model, cfg, frames))
        h, _ = ED.decode(model, cfg, toks, xkv)
        want = L.unembed(model.embed, h[:, -1:])
        cache = fam.init_cache(cfg, 1, 32, dtype=torch.float32, device=CPU)
        _, cache = fam.prefill(model, cfg, {"tokens": toks[:, :-1], "frames": frames},
                               cache)
        got, _ = fam.decode_step(model, cfg, toks[:, -1:], cache)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3, rtol=2e-3)


def test_vlm_prefix_changes_logits():
    cfg = get_config("internvl2-76b", reduced=True)
    model = get_family(cfg).init(cfg, _gen(7), CPU)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 8)))
    v1 = torch.from_numpy(rng.normal(size=(1, cfg.vision_tokens, cfg.d_model))
                          * 0.1).float()
    with torch.no_grad():
        h1, _, _ = TF.forward(model, cfg, toks, prefix_embeds=v1)
        h2, _, _ = TF.forward(model, cfg, toks, prefix_embeds=torch.zeros_like(v1))
        l1 = L.unembed(model.embed, h1[:, -1:])
        l2 = L.unembed(model.embed, h2[:, -1:])
    assert float((l1 - l2).abs().max()) > 1e-4  # the prefix reaches the text tail
    assert h1.shape[1] == cfg.vision_tokens + 8
