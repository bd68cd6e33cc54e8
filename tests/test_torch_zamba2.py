"""The port's pieces that the published Zamba2 needs, on the CPU: K3's
checks and plain versions with a score scale and at head dim 224, the
Mamba mixer's grouped gated norm (at one group today's result, bit for
bit), and the ``zamba2-7b`` configuration's layout.  The family against
the plain reference and ``transformers`` is in
``insitu_bench/tests/test_ibench_zamba2.py``."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402

ZAMBA2_SCALE = (224 / 2) ** -0.5


def _qkv(seed, b, s, h, kv, d, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, s, n, d), generator=g).to(dtype) for n in (h, kv, kv))


# ------------------------------------------------------------------- K3
def test_check_args_serves_bf16_head_dim_224_and_a_scale():
    q, k, v = _qkv(0, 1, 8, 4, 2, 224, torch.bfloat16)
    fa.check_args(q, k, v, 0)
    fa.check_args(q, k, v, 0, ZAMBA2_SCALE)
    assert fa.bf16_tiles(224) == fa.BF16_WIDE_TILES == (128, 64)
    assert fa.bf16_tiles(128) == fa.BF16_TILES


@pytest.mark.parametrize("d, dtype, scale, match", [
    (224, torch.float32, None, "bfloat16 also serves"),   # CUDA cores: D <= 128
    (144, torch.bfloat16, None, "multiple of 16 in"),     # not a wide dim served
    (256, torch.bfloat16, None, "multiple of 16 in"),
    (64, torch.bfloat16, 0.0, "finite positive"),
    (64, torch.float32, -1.0, "finite positive"),
    (64, torch.bfloat16, float("nan"), "finite positive"),
])
def test_check_args_refuses_what_the_kernel_does_not_serve(d, dtype, scale, match):
    q, k, v = _qkv(1, 1, 8, 4, 2, d, dtype)
    with pytest.raises(ValueError, match=match):
        fa.check_args(q, k, v, 0, scale)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v, scale=scale)


@pytest.mark.parametrize("window", [0, 5])
def test_plain_attention_with_a_scale(window):
    """``flash_attention_ref`` with ``scale`` is softmax(s q k^T) v, masked;
    with no scale it is what it was (1/sqrt(D)); the tile-by-tile twin and
    the blockwise backward's forward take the same scale."""
    q, k, v = _qkv(2, 2, 37, 4, 2, 32)
    got = ref.flash_attention_ref(q, k, v, causal=True, window=window, scale=0.3)
    qf = q.reshape(2, 37, 2, 2, 32)
    s = torch.einsum("bqkrd,bskd->bkrqs", qf, k) * 0.3
    i = torch.arange(37)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    want = torch.einsum("bkrqs,bskd->bqkrd", torch.softmax(
        s.masked_fill(~mask, -math.inf), -1), v).reshape(2, 37, 4, 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    default = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert torch.equal(default, ref.flash_attention_ref(
        q * 1.0, k, v, causal=True, window=window, scale=None))
    torch.testing.assert_close(default, ref.flash_attention_ref(
        q, k, v, causal=True, window=window, scale=32 ** -0.5), rtol=1e-5, atol=1e-6)
    for other in (ref.flash_attention_tiles_ref(q, k, v, causal=True, window=window,
                                                tiles=(16, 8), scale=0.3),
                  L.blockwise_attention(q, k, v, causal=True, window=window,
                                        q_chunk=16, k_chunk=8, scale=0.3)):
        torch.testing.assert_close(other, got, rtol=1e-5, atol=1e-6)


def test_wide_tiles_twin_and_gradients_with_a_scale():
    """At D = 224 in bfloat16 the twin runs 64-key tiles and agrees with the
    plain version to one bf16 rounding; the autograd Function's gradients
    with a scale equal autograd through the plain version (float32, which
    the CPU serves up to D = 128)."""
    q, k, v = _qkv(3, 1, 150, 2, 2, 224, torch.bfloat16)
    twin = ref.flash_attention_tiles_ref(q, k, v, causal=True, scale=ZAMBA2_SCALE)
    plain = ref.flash_attention_ref(q, k, v, causal=True, scale=ZAMBA2_SCALE)
    torch.testing.assert_close(twin.float(), plain.float(), atol=4e-3, rtol=8e-3)
    a = [t.float().requires_grad_() for t in _qkv(4, 1, 70, 2, 2, 32)]
    r = [t.detach().clone().requires_grad_() for t in a]
    out = ops.flash_attention(*a, causal=True, block_q=32, block_k=16,
                              scale=ZAMBA2_SCALE)
    got = torch.autograd.grad((out ** 2).sum(), a)
    want = torch.autograd.grad((ref.flash_attention_ref(
        *r, causal=True, scale=ZAMBA2_SCALE) ** 2).sum(), r)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_attend_recomputes_k3_in_attn_chunks(chunk, monkeypatch):
    """Under ``use_flash`` K3's backward recomputes the attention in chunks
    of the config's ``attn_chunk`` queries and keys, for every family, and
    its gradients are the plain attention's."""
    cfg = get_config("llama3.2-3b", reduced=True).replace(use_flash=True,
                                                           attn_chunk=chunk)
    seen = []
    plain = L.blockwise_attention

    def recording(*a, **kw):
        seen.append((kw["q_chunk"], kw["k_chunk"]))
        return plain(*a, **kw)

    monkeypatch.setattr(L, "blockwise_attention", recording)
    g = torch.Generator().manual_seed(chunk)
    q, k, v = (torch.randn((2, 96, 4, 16), generator=g, requires_grad=True)
               for _ in range(3))
    got = torch.autograd.grad((L.attend(q, k, v, cfg) ** 2).sum(), (q, k, v))
    want = torch.autograd.grad((ref.flash_attention_ref(q, k, v, causal=True)
                                ** 2).sum(), (q, k, v))
    assert seen == [(chunk, chunk)]
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ gated norm
def test_grouped_gated_norm_at_one_group_is_todays_mamba_bit_for_bit():
    """At ``ssm_groups`` 1 (every config but zamba2-7b) the mixer's gated
    norm is ``rmsnorm`` over all of y, bit for bit as before; at 2 groups
    each half is normalised on its own, then scaled."""
    def parts(g):
        cfg = get_config("mamba2-2.7b", reduced=True).replace(ssm_groups=g)
        m = ssm.init(cfg, torch.Generator().manual_seed(5)).layers[0].mamba
        x = torch.randn((2, 40, cfg.d_model),
                        generator=torch.Generator().manual_seed(6))
        got, _ = m(x, cfg)
        zxbcdt = x @ m.in_proj
        di, n = cfg.d_inner, cfg.ssm_state
        z = zxbcdt[..., :di]
        xBC, _ = ssm._causal_conv(zxbcdt[..., di:2 * di + 2 * g * n], m.conv_w,
                                  m.conv_b)
        y, _ = ssm._mixer(cfg, None, xBC, zxbcdt[..., 2 * di + 2 * g * n:],
                          m.A_log, m.dt_bias, m.D, None, x.dtype)
        return m, got, y * torch.nn.functional.silu(z), di

    m, got, yz, _ = parts(1)
    assert torch.equal(got, m.norm(yz) @ m.out_proj)
    assert torch.equal(L.rmsnorm_grouped(m.norm.scale, yz, 1, m.norm.eps), m.norm(yz))
    m, grouped, yz, di = parts(2)
    halves = torch.cat([L.rmsnorm(m.norm.scale[:di // 2], yz[..., :di // 2], m.norm.eps),
                        L.rmsnorm(m.norm.scale[di // 2:], yz[..., di // 2:], m.norm.eps)],
                       dim=-1)
    torch.testing.assert_close(grouped, halves @ m.out_proj, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- config
def test_zamba2_7b_is_the_published_cut():
    """27 layers, blocks A, B, A, B at 6, 11, 17, 23, 2.97 B parameters;
    serving is refused with a clear error."""
    cfg = get_config("zamba2-7b")
    assert cfg.family == "zamba2" and cfg.n_layers == 27
    assert cfg.hybrid_layers == (6, 11, 17, 23) and cfg.shared_blocks == 2
    assert (cfg.resolved_head_dim, cfg.ssm_groups) == (224, 2)
    fam = get_family(cfg)
    model = fam.model(cfg, torch.device("meta"))
    n = sum(p.numel() for p in model.parameters())
    assert abs(n / 2.97e9 - 1) < 0.005
    assert abs(cfg.param_count() / n - 1) < 1e-3
    assert [len(model.blocks), len(model.calls)] == [2, 4]
    small = get_config("zamba2-7b", reduced=True)
    with pytest.raises(NotImplementedError, match="KV cache"):
        fam.prefill(fam.model(small, torch.device("meta")), small, {}, None)
    with pytest.raises(NotImplementedError, match="KV cache"):
        fam.init_cache(small, 1, 8)
