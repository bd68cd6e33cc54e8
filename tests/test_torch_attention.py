"""K3: the port's ``ops.flash_attention`` against the JAX package's
``ops.flash_attention`` (its Pallas kernel in interpret mode on the CPU),
over the cases of ``tests/test_kernels.py`` at its tolerances (float32
3e-5, bfloat16 3e-2, gradients 2e-4), and the plain blockwise attention
of the backward (``models.layers.blockwise_attention``) at 2e-5.  Inputs are seeded numpy; on the CPU the port runs
its plain version, and the same checks guard the kernel's wrapper."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _both(arrays, dtype=np.float32, **kw):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jops.flash_attention(*(jnp.asarray(a, jd) for a in arrays), **kw)
    got = ops.flash_attention(*(torch.from_numpy(a).to(td) for a in arrays), **kw)
    return got, want


@pytest.mark.parametrize("b,s,h,kv,d,bq,bk", [
    (1, 128, 2, 2, 32, 64, 64),      # MHA
    (2, 256, 4, 2, 64, 128, 128),    # GQA rep=2
    (1, 192, 8, 1, 16, 64, 128),     # MQA, ragged seq vs blocks
    (1, 96, 2, 2, 64, 128, 128),     # seq < block (degenerate single block)
    (1, 100, 6, 2, 128, 64, 64),     # GQA rep=3 (the Llama-3.2 shape), ragged
    (1, 70, 4, 4, 80, 32, 32),       # head dim 80
])
def test_flash_attention_matches_jax(b, s, h, kv, d, bq, bk):
    got, want = _both(_qkv(s + d, b, s, h, kv, d), causal=True, block_q=bq,
                      block_k=bk)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("kwargs", [{"causal": False},
                                    {"causal": True, "window": 48}],
                         ids=["noncausal", "window"])
def test_flash_attention_noncausal_and_window_match_jax(kwargs):
    got, want = _both(_qkv(3, 1, 160, 4, 4, 32), block_q=64, block_k=64, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5, err_msg=str(kwargs))


def test_flash_attention_bf16_matches_jax():
    got, want = _both(_qkv(4, 1, 128, 2, 2, 64), dtype="bfloat16", causal=True,
                      block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 33, 4, 2, 16))
    build.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True, window=7)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True, window=7))
    assert build.launch_counts([fa.NAME]) == {fa.NAME: 0}


def test_wrapper_refuses_what_the_kernel_does_not_serve():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="not a multiple"):
        ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), v.double())
    # the raw kernel has no backward: its checks and launcher refuse an
    # input that requires grad; the public wrapper differentiates instead
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.check_args(q.requires_grad_(), k, v, 0)
    assert ops.flash_attention(q, k, v).grad_fn is not None


def test_no_fallback_off_the_card():
    """The kernel's launcher takes CUDA tensors only, and the public wrapper
    raises for a device that is neither the card nor the CPU."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(*(t.to("meta") for t in (q, k, v)))


@pytest.mark.parametrize("view, in_place", [
    ("fused", True),         # q/k/v sliced from one (B, S, H + 2 KV, D) tensor
    ("contiguous", True),
    ("offset", False),       # pointer 2 bytes off the 16-byte grid
    ("d_strided", False),    # non-unit stride along D
    ("expanded", False),     # stride 0 along heads
])
def test_kernel_layout_reads_in_place_only_on_16_byte_grids(view, in_place):
    """The bf16 kernel reads through TMA maps: the wrapper hands it a view
    as it is where the pointer and the (B, S, H) strides are whole 16-byte
    chunks (none 0 along an extent above 1), and a contiguous copy
    otherwise."""
    b, s, h, d = 1, 8, 4, 16
    if view == "fused":
        t = torch.zeros((b, s, h + 4, d), dtype=torch.bfloat16)[:, :, :h]
    elif view == "contiguous":
        t = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    elif view == "offset":
        t = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)[1:].view(b, s, h, d)
    elif view == "d_strided":
        t = torch.zeros((b, s, h, 2 * d), dtype=torch.bfloat16)[..., ::2]
    else:
        t = torch.zeros((b, s, 1, d), dtype=torch.bfloat16).expand(b, s, h, d)
    got = fa._kernel_layout(t)
    assert (got is t) == in_place
    assert torch.equal(got, t) and got.stride(-1) == 1
    if not in_place:
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()


def test_fused_qkv_views_match_jax():
    """q, k and v as slices of one fused projection, as a model may hand
    them, give the JAX package's result."""
    rng = np.random.default_rng(8)
    b, s, h, kv, d = 1, 96, 4, 2, 32
    fused = rng.normal(size=(b, s, h + 2 * kv, d)).astype(np.float32)
    parts = (fused[:, :, :h], fused[:, :, h:h + kv], fused[:, :, h + kv:])
    want = jops.flash_attention(*(jnp.asarray(p) for p in parts), causal=True)
    t = torch.from_numpy(fused)
    got = ops.flash_attention(t[:, :, :h], t[:, :, h:h + kv], t[:, :, h + kv:],
                              causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)


# ------------------------------------------------------------- gradients
def _grads_of_sum_sq(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return torch.autograd.grad((fn(*ts) ** 2).sum(), ts)


def _jax_grads_of_sum_sq(fn, arrays):
    return jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("b,s,h,kv,d,bq,bk,kw", [
    (1, 128, 2, 2, 32, 64, 64, {"causal": True}),                 # MHA
    (1, 100, 6, 2, 64, 32, 64, {"causal": True}),                 # rep 3, ragged
    (2, 96, 4, 1, 16, 32, 32, {"causal": True, "window": 40}),    # MQA, window
    (1, 80, 4, 2, 32, 64, 32, {"causal": False}),
])
def test_flash_attention_grads_match_jax(b, s, h, kv, d, bq, bk, kw):
    """K3's autograd Function (plain forward on the CPU, blockwise
    recompute in the backward with chunks block_q/block_k) against the
    reference's custom VJP, the Pallas forward in interpret mode; the
    gradients of sum(out^2) at 2e-4 (``tests/test_kernels.py:53-65``)."""
    arrays = _qkv(s * 7 + d, b, s, h, kv, d)
    got = _grads_of_sum_sq(lambda q, k, v: ops.flash_attention(
        q, k, v, block_q=bq, block_k=bk, **kw), arrays)
    want = _jax_grads_of_sum_sq(lambda q, k, v: jops.flash_attention(
        q, k, v, block_q=bq, block_k=bk, **kw), arrays)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("kw,qc,kc", [
    ({"causal": True}, 32, 48),                  # ragged chunks both ways
    ({"causal": True, "window": 30}, 16, 16),    # skips stale key chunks
    ({"causal": False}, 40, 24),
    ({"causal": False, "window": 25}, 24, 40),
])
def test_blockwise_attention_and_its_grads_match_jax(kw, qc, kc):
    """The plain blockwise attention (GQA rep 3, S = 100 in chunks that do
    not divide it) and its gradients against the reference's at 2e-5."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    arrays = _qkv(21, 2, 100, 6, 2, 32)
    fn = lambda m: lambda q, k, v: m.blockwise_attention(  # noqa: E731
        q, k, v, q_chunk=qc, k_chunk=kc, **kw)
    out = L.blockwise_attention(*map(torch.from_numpy, arrays), q_chunk=qc,
                                k_chunk=kc, **kw)
    want = JL.blockwise_attention(*map(jnp.asarray, arrays), q_chunk=qc,
                                  k_chunk=kc, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    got = _grads_of_sum_sq(fn(L), arrays)
    wantg = _jax_grads_of_sum_sq(fn(JL), arrays)
    for name, g, w in zip("qkv", got, wantg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("use_flash,attn_chunk", [(True, 64), (False, 16),
                                                  (False, 64)],
                         ids=["kernel", "blockwise", "plain"])
def test_attend_dispatches_as_the_reference(use_flash, attn_chunk):
    from repro.configs import get_config as j_get_config
    from repro.models import layers as JL
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    over = dict(use_flash=use_flash, attn_chunk=attn_chunk)
    arrays = _qkv(22, 1, 40, 4, 2, 32)
    got = L.attend(*map(torch.from_numpy, arrays),
                   get_config("llama3.2-3b", reduced=True).replace(**over),
                   causal=True, window=9)
    want = JL.attend(*map(jnp.asarray, arrays),
                     j_get_config("llama3.2-3b", reduced=True).replace(**over),
                     causal=True, window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)
