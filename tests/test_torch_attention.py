"""K3: the port's ``ops.flash_attention`` against the JAX package's
``ops.flash_attention`` (its Pallas kernel in interpret mode on the CPU),
over the cases of ``tests/test_kernels.py`` at its tolerances (float32
3e-5, bfloat16 3e-2).  Inputs are seeded numpy; on the CPU the port runs
its plain version, and the same checks guard the kernel's wrapper."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.flash_attention(q.requires_grad_(), k, v)


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
])
def test_kernel_layout_reads_in_place_only_on_16_byte_grids(view, in_place):
    """The bf16 tensor-core kernel copies 16 bytes at a time: the wrapper
    hands it a view as it is where the pointer and the (B, S, H) strides
    are whole 16-byte chunks, and a contiguous copy otherwise."""
    b, s, h, d = 1, 8, 4, 16
    if view == "fused":
        t = torch.zeros((b, s, h + 4, d), dtype=torch.bfloat16)[:, :, :h]
    elif view == "contiguous":
        t = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    elif view == "offset":
        t = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)[1:].view(b, s, h, d)
    else:
        t = torch.zeros((b, s, h, 2 * d), dtype=torch.bfloat16)[..., ::2]
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
