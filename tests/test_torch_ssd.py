"""K4: the port's SSD scan against the JAX package's, over the cases of
``tests/test_kernels.py`` (ragged, G = 2, an initial state) at its 2e-4:
``ops.ssd_chunked_kernel`` against ``ops.ssd_chunked_pallas``, the
intra-chunk step against the Pallas ``ssd_intra_chunk`` in interpret mode,
and the plain ``models.ssm.ssd_chunked`` against the reference's.  Inputs
are seeded numpy; on the CPU the port runs its plain versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra_chunk as j_intra  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(seed, lead, h, p, g, n, state=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (h, p)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=lead + (h,))) * 0.1).astype(np.float32)
    Bm = rng.normal(size=lead + (g, n)).astype(np.float32)
    Cm = rng.normal(size=lead + (g, n)).astype(np.float32)
    out = [x, dA, Bm, Cm]
    if state:
        out.append(rng.normal(size=(lead[0], h, n, p)).astype(np.float32))
    return out


CASES = [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 16, 2, 16, 32),
    (1, 100, 4, 8, 1, 8, 32),        # ragged: s % chunk != 0
    (1, 300, 8, 24, 2, 20, 128),     # ragged, q > 64, P and N off the 16 grid
    (1, 96, 12, 8, 1, 8, 32),        # 12 heads: the kernel's subsets of 8 and 4
    (1, 80, 16, 8, 4, 8, 32),        # G = 4: one short subset per group
    (1, 70, 3, 72, 1, 12, 64),       # P > 64: the kernel's subsets of 4 heads
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_ssd_chunked_kernel_matches_jax(b, s, h, p, g, n, chunk):
    arrays = _inputs(s, (b, s), h, p, g, n)
    y1, f1 = ops.ssd_chunked_kernel(*map(torch.from_numpy, arrays), chunk=chunk)
    y2, f2 = jops.ssd_chunked_pallas(*map(jnp.asarray, arrays), chunk=chunk)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y2), **TOL)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f2), **TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_plain_ssd_chunked_matches_jax(b, s, h, p, g, n, chunk):
    arrays = _inputs(s + 1, (b, s), h, p, g, n)
    y1, f1 = ssd_chunked(*map(torch.from_numpy, arrays), chunk=chunk)
    y2, f2 = j_ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y2), **TOL)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f2), **TOL)


@pytest.mark.parametrize("b,nc,q,h,p,g,n", [
    (1, 3, 32, 4, 16, 2, 16),
    (2, 2, 80, 4, 8, 1, 24),
])
def test_intra_chunk_step_matches_pallas(b, nc, q, h, p, g, n):
    arrays = _inputs(q, (b, nc, q), h, p, g, n)
    y1, s1 = ops.ssd_intra_chunk(*map(torch.from_numpy, arrays))
    y2, s2 = j_intra(*map(jnp.asarray, arrays), interpret=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y2), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s2), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_ssd_with_initial_state_matches_jax(use_kernel):
    arrays = _inputs(9, (1, 64), 2, 8, 1, 8, state=True)
    fn = ops.ssd_chunked_kernel if use_kernel else ssd_chunked
    y1, f1 = fn(*map(torch.from_numpy, arrays[:4]), chunk=32,
                initial_state=torch.from_numpy(arrays[4]))
    y2, f2 = jops.ssd_chunked_pallas(*map(jnp.asarray, arrays[:4]), chunk=32,
                                     initial_state=jnp.asarray(arrays[4]))
    np.testing.assert_allclose(y1.numpy(), np.asarray(y2), **TOL)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f2), **TOL)


def test_masked_terms_give_no_nan():
    """exp(cs_i - cs_j) above the diagonal overflows for a strongly decaying
    chunk; the plain version selects 0 there, as the kernel does."""
    x, dA, Bm, Cm = map(torch.from_numpy, _inputs(10, (1, 1, 256), 2, 8, 1, 8))
    y, st = ref.ssd_intra_chunk_ref(x, dA * 100, Bm, Cm)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_cpu_path_counts_no_launch_and_wrappers_refuse():
    x, dA, Bm, Cm = map(torch.from_numpy, _inputs(11, (1, 1, 16), 2, 8, 1, 8))
    build.reset_launch_counts()
    ops.ssd_intra_chunk(x, dA, Bm, Cm)
    assert build.launch_counts([ssd_scan.NAME]) == {ssd_scan.NAME: 0}
    with pytest.raises(ValueError, match=r"in \[1, 128\]"):
        ops.ssd_intra_chunk(x.repeat(1, 1, 1, 1, 17), dA, Bm, Cm)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.ssd_intra_chunk(x.requires_grad_(), dA, Bm, Cm)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd_scan.ssd_intra_chunk(x.detach(), dA, Bm, Cm)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssd_intra_chunk(*(t.detach().to("meta") for t in (x, dA, Bm, Cm)))
