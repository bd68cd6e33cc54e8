"""K4's tile contract and arithmetic, on the CPU.

The CUDA kernel computes the SSD intra-chunk step on the tensor cores in
3xTF32: every operand split into TF32 hi and lo parts (``ref.split_tf32``,
round to nearest with ties away as ``cvt.rna.tf32.f32``), every product
hi hi' + lo hi' + hi lo' in float32 sums, the cumulative sums row after row
in float32 (``ref.seq_cumsum``), the blocks in the order
``ssd_scan.work_list`` gives.  ``ref.ssd_intra_chunk_tiles_ref`` is the
plain twin of that arithmetic.  Checked here: (1) the twin against the JAX
package's Pallas ``ssd_intra_chunk`` in interpret mode on
``test_torch_ssd.py``'s cases, and against ``ref.ssd_intra_chunk_ref``, at
K4's 2e-4; (2) ``round_tf32`` on chosen bit patterns; (3) the work list
covers every output tile once, heaviest first; (4) one TF32 pass breaks
the 2e-4 contract at the serving widths and three do not; (5) the
wrapper's layout for TMA pads and copies only what needs it.  Inputs are
seeded numpy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_intra_chunk as j_intra  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

from test_torch_ssd import CASES, TOL  # noqa: E402


def _chunked(seed, b, s, h, p, g, n, chunk, x_scale=1.0, dA_scale=0.1):
    """The intra-chunk step's inputs for a scan of s tokens in chunks, s
    padded with zeros to whole chunks as ``ops.ssd_chunked_kernel`` does."""
    rng = np.random.default_rng(seed)
    q = min(chunk, s)
    nc = -(-s // q)

    def chunks(a):
        pad = np.zeros((b, nc * q - s) + a.shape[2:], np.float32)
        return np.concatenate([a, pad], 1).reshape((b, nc, q) + a.shape[2:])

    x = rng.normal(size=(b, s, h, p)).astype(np.float32) * x_scale
    dA = (-np.abs(rng.normal(size=(b, s, h))) * dA_scale).astype(np.float32)
    Bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return [chunks(a) for a in (x, dA, Bm, Cm)]


def _share(got, want, tol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (tol + tol * np.abs(want))))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_tiles_twin_matches_pallas(b, s, h, p, g, n, chunk):
    """(1) The twin against the Pallas kernel in interpret mode."""
    arrays = _chunked(s + h, b, s, h, p, g, n, chunk)
    y1, s1 = ref.ssd_intra_chunk_tiles_ref(*map(torch.from_numpy, arrays))
    y2, s2 = j_intra(*map(jnp.asarray, arrays), interpret=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y2), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s2), **TOL)


@pytest.mark.parametrize("b,nc,q,h,p,g,n", [
    (1, 2, 256, 4, 64, 1, 128),    # the serving widths, whole tiles
    (1, 1, 320, 2, 64, 1, 32),     # two windows of 256 columns j
    (2, 1, 200, 3, 20, 1, 12),     # q off the 64 grid, P and N off 8
    (1, 1, 16, 2, 8, 2, 8),        # q below one tile, one head a group
])
def test_tiles_twin_matches_plain_version(b, nc, q, h, p, g, n):
    """(1) The twin and ``ssd_intra_chunk_ref`` compute one function: they
    differ by TF32's split, the order of the sums and L's exp."""
    arrays = _chunked(q + p, b, nc * q, h, p, g, n, q)
    ts = list(map(torch.from_numpy, arrays))
    y1, s1 = ref.ssd_intra_chunk_tiles_ref(*ts)
    y2, s2 = ref.ssd_intra_chunk_ref(*ts)
    torch.testing.assert_close(y1, y2, **TOL)
    torch.testing.assert_close(s1, s2, **TOL)


@pytest.mark.parametrize("dA_scale", [10.0, 100.0])
def test_strong_decay_gives_no_nan_in_the_twin(dA_scale):
    """L underflows to 0 far below the diagonal and exp overflows above
    it; the select keeps both out of the sums.  At dA x 10 the twin agrees
    with the plain version; at x 100 the sums reach -2000, where float32
    keeps 1e-4 of absolute precision, and the plain version's sums on the
    CPU (float32 summed in double) differ from the twin's (row after row
    in float32, as the card's plain version sums) by more than 2e-4 of L."""
    arrays = _chunked(4, 1, 256, 2, 8, 1, 8, 256, dA_scale=dA_scale)
    ts = list(map(torch.from_numpy, arrays))
    y, st = ref.ssd_intra_chunk_tiles_ref(*ts)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    cs = torch.cumsum(ts[1].double(), dim=2)
    assert (cs[0, 0, -1] - cs[0, 0, 0] < -104).all()  # exp underflows to 0
    if dA_scale == 10.0:
        y2, s2 = ref.ssd_intra_chunk_ref(*ts)
        torch.testing.assert_close(y, y2, **TOL)
        torch.testing.assert_close(st, s2, **TOL)


@pytest.mark.parametrize("bits, want", [
    (0x3F800000, 0x3F800000),   # 1.0 is TF32
    (0x3F800FFF, 0x3F800000),   # below half an ulp: down
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0x3F803000, 0x3F804000),   # a tie above an odd ulp: away, not even
    (0x3FFFF000, 0x40000000),   # the carry enters the exponent: 2.0
    (0x7F7FFFFF, 0x7F800000),   # the largest float rounds to inf
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
    (0x00001FFF, 0x00002000),   # a subnormal rounds, it is not flushed
])
def test_round_tf32_bit_patterns(bits, want):
    """(2) ``round_tf32`` clears the low 13 bits, to nearest, ties away."""
    a = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = ref.round_tf32(a).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, hex(got)


def test_round_tf32_keeps_nan_and_split_is_exact():
    a = torch.tensor([float("nan"), 3.0e-3, -7.25, 1.0e30])
    assert torch.isnan(ref.round_tf32(a)[0])
    hi, lo = ref.split_tf32(a[1:])
    assert torch.equal(ref.round_tf32(hi), hi) and torch.equal(ref.round_tf32(lo), lo)
    err = (hi.double() + lo.double() - a[1:].double()).abs()
    assert (err <= a[1:].double().abs() * 2.0 ** -21).all()


def test_seq_cumsum_is_row_after_row_in_float32():
    a = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 300)).astype(np.float32))
    want = torch.empty_like(a)
    run = torch.zeros(3)
    for k in range(300):
        run = run + a[:, k]
        want[:, k] = run
    assert torch.equal(ref.seq_cumsum(a), want)


@pytest.mark.parametrize("bnc,groups,heads,q,n,p", [
    (8, 1, 80, 256, 128, 64),     # mamba2-2.7b's serving shape
    (8, 1, 80, 256, 64, 64),      # zamba2's (N = 64)
    (2, 2, 8, 1000, 128, 64),     # q past one window, two groups
    (3, 4, 16, 100, 20, 72),      # P > 64: subsets of 4 heads
    (1, 1, 3, 16, 8, 8),          # one tile of each kind, a short subset
])
def test_work_list_covers_every_tile_once_heaviest_first(bnc, groups, heads,
                                                         q, n, p):
    """(3) Every (chunk, head, 64-row tile) of y and of the states in
    exactly one block, the blocks' j tiles non-increasing."""
    hs = ssd_scan.HEADS if p <= 64 else ssd_scan.HEADS // 2
    r, ni, nn = heads // groups, -(-q // 64), -(-n // 64)
    seen = {}
    blocks = ssd_scan.work_list(bnc, groups, heads, q, n, p)
    weights = []
    for kind, tile, bc, g, sub in blocks:
        weights.append(tile + 1 if kind == "y" else ni)
        for h in range(g * r + sub * hs, min(g * r + (sub + 1) * hs, (g + 1) * r)):
            key = (kind, tile, bc, h)
            seen[key] = seen.get(key, 0) + 1
    want = {("y", t, bc, h) for t in range(ni) for bc in range(bnc) for h in range(heads)}
    want |= {("state", t, bc, h) for t in range(nn) for bc in range(bnc) for h in range(heads)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert weights == sorted(weights, reverse=True)
    assert len(blocks) == bnc * groups * -(-r // hs) * (ni + nn)


def _f64(x, dA, Bm, Cm):
    """The intra-chunk step in float64 (numpy), the truth the passes are
    measured against."""
    x, dA, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dA, Bm, Cm))
    q, r = x.shape[2], x.shape[3] // Bm.shape[3]
    cs = np.cumsum(dA, axis=2)
    tri = np.tril(np.ones((q, q), bool))[None, None, :, :, None]
    L = np.where(tri, np.exp(np.minimum(cs[:, :, :, None] - cs[:, :, None], 0.0)), 0.0)
    S = np.repeat(np.einsum("bcign,bcjgn->bcijg", Cm, Bm), r, axis=4)
    y = np.einsum("bcijh,bcjhp->bcihp", S * L, x)
    w = np.exp(cs[:, :, -1:] - cs)
    st = np.einsum("bcjhn,bcjhp->bchnp", np.repeat(Bm, r, axis=3), x * w[..., None])
    return y, st


@pytest.mark.parametrize("passes, breaks", [(1, True), (3, False)])
def test_one_tf32_pass_breaks_the_contract_three_do_not(passes, breaks,
                                                        monkeypatch):
    """(4) One chunk at the serving widths (q 256, N 128, P 64, 8 heads):
    one TF32 pass (the twin with every lo part 0) is far outside 2e-4 of
    float64, three are inside."""
    if passes == 1:
        monkeypatch.setattr(ref, "split_tf32", lambda a: (
            ref.round_tf32(a), torch.zeros_like(a, dtype=torch.float32)))
    arrays = _chunked(24, 1, 256, 8, 64, 1, 128, 256)
    y, st = ref.ssd_intra_chunk_tiles_ref(*map(torch.from_numpy, arrays))
    y64, st64 = _f64(*arrays)
    share = max(_share(y.numpy(), y64), _share(st.numpy(), st64))
    assert (share > 10.0) if breaks else (share < 1.0), share


@pytest.mark.parametrize("p, n, pads", [(64, 128, False), (24, 20, False),
                                        (6, 10, True), (127, 128, True),
                                        (64, 3, True)])
def test_kernel_layout_pads_to_tma_rows(p, n, pads):
    """(5) P and N padded with zeros to multiples of 4, nothing else
    copied; the padding is zeros, so the padded outputs are the real ones
    and zeros."""
    x, dA, Bm, Cm = map(torch.from_numpy, _chunked(7, 1, 40, 2, p, 1, n, 40))
    xk, dAk, Bk, Ck = ssd_scan.kernel_layout(x, dA, Bm, Cm)
    assert xk.shape[-1] == p + (-p % 4) and Bk.shape[-1] == n + (-n % 4)
    assert (xk is x) != pads or p % 4 == 0
    assert dAk is dA and all(t.is_contiguous() for t in (xk, Bk, Ck))
    assert torch.equal(xk[..., :p], x) and not xk[..., p:].any()
    assert torch.equal(Ck[..., :n], Cm) and not Ck[..., n:].any()
    y, st = ref.ssd_intra_chunk_ref(xk, dAk, Bk, Ck)
    y0, st0 = ref.ssd_intra_chunk_ref(x, dA, Bm, Cm)
    torch.testing.assert_close(y[..., :p], y0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(st[..., :n, :p], st0, atol=1e-5, rtol=1e-5)
    assert not y[..., p:].any() and not st[..., n:, :].any()


def test_kernel_layout_copies_a_view_off_the_16_byte_grid():
    x, dA, Bm, Cm = map(torch.from_numpy, _chunked(8, 1, 32, 2, 8, 1, 8, 32))
    flat = torch.zeros(Bm.numel() + 1)
    off = flat[1:].view(Bm.shape)
    off.copy_(Bm)
    assert off.data_ptr() % 16
    _, _, Bk, Ck = ssd_scan.kernel_layout(x, dA, off, Cm)
    assert Bk.data_ptr() % 16 == 0 and torch.equal(Bk, Bm) and Ck is Cm
