"""K3's tile contract, on the CPU.

The CUDA kernels skip whole k tiles and mask the rest: which tiles a q tile
runs is ``flash_attention.k_tile_range`` (the TPU kernel's two block-skip
tests, restated for the kernels' tiles), and ``ref.flash_attention_tiles_ref``
is the plain twin of a kernel in its own order of operations (float32 scale
after the product, the finite -1e30 mask, the online correction, the bf16
weights and the row sum over them).  Checked here: (1) the skip test drops
no unmasked (query, key) pair and runs every tile that holds one; (2) the
twin agrees with the JAX package's ``flash_attention_bhsd`` (its Pallas
kernel in interpret mode, with its own (256, 512) blocks) within K3's
tolerances; (3) the cases reach the edges the kernels must get right.
Inputs are seeded numpy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# (atol, rtol) of chip_smoke.py's FA_TOL: float32, and one bf16 ulp (2^-7
# of the magnitude) plus a floor; the twin rounds its weights to bf16, the
# JAX kernel does not, which stays well inside the bf16 limit
FA_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (4e-3, 8e-3)}

# (B, Sq, Sk, H, KV, D, causal, window)
CASES = [
    (1, 256, 256, 2, 2, 32, True, 0),       # whole tiles, MHA
    (1, 300, 300, 4, 2, 64, True, 0),       # ragged Sq and Sk, GQA rep 2
    (2, 129, 129, 6, 2, 16, True, 0),       # one row past a tile, B = 2, rep 3
    (1, 127, 127, 8, 1, 48, True, 0),       # one row short of a tile, MQA
    (1, 1, 1, 4, 4, 16, True, 0),           # a single query
    (1, 200, 333, 3, 1, 32, False, 0),      # non-causal, Sq < Sk
    (1, 333, 200, 2, 2, 80, False, 0),      # non-causal, Sq > Sk
    (1, 300, 300, 2, 1, 32, True, 1),       # window of one key
    (1, 300, 300, 4, 2, 16, True, 100),     # window narrower than a tile
    (1, 300, 300, 2, 2, 96, True, 128),     # window of one tile
    (1, 400, 400, 3, 3, 16, True, 300),     # window wider than a tile
    (1, 257, 257, 8, 8, 128, True, 64),     # D = 128, a half-tile window
]
IDS = ["x".join(map(str, c[:6])) + ("-causal" if c[6] else "") +
       (f"-w{c[7]}" if c[7] else "") for c in CASES]


def _mask(sq, sk, causal, window):
    """The reference's mask: query i sees key j (positions from 0)."""
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= j <= i
    if window:
        m &= j > i - window
    return m


def _qkv(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


def _runs(case, tiles):
    """For each q tile: (q0, the set of k tiles it runs, its mask rows)."""
    _, sq, sk, _, _, _, causal, window = case
    bq, bk = tiles
    mask = _mask(sq, sk, causal, window)
    for q0 in range(0, sq, bq):
        lo, hi = fa.k_tile_range(q0, bq, bk, sk, causal, window)
        yield q0, set(range(lo, hi)), mask[q0:q0 + bq]


@pytest.mark.parametrize("tiles", [fa.BF16_TILES, fa.F32_TILES, (64, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_skipped_tiles_hold_no_unmasked_pair(case, tiles):
    """(1) A k tile that ``k_tile_range`` skips holds no (i, j) the mask
    keeps, and every kept (i, j) lies in a tile it runs."""
    bk = tiles[1]
    for q0, run, rows in _runs(case, tiles):
        nk = -(-case[2] // bk)
        for kt in range(nk):
            kept = rows[:, kt * bk:(kt + 1) * bk].any()
            if kt not in run:
                assert not kept, (q0, kt)
        assert run <= set(range(nk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiles_twin_matches_jax(case, dtype):
    """(2) The tiled twin, at its kernel's tile sizes, against the JAX
    package's Pallas kernel in interpret mode."""
    b, sq, sk, h, kv, d, causal, window = case
    arrays = _qkv(sq + 7 * d + h, b, sq, sk, h, kv, d)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    q, k, v = (jnp.asarray(a, jd).transpose(0, 2, 1, 3) for a in arrays)
    want = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                interpret=True)
    want = np.asarray(want.transpose(0, 2, 1, 3).astype(jnp.float32))
    got = ref.flash_attention_tiles_ref(
        *(torch.from_numpy(a).to(td) for a in arrays), causal=causal,
        window=window)
    assert got.dtype == td and got.shape == (b, sq, h, d)
    atol, rtol = FA_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiles_twin_agrees_with_the_plain_version(dtype):
    """The twin and ``flash_attention_ref`` compute one function: in
    float32 they differ by the order of the sums, in bf16 also by the
    twin's rounded weights."""
    case = CASES[8]
    b, sq, sk, h, kv, d, causal, window = case
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(td)
               for a in _qkv(11, b, sq, sk, h, kv, d))
    got = ref.flash_attention_tiles_ref(q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    atol, rtol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_cases_reach_the_edges():
    """(3) At the bf16 kernel's tiles the cases hold a row wholly masked
    inside a tile that runs (the -1e30 erasure), ragged Sq and Sk, and
    windows narrower than a tile."""
    bq, bk = fa.BF16_TILES
    wholly_masked = ragged_q = ragged_k = narrow = False
    for case in CASES:
        _, sq, sk, _, _, _, causal, window = case
        ragged_q |= sq % bq != 0
        ragged_k |= sk % bk != 0
        narrow |= 0 < window < bk
        for _, run, rows in _runs(case, fa.BF16_TILES):
            for kt in run:
                tile = rows[:, kt * bk:(kt + 1) * bk]
                wholly_masked |= bool((~tile.any(axis=1)).any())
    assert wholly_masked and ragged_q and ragged_k and narrow


def test_a_wholly_masked_row_is_erased():
    """A window of 100 keys: rows 228.. of the second q tile see nothing
    in k tile 0, which runs for the tile's first rows; the later tile's
    correction erases those rows' weights of 1, as the reference's -1e30
    does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 256, 256, 1, 1, 16))
    assert fa.k_tile_range(128, 128, 128, 256, True, 100) == (0, 2)
    got = ref.flash_attention_tiles_ref(q, k, v, True, 100)
    want = ref.flash_attention_ref(q, k, v, True, 100)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("q0, bq, bk, sk, causal, window, want", [
    (0, 128, 128, 2048, True, 0, (0, 1)),
    (1920, 128, 128, 2048, True, 0, (0, 16)),
    (1920, 128, 128, 2048, False, 0, (0, 16)),
    (1920, 128, 128, 2048, True, 300, (12, 16)),   # keys > 1920 - 300 - 127
    (896, 128, 128, 10, True, 5, (6, 1)),           # empty: past Sk
    (64, 64, 64, 1000, True, 64, (0, 2)),
])
def test_k_tile_range_values(q0, bq, bk, sk, causal, window, want):
    assert fa.k_tile_range(q0, bq, bk, sk, causal, window) == want
