"""K4's numerics emulated on the CPU: why 3xTF32, why grouped sums, why
the cumulative sums go row after row.

    python3 tools/k4_emulate.py [--heads 8] [--seed 3]

Prints three tables, each against a float64 reference (numpy):

1. One chunk at the serving widths (q 256, N 128, P 64), the largest
   share of the 2e-4 limit of y and the states, for float32 products, one
   TF32 pass and 3xTF32 (the split of ``repro_torch.kernels.ref``).
2. The error of C B^T (64 x 64 rows, K = N) when the tensor cores' sum is
   rounded to nearest or toward zero after each wgmma instruction (three
   per k8 step), in one accumulator or in partial sums of one box (4 k8
   steps) added in float32, with the small products issued first.
3. y of one chunk (``heads`` heads) computed in the kernel's order and
   rounding, against the plain version's float32 (torch.cumsum's order on
   the card: row after row) and against float64, with the cumulative sums
   row after row or by a Hillis-Steele scan of 32-row pieces.

Runs in about a minute; nothing here needs a card.
"""

from __future__ import annotations

import argparse

import numpy as np


def rna(a):
    """float32 a rounded to TF32, to nearest, ties away from zero."""
    b = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((b + 0x1000) & -0x2000).view(np.float32)


def rz32(x):
    """float64 x to float32, toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tf32_chain(a, b, box, rz, small_first):
    """a (m, k) b (k, n) in 3xTF32, k8 step by k8 step, each of the three
    products one instruction whose float32 sum is rounded (toward zero if
    ``rz``); a fresh accumulator every ``box`` steps (0: one for all),
    added to the total in float32."""
    ah, bh = rna(a), rna(b)
    al, bl = rna(a - ah), rna(b - bh)
    rnd = rz32 if rz else (lambda x: x.astype(np.float32))
    tot = np.zeros((a.shape[0], b.shape[1]), np.float32)
    d = np.zeros_like(tot)
    steps = range(0, a.shape[1], 8)
    for i, s in enumerate(steps):
        sl = slice(s, s + 8)
        terms = [(al, bh), (ah, bl), (ah, bh)] if small_first else \
            [(ah, bh), (al, bh), (ah, bl)]
        for x, y in terms:
            d = rnd(d.astype(np.float64) + x[:, sl].astype(np.float64)
                    @ y[sl].astype(np.float64))
        if box and (i + 1) % box == 0:
            tot, d = (tot + d).astype(np.float32), np.zeros_like(d)
    return (tot + d).astype(np.float32)


def seq_cumsum(a):
    out, c = np.empty_like(a), np.zeros(a.shape[:-1], np.float32)
    for k in range(a.shape[-1]):
        c = (c + a[..., k]).astype(np.float32)
        out[..., k] = c
    return out


def warp_cumsum(a):
    q = a.shape[-1]
    v = a.reshape(a.shape[:-1] + (q // 32, 32)).copy()
    for d in (1, 2, 4, 8, 16):
        sh = np.zeros_like(v)
        sh[..., d:] = v[..., :-d]
        v = (v + sh).astype(np.float32)
    out, c = np.empty_like(v), np.zeros(a.shape[:-1], np.float32)
    for k in range(q // 32):
        out[..., k, :] = (v[..., k, :] + c[..., None]).astype(np.float32)
        c = out[..., k, 31]
    return out.reshape(a.shape)


def share(got, want):
    return float(np.max(np.abs(got - want) / (2e-4 + 2e-4 * np.abs(want))))


def inputs(rng, q, n, p, h):
    x = rng.normal(size=(h, q, p)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(h, q))) * 0.1).astype(np.float32)
    B = rng.normal(size=(q, n)).astype(np.float32)
    C = rng.normal(size=(q, n)).astype(np.float32)
    return x, dA, B, C


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    q, n, p, h = 256, 128, 64, args.heads
    tri = np.tril(np.ones((q, q), bool))
    x, dA, B, C = inputs(rng, q, n, p, h)
    cs64 = np.cumsum(dA.astype(np.float64), axis=1)
    L64 = np.where(tri, np.exp(cs64[:, :, None] - cs64[:, None, :]), 0)
    S64 = C.astype(np.float64) @ B.T.astype(np.float64)
    y64 = (S64[None] * L64) @ x.astype(np.float64)
    w64 = np.exp(cs64[:, -1:] - cs64)
    st64 = np.einsum("jn,hjp->hnp", B.astype(np.float64), x * w64[..., None])

    print("1. one chunk, largest share of the 2e-4 limit (y, states)")
    L = L64.astype(np.float32)
    for name, f in (("float32", lambda a: a),
                    ("one TF32 pass", rna),
                    ("3xTF32", None)):
        if f is None:
            def mm(a, b):
                ah, bh = rna(a), rna(b)
                return ah @ bh + rna(a - ah) @ bh + ah @ rna(b - bh)
        else:
            def mm(a, b, f=f):
                return f(a) @ f(b)
        S = mm(C, B.T)
        y = np.stack([mm(S * L[k], x[k]) for k in range(h)])
        st = np.stack([mm(B.T, x[k] * w64[k, :, None].astype(np.float32))
                       for k in range(h)])
        print(f"   {name:14s} {share(y, y64):10.3f} {share(st, st64):10.3f}")

    print("2. C B^T, 64 x 64, largest absolute error")
    for k in (128, 256):
        a = rng.normal(size=(64, k)).astype(np.float32)
        b = rng.normal(size=(k, 64)).astype(np.float32)
        ex = a.astype(np.float64) @ b.astype(np.float64)
        row = {"float32": np.abs(a @ b - ex).max()}
        for label, box, rz, small in (("nearest, one acc", 0, False, False),
                                      ("toward 0, one acc", 0, True, False),
                                      ("toward 0, per box", 4, True, False),
                                      ("toward 0, per box, small first", 4, True, True)):
            row[label] = np.abs(tf32_chain(a, b, box, rz, small) - ex).max()
        print(f"   K = {k}: " + "; ".join(f"{l} {v:.2e}" for l, v in row.items()))

    print("3. y of one chunk in the kernel's order: largest share against "
          "the float32 plain version and against float64")
    tri32 = tri
    plain_cs = seq_cumsum(dA)
    Lp = np.where(tri32, np.exp(plain_cs[:, :, None] - plain_cs[:, None, :]), 0)
    y_plain = ((C @ B.T)[None] * Lp).astype(np.float32) @ x
    print(f"   plain float32 against float64: {share(y_plain, y64):.3f}")
    for name, cs in (("row after row", seq_cumsum(dA)),
                     ("warp scan", warp_cumsum(dA))):
        S = np.zeros((q, q), np.float32)
        for it in range(4):
            for jt in range(it + 1):
                S[it * 64:(it + 1) * 64, jt * 64:(jt + 1) * 64] = tf32_chain(
                    B[jt * 64:(jt + 1) * 64], C[it * 64:(it + 1) * 64].T,
                    4, True, True).T
        arg = (cs[:, :, None] - cs[:, None, :]).astype(np.float32)
        e = np.exp2((arg * np.float32(1.4426950408889634)).astype(np.float64))
        SL = np.where(tri32, S[None] * e.astype(np.float32), 0).astype(np.float32)
        y = np.zeros((h, q, p), np.float32)
        for it in range(4):
            tot = np.zeros((h, 64, p), np.float32)
            for jt in range(it + 1):
                for k in range(h):
                    tot[k] = (tot[k] + tf32_chain(
                        x[k, jt * 64:(jt + 1) * 64].T,
                        SL[k, it * 64:(it + 1) * 64, jt * 64:(jt + 1) * 64].T,
                        8, True, True).T).astype(np.float32)
            y[:, it * 64:(it + 1) * 64] = tot
        print(f"   {name:14s} against plain {share(y, y_plain):.3f}, "
              f"against float64 {share(y, y64):.3f}")


if __name__ == "__main__":
    main()
