// Mamba-2 SSD intra-chunk step, for Hopper.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/ssd_scan.py (ssd_intra_chunk, body _ssd_kernel).  Per
// (batch b, chunk c, head h), with g = h / (H / G) the head's B/C group and
// the chunk's q positions:
//
//   cs     = cumsum(dA)                                        (q,)
//   L[i,j] = exp(cs_i - cs_j) if i >= j else 0                 (q, q)
//   y      = ((C B^T) o L) x                                   (q, P)
//   state  = B^T (x o exp(cs_last - cs))                       (N, P)
//
// x, y (B, NC, q, H, P); dA (B, NC, q, H); B, C (B, NC, q, G, N); states
// (B, NC, H, N, P); all float32 and C-contiguous.  L is a select, never a
// product with a 0/1 mask: exp(cs_i - cs_j) above the diagonal can overflow
// to inf, and inf * 0 is NaN.
//
// Bound: at the serving path's shape (S = 2048 in chunks of q = 256, H = 80,
// P = 64, G = 1, N = 128) the least work is C B^T once per (batch, chunk,
// group) and lower triangles only -- 5.4 GFLOP at the float32 rate of the
// CUDA cores (67 TFLOP/s: 0.081 ms), above the 108 MB of inputs and outputs
// (0.032 ms).  TF32 tensor cores would break the 2e-4 contract.  This first
// version keeps the TPU grid and recomputes C B^T in every head program of a
// group: with G = 1 that is 80 times per chunk, about 2.3 times the least
// work overall.  Sharing C B^T across a group's heads is the first lever for
// a redesign.
//
// Design: a score tile of q x q floats is 256 KiB at q = 256, more than a
// block may hold, so the rows are tiled.  One block of 128 threads per
// (b, c, h) and per row tile of 64: blocks with blockIdx.y < ceil(q / 64)
// own 64 rows of y and walk the j tiles up to the diagonal (C tile kept,
// B and x tiles staged, 64 x 64 scores per step); blocks past that own 64
// rows n of the state and walk every j tile.  Every block first takes the
// chunk's cumulative sum of dA, in order.  Each thread keeps an
// 8 x ceil(P/16) patch of its 64 x P output in registers.  Rows past q and
// columns past P or N are read as zeros and never written.
//
// The entry point launches on the caller's stream, synchronises nothing,
// allocates nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape it does not serve) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // rows of a tile (i, j or n)
constexpr int kThreads = 128;  // thread (ty, tx) = (tid / 16, tid % 16)

size_t smem_bytes(long long q, long long P, long long N) {
  // cs, C tile, B tile, x tile, score tile
  return sizeof(float) * (q + 2 * kT * (N + 1) + kT * P + kT * (kT + 1));
}

// acc[a][k] += sum_jj s[ty + 8a][jj] * x[jj][tx + 16k], a 64 x 64 by
// 64 x P tile product.
template <int NP>
__device__ __forceinline__ void tile_product(float (&acc)[8][NP],
                                             const float* s_s, const float* x_s,
                                             int P, int ty, int tx) {
#pragma unroll 4
  for (int jj = 0; jj < kT; ++jj) {
    float sv[8], xv[NP];
#pragma unroll
    for (int a = 0; a < 8; ++a) sv[a] = s_s[(ty + 8 * a) * (kT + 1) + jj];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int p = tx + 16 * k;
      xv[k] = p < P ? x_s[jj * P + p] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int k = 0; k < NP; ++k) acc[a][k] = fmaf(sv[a], xv[k], acc[a][k]);
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                       const float* __restrict__ Bm, const float* __restrict__ Cm,
                       float* __restrict__ y, float* __restrict__ st,
                       int H, int G, int q, int P, int N, int n_itiles) {
  extern __shared__ float smem[];
  const int NL = N + 1;
  float* cs = smem;                 // [q]
  float* c_s = cs + q;              // [kT][NL]
  float* b_s = c_s + kT * NL;       // [kT][NL]
  float* x_s = b_s + kT * NL;       // [kT][P]
  float* s_s = x_s + kT * P;        // [kT][kT + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bch = blockIdx.x;       // (b * NC + c) * H + h
  const int h = (int)(bch % H);
  const long long bc = bch / H;
  const int g = h / (H / G);

  const float* xp = x + bc * q * H * P + (long long)h * P;      // row i: + i*H*P
  const float* dap = dA + bc * q * H + h;                       // row i: + i*H
  const float* bp = Bm + bc * q * G * N + (long long)g * N;     // row i: + i*G*N
  const float* cp = Cm + bc * q * G * N + (long long)g * N;

  // cs = cumsum(dA) over the chunk, summed left to right in float32 by one
  // thread.  L and the state decay use differences cs_i - cs_j of sums of
  // up to q terms, which carry those sums' rounding (|cs| reaches tens at
  // q = 256), so the order is the plain sequential one rather than a tree.
  for (int i = tid; i < q; i += kThreads) cs[i] = dap[(long long)i * H];
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < q; ++i) {
      run += cs[i];
      cs[i] = run;
    }
  }
  __syncthreads();

  float acc[8][NP];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int k = 0; k < NP; ++k) acc[a][k] = 0.f;

  if ((int)blockIdx.y < n_itiles) {
    // ---- y rows i0 .. i0 + 63
    const int i0 = blockIdx.y * kT;
    for (int idx = tid; idx < kT * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      const int i = i0 + r;
      c_s[r * NL + n] = i < q ? cp[(long long)i * G * N + n] : 0.f;
    }
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        const int j = j0 + r;
        b_s[r * NL + n] = j < q ? bp[(long long)j * G * N + n] : 0.f;
      }
      for (int idx = tid; idx < kT * P; idx += kThreads) {
        const int r = idx / P, p = idx % P;
        const int j = j0 + r;
        x_s[r * P + p] = j < q ? xp[(long long)j * H * P + p] : 0.f;
      }
      __syncthreads();
      float s[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[a][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) cv[a] = c_s[(ty + 8 * a) * NL + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = b_s[(tx + 16 * k) * NL + n];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[a][k] = fmaf(cv[a], bv[k], s[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = ty + 8 * a, i = i0 + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = tx + 16 * k, j = j0 + c;
          s_s[r * (kT + 1) + c] =
              (i < q && j < q && i >= j) ? s[a][k] * expf(cs[i] - cs[j]) : 0.f;
        }
      }
      __syncthreads();
      tile_product<NP>(acc, s_s, x_s, P, ty, tx);
      __syncthreads();  // before the next tiles overwrite b_s, x_s, s_s
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = i0 + ty + 8 * a;
      if (i >= q) continue;
      float* yp = y + bc * q * H * P + ((long long)i * H + h) * P;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int p = tx + 16 * k;
        if (p < P) yp[p] = acc[a][k];
      }
    }
  } else {
    // ---- state rows n0 .. n0 + 63: state[n][p] = sum_j B[j][n] w_j x[j][p]
    const int n0 = ((int)blockIdx.y - n_itiles) * kT;
    const float cs_last = cs[q - 1];
    for (int j0 = 0; j0 < q; j0 += kT) {
      for (int idx = tid; idx < kT * kT; idx += kThreads) {
        const int jj = idx / kT, nn = idx % kT;  // read along n, store transposed
        const int j = j0 + jj, n = n0 + nn;
        s_s[nn * (kT + 1) + jj] =
            (j < q && n < N) ? bp[(long long)j * G * N + n] * expf(cs_last - cs[j])
                             : 0.f;
      }
      for (int idx = tid; idx < kT * P; idx += kThreads) {
        const int r = idx / P, p = idx % P;
        const int j = j0 + r;
        x_s[r * P + p] = j < q ? xp[(long long)j * H * P + p] : 0.f;
      }
      __syncthreads();
      tile_product<NP>(acc, s_s, x_s, P, ty, tx);
      __syncthreads();
    }
    float* sp = st + (bc * H + h) * (long long)N * P;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int n = n0 + ty + 8 * a;
      if (n >= N) continue;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int p = tx + 16 * k;
        if (p < P) sp[(long long)n * P + p] = acc[a][k];
      }
    }
  }
}

template <int NP>
cudaError_t launch(const float* x, const float* dA, const float* Bm,
                   const float* Cm, float* y, float* st, long long B,
                   long long NC, long long q, long long H, long long P,
                   long long G, long long N, cudaStream_t stream) {
  const size_t smem = smem_bytes(q, P, N);
  auto kernel = ssd_intra_chunk_kernel<NP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_itiles = (int)((q + kT - 1) / kT);
  const int n_ntiles = (int)((N + kT - 1) / kT);
  dim3 grid((unsigned)(B * NC * H), (unsigned)(n_itiles + n_ntiles));
  kernel<<<grid, kThreads, smem, stream>>>(x, dA, Bm, Cm, y, st, (int)H, (int)G,
                                           (int)q, (int)P, (int)N, n_itiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, NC, q, H, P), dA (B, NC, q, H), Bm/Cm (B, NC, q, G, N) in;
// y (B, NC, q, H, P), states (B, NC, H, N, P) out; float32, C-contiguous.
// P and N in [1, 128]; H a multiple of G; all extents > 0; the shared
// memory of one block (q + 2 * 64 * (N + 1) + 64 * P + 64 * 65 floats)
// within the card's 227 KB.
int wlk_ssd_intra_chunk(const float* x, const float* dA, const float* Bm,
                        const float* Cm, float* y, float* st, long long B,
                        long long NC, long long q, long long H, long long P,
                        long long G, long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || NC < 1 || q < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 ||
      P > 128 || N < 1 || N > 128 || B * NC * H > 0x7fffffffLL ||
      smem_bytes(q, P, N) > 232448)
    return cudaErrorInvalidValue;
  switch ((P + 15) / 16) {
    case 1: return launch<1>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    case 2: return launch<2>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    case 3: return launch<3>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    case 4: return launch<4>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    case 5: return launch<5>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    case 6: return launch<6>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    case 7: return launch<7>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    case 8: return launch<8>(x, dA, Bm, Cm, y, st, B, NC, q, H, P, G, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
