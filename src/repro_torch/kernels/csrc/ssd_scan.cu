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
// (0.032 ms).  TF32 tensor cores would break the 2e-4 contract, so every
// product stays float32.  This design computes C B^T once per (chunk,
// group, 64-row tile, subset of 8 heads) -- 10 times per chunk at H = 80,
// not 80 -- on whole 64 x 64 tiles: about 6.9 GFLOP in all at that shape.
//
// Design: one block per (b, c, g, tile, head subset).  A subset is up to HS
// heads of the group (8 when P <= 64, else 4), and the block has 64 threads
// per head of the subset, so all of a subset's heads run at once, each on
// its own 64 threads.  Blocks of the first kind own 64 rows n of the
// states, the others 64 rows i of y (heaviest row tiles first).  Every
// block first sums each of its heads' dA in order, left to right, one
// thread per head: L and the decay use differences cs_i - cs_j of sums of
// up to q terms, so the order is the plain sequential one, not a tree.
//   y tile i0: S = C[i0:i0+64] B[0:i0+64]^T is computed once into shared
//   memory (stored transposed, j-major; at most 256 columns at a time), from
//   C and B staged 32 columns of n at a time, each thread a 4 x 4 block of
//   float4 dot products.  Then j runs in steps of 16 rows: each head forms
//   its (S o L_h) step in shared memory (one __expf per element: ex2.approx,
//   a few ulp and far cheaper than expf's exact range reduction) while the
//   next step's x rows of every head are copied with cp.async into the
//   other half of a double buffer, and each thread adds the outer products
//   of an 8 x 8 (x NP) block of y_h, fed by float4 loads: 4 loads per 64
//   FMAs at P = 64.
//   state tile n0: j runs over the whole chunk in steps of 16 rows; each
//   step's B rows are staged once for all the subset's heads and its x rows
//   per head (cp.async, double-buffered); each thread adds an 8 x 8 (x NP)
//   block of B^T (w x) with w = exp(cs_last - cs).
// Rows past q are zero-filled by the copies and never written; columns
// past P or N are either zero or feed only outputs that are not written.
// Shared memory is 172 KB at q = 256, P = 64: one block of 512 threads an SM.
//
// The entry point launches on the caller's stream, synchronises nothing,
// allocates nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape it does not serve) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;          // rows of an i tile or an n tile
constexpr int kJT = 16;         // j rows per step of the y and state loops
constexpr int kWJ = 256;        // columns j of S held at once
constexpr int kSLD = kT + 4;    // row stride of S^T (floats)
constexpr int kNC = 32;         // columns n of C and B per staging step
constexpr int kNLD = kNC + 4;   // row stride of staged C and B (floats)

template <int NP>  // NP = ceil(P / 64)
struct Cfg {
  static constexpr int HS = NP == 1 ? 8 : 4;  // heads of a subset
  static constexpr int T = 64 * HS;           // threads of a block
  static constexpr int PP = 64 * NP;          // row stride of x tiles
  static constexpr int JB = T / 256;          // 64-column blocks of S a round
};

// row stride of the cumulative sums: odd, so the head threads' in-order
// sums read distinct banks
__host__ __device__ inline int qstride(int q) { return q % 2 ? q : q + 1; }

template <int NP>
size_t smem_floats(int q) {
  using C = Cfg<NP>;
  return (size_t)kWJ * kSLD                 // S^T  (state blocks: B steps)
         + (size_t)C::HS * kJT * kT         // (S o L_h)^T steps
         + (size_t)2 * C::HS * kJT * C::PP  // x steps (y blocks: C, B staging)
         + (size_t)C::HS * qstride(q)       // cumulative sums
         + C::HS;                           // their last values
}

struct Args {
  const float *x, *dA, *Bm, *Cm;
  float *y, *st;
  int H, G, q, P, N, R, nsub, n_itiles, n_ntiles;
  long long inner;  // blocks of one tile index: B * NC * G * nsub
  int vec_x, vec_out, vec_bc;  // 16-byte copies and stores allowed
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Copy rows r0 .. r0 + rows - 1 (row stride `rs`), columns c0 .. c0 + cols -
// 1 of a float matrix into dst[rows][ld]; rows at or past `rmax` and
// columns at or past `cmax` become zeros.  16-byte copies when `vec` (then
// cols, c0 and cmax are multiples of 4 and the source is aligned).
template <int T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           long long rs, int r0, int rows,
                                           int rmax, int c0, int cols, int cmax,
                                           bool vec, int tid) {
  if (vec) {
    const int c4 = cols / 4;
    for (int idx = tid; idx < rows * c4; idx += T) {
      const int r = idx / c4, c = c0 + 4 * (idx % c4);
      const bool ok = r0 + r < rmax && c < cmax;
      wlk::cp_async16(dst + r * ld + (c - c0),
                      ok ? src + (long long)(r0 + r) * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows * cols; idx += T) {
      const int r = idx / cols, c = c0 + idx % cols;
      dst[r * ld + (c - c0)] =
          r0 + r < rmax && c < cmax ? src[(long long)(r0 + r) * rs + c] : 0.f;
    }
  }
}

// kOneWindow: q <= kWJ, so S is computed once and y's accumulators are not
// live while it is (which keeps them out of local memory at 128 registers)
template <int NP, bool kOneWindow>
__global__ void __launch_bounds__(Cfg<NP>::T, 1)
ssd_intra_chunk_kernel(Args a) {
  using C = Cfg<NP>;
  constexpr int HS = C::HS, T = C::T, PP = C::PP;
  extern __shared__ __align__(16) float smem[];
  const int QS = qstride(a.q);
  float* st_s = smem;                        // [kWJ][kSLD]: S^T, or B steps
  float* sl_s = st_s + kWJ * kSLD;           // [HS][kJT][kT]
  float* x_s = sl_s + HS * kJT * kT;         // [2][HS][kJT][PP]
  float* cs_s = x_s + 2 * HS * kJT * PP;     // [HS][QS]
  float* last_s = cs_s + HS * QS;            // [HS]

  const int tid = threadIdx.x;
  const int hl = tid / 64, t64 = tid % 64;  // head lane, thread in the lane
  const int kcls = (int)(blockIdx.x / a.inner);
  long long rest = blockIdx.x % a.inner;
  const int sub = (int)(rest % a.nsub);
  rest /= a.nsub;
  const int g = (int)(rest % a.G);
  const long long bc = rest / a.G;  // b * NC + c
  const int h0 = g * a.R + sub * HS;
  const int nh = min(HS, a.R - sub * HS);
  const bool active = hl < nh;
  const int q = a.q, H = a.H, P = a.P, N = a.N;
  const bool is_state = kcls < a.n_ntiles;
  const int i0 = is_state ? 0 : (a.n_itiles - 1 - (kcls - a.n_ntiles)) * kT;

  const float* xb = a.x + bc * q * H * P;   // row j, head h: + (j*H + h)*P
  const float* bb = a.Bm + bc * q * a.G * N + (long long)g * N;  // row j: + j*G*N
  const float* cb = a.Cm + bc * q * a.G * N + (long long)g * N;

  // cumulative sums of dA per head, rows 0 .. qlim - 1, in order
  const int qlim = is_state ? q : min(q, i0 + kT);
  for (int idx = tid; idx < HS * qlim; idx += T) {
    const int hh = idx % HS, i = idx / HS;
    cs_s[hh * QS + i] =
        hh < nh ? a.dA[(bc * q + i) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (tid < nh) {
    float* c = cs_s + tid * QS;
    float run = 0.f;
#pragma unroll 8
    for (int i = 0; i < qlim; ++i) {
      run += c[i];
      c[i] = run;
    }
    last_s[tid] = run;
  }
  __syncthreads();

  // copy step j0 .. j0 + 15 of x for every head of the subset into buffer buf
  auto load_x = [&](int j0, int buf) {
    float* dst = x_s + buf * HS * kJT * PP;
    if (a.vec_x) {
      const int p4 = P / 4;
      for (int idx = tid; idx < nh * kJT * p4; idx += T) {
        const int hh = idx / (kJT * p4), r = idx % (kJT * p4);
        const int jj = r / p4, p = 4 * (r % p4);
        const int j = j0 + jj;
        const bool ok = j < q;
        wlk::cp_async16(dst + (hh * kJT + jj) * PP + p,
                        ok ? xb + ((long long)j * H + h0 + hh) * P + p : xb,
                        ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < nh * kJT * P; idx += T) {
        const int hh = idx / (kJT * P), r = idx % (kJT * P);
        const int jj = r / P, p = r % P;
        const int j = j0 + jj;
        dst[(hh * kJT + jj) * PP + p] =
            j < q ? xb[((long long)j * H + h0 + hh) * P + p] : 0.f;
      }
    }
  };

  // thread (tr, tp) of its lane owns rows tr*4 + {0..3} + 32 r (r < 2) and
  // columns tp*4 + {0..3} + 32 c (c < 2 NP) of its head's 64 x P output
  const int tr = t64 / 8, tp = t64 % 8;
  float acc[8][8 * NP];
  auto zero_acc = [&]() {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8 * NP; ++c) acc[r][c] = 0.f;
  };

  if (is_state) {
    zero_acc();
    // ---- states rows n0 .. n0 + 63: sum_j B[j][n] w_j x[j][p]
    const int n0 = kcls * kT;
    for (int idx = tid; idx < nh * q; idx += T) {  // cs -> w = exp(cs_last - cs)
      const int hh = idx / q, j = idx % q;
      cs_s[hh * QS + j] = expf(last_s[hh] - cs_s[hh * QS + j]);
    }
    const int nsteps = (q + kJT - 1) / kJT;
    auto load_step = [&](int step, int buf) {
      const int j0 = step * kJT;
      stage_rows<T>(st_s + buf * kJT * kT, kT, bb, (long long)a.G * N, j0, kJT,
                    q, n0, kT, N, a.vec_bc, tid);
      load_x(j0, buf);
    };
    load_step(0, 0);
    wlk::cp_async_commit();
    for (int step = 0; step < nsteps; ++step) {
      const int buf = step & 1;
      if (step + 1 < nsteps) load_step(step + 1, buf ^ 1);
      wlk::cp_async_commit();
      wlk::cp_async_wait<1>();
      __syncthreads();  // this step's rows (and, first time, w) are in place
      const float* b_s = st_s + buf * kJT * kT;
      const float* xh = x_s + (buf * HS + hl) * kJT * PP;
      const int j0 = step * kJT;
#pragma unroll 4
      for (int jj = 0; jj < kJT; ++jj) {
        const float w = j0 + jj < q ? cs_s[hl * QS + j0 + jj] : 0.f;
        float bv[8], xv[8 * NP];
        const float4 b0 = ld4(b_s + jj * kT + tr * 4);
        const float4 b1 = ld4(b_s + jj * kT + 32 + tr * 4);
        bv[0] = b0.x * w; bv[1] = b0.y * w; bv[2] = b0.z * w; bv[3] = b0.w * w;
        bv[4] = b1.x * w; bv[5] = b1.y * w; bv[6] = b1.z * w; bv[7] = b1.w * w;
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) {
          const float4 v = ld4(xh + jj * PP + 32 * c + tp * 4);
          xv[4 * c] = v.x; xv[4 * c + 1] = v.y; xv[4 * c + 2] = v.z; xv[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8 * NP; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
      }
      __syncthreads();  // before the next step's copies overwrite buf
    }
    if (active) {
      float* sp = a.st + (bc * H + h0 + hl) * (long long)N * P;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = n0 + (r / 4) * 32 + tr * 4 + r % 4;
        if (n >= N) continue;
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) {
          const int p = 32 * c + tp * 4;
          if (p >= P) continue;
          float* o = sp + (long long)n * P + p;
          if (a.vec_out) {
            st4(o, make_float4(acc[r][4 * c], acc[r][4 * c + 1],
                               acc[r][4 * c + 2], acc[r][4 * c + 3]));
          } else {
            for (int v = 0; v < 4 && p + v < P; ++v) o[v] = acc[r][4 * c + v];
          }
        }
      }
    }
    return;
  }

  // ---- y rows i0 .. i0 + 63
  const int jend = min(q, i0 + kT);
  for (int w0 = 0; w0 < jend; w0 += kWJ) {
    const int jw = min(kWJ, jend - w0);
    const int nb = (jw + kT - 1) / kT;  // 64-column blocks of this window

    // S^T[j][i] = C[i0 + i] . B[w0 + j], JB column blocks of 64 a round;
    // task (jb, ti, tj) is a 4 x 4 block: rows ti + 16 u, columns tj + 16 v
    float* c_s = x_s;                   // [kT][kNLD]
    float* b_s = x_s + kT * kNLD;       // [JB * kT][kNLD]
    const int jb = tid / 256, ti = (tid % 256) / 16, tj = tid % 16;
    for (int jb0 = 0; jb0 < nb; jb0 += C::JB) {
      const int rows = min(C::JB, nb - jb0) * kT;
      const bool mine = jb0 + jb < nb;
      float s[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) s[u][v] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kNC) {
        __syncthreads();  // earlier readers of the staging area are done
        stage_rows<T>(c_s, kNLD, cb, (long long)a.G * N, i0, kT, q, n0, kNC, N,
                      a.vec_bc, tid);
        stage_rows<T>(b_s, kNLD, bb, (long long)a.G * N, w0 + jb0 * kT, rows,
                      q, n0, kNC, N, a.vec_bc, tid);
        wlk::cp_async_commit();
        wlk::cp_async_wait<0>();
        __syncthreads();
        if (mine) {
#pragma unroll
          for (int nn = 0; nn < kNC; nn += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) cv[u] = ld4(c_s + (ti + 16 * u) * kNLD + nn);
#pragma unroll
            for (int v = 0; v < 4; ++v)
              bv[v] = ld4(b_s + (jb * kT + tj + 16 * v) * kNLD + nn);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                s[u][v] = fmaf(cv[u].x, bv[v].x, s[u][v]);
                s[u][v] = fmaf(cv[u].y, bv[v].y, s[u][v]);
                s[u][v] = fmaf(cv[u].z, bv[v].z, s[u][v]);
                s[u][v] = fmaf(cv[u].w, bv[v].w, s[u][v]);
              }
          }
        }
      }
      if (mine) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            st_s[((jb0 + jb) * kT + tj + 16 * v) * kSLD + ti + 16 * u] = s[u][v];
      }
    }
    __syncthreads();  // S^T complete; the staging area is free for x
    if (w0 == 0) zero_acc();

    const int nsteps = (jw + kJT - 1) / kJT;
    load_x(w0, 0);
    wlk::cp_async_commit();
    const float* csh = cs_s + hl * QS;
    for (int step = 0; step < nsteps; ++step) {
      const int buf = step & 1;
      const int j0 = w0 + step * kJT;
      if (step + 1 < nsteps) load_x(j0 + kJT, buf ^ 1);
      wlk::cp_async_commit();
      // (S o L_h)^T for rows j0 .. j0 + 15: a select, one exp per element
      float* slh = sl_s + hl * kJT * kT;
      if (active) {
#pragma unroll
        for (int e = 0; e < kJT * kT / 4 / 64; ++e) {
          const int f = t64 + 64 * e;
          const int jj = f / (kT / 4), i4 = 4 * (f % (kT / 4));
          const int j = j0 + jj;
          const float4 sv = ld4(st_s + (j - w0) * kSLD + i4);
          const float csj = j < q ? csh[j] : 0.f;
          const float in[4] = {sv.x, sv.y, sv.z, sv.w};
          float out[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + i4 + u;
            const float csi = csh[i < q ? i : 0];
            out[u] = i < q && j < q && i >= j ? in[u] * __expf(csi - csj) : 0.f;
          }
          st4(slh + jj * kT + i4, make_float4(out[0], out[1], out[2], out[3]));
        }
      }
      wlk::cp_async_wait<1>();
      __syncthreads();  // this step's x and every head's (S o L)^T are in place
      const float* xh = x_s + (buf * HS + hl) * kJT * PP;
#pragma unroll 4
      for (int jj = 0; jj < kJT; ++jj) {
        float sl[8], xv[8 * NP];
        const float4 s0 = ld4(slh + jj * kT + tr * 4);
        const float4 s1 = ld4(slh + jj * kT + 32 + tr * 4);
        sl[0] = s0.x; sl[1] = s0.y; sl[2] = s0.z; sl[3] = s0.w;
        sl[4] = s1.x; sl[5] = s1.y; sl[6] = s1.z; sl[7] = s1.w;
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) {
          const float4 v = ld4(xh + jj * PP + 32 * c + tp * 4);
          xv[4 * c] = v.x; xv[4 * c + 1] = v.y; xv[4 * c + 2] = v.z; xv[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8 * NP; ++c) acc[r][c] = fmaf(sl[r], xv[c], acc[r][c]);
      }
      __syncthreads();  // before the next step overwrites (S o L)^T and buf
    }
    if (kOneWindow) break;
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + (r / 4) * 32 + tr * 4 + r % 4;
      if (i >= q) continue;
      float* yp = a.y + ((bc * q + i) * H + h0 + hl) * (long long)P;
#pragma unroll
      for (int c = 0; c < 2 * NP; ++c) {
        const int p = 32 * c + tp * 4;
        if (p >= P) continue;
        if (a.vec_out) {
          st4(yp + p, make_float4(acc[r][4 * c], acc[r][4 * c + 1],
                                  acc[r][4 * c + 2], acc[r][4 * c + 3]));
        } else {
          for (int v = 0; v < 4 && p + v < P; ++v) yp[p + v] = acc[r][4 * c + v];
        }
      }
    }
  }
}

template <int NP>
cudaError_t launch(Args a, long long n_tiles, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<NP>(a.q);
  void (*kernel)(Args) = ssd_intra_chunk_kernel<NP, false>;
  if (a.q <= kWJ) kernel = ssd_intra_chunk_kernel<NP, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(a.inner * n_tiles), Cfg<NP>::T, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// x (B, NC, q, H, P), dA (B, NC, q, H), Bm/Cm (B, NC, q, G, N) in;
// y (B, NC, q, H, P), states (B, NC, H, N, P) out; float32, C-contiguous.
// P and N in [1, 128]; H a multiple of G; all extents > 0; the shared
// memory of one block (about 4 (44,000 + 8 q) bytes at P <= 64) within
// the card's 227 KB.
int wlk_ssd_intra_chunk(const float* x, const float* dA, const float* Bm,
                        const float* Cm, float* y, float* st, long long B,
                        long long NC, long long q, long long H, long long P,
                        long long G, long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || NC < 1 || q < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 ||
      P > 128 || N < 1 || N > 128 || q > (1 << 20) ||
      sizeof(float) * (P <= 64 ? smem_floats<1>((int)q)
                               : smem_floats<2>((int)q)) > 232448)
    return cudaErrorInvalidValue;
  const int hs = P <= 64 ? Cfg<1>::HS : Cfg<2>::HS;
  Args a;
  a.x = x; a.dA = dA; a.Bm = Bm; a.Cm = Cm; a.y = y; a.st = st;
  a.H = (int)H; a.G = (int)G; a.q = (int)q; a.P = (int)P; a.N = (int)N;
  a.R = (int)(H / G);
  a.nsub = (a.R + hs - 1) / hs;
  a.n_itiles = (int)((q + kT - 1) / kT);
  a.n_ntiles = (int)((N + kT - 1) / kT);
  a.inner = B * NC * G * a.nsub;
  a.vec_x = P % 4 == 0 && aligned16(x);
  a.vec_out = P % 4 == 0 && aligned16(y) && aligned16(st);
  a.vec_bc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const long long n_tiles = a.n_itiles + a.n_ntiles;
  if (a.inner * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  return P <= 64 ? launch<1>(a, n_tiles, s) : launch<2>(a, n_tiles, s);
}

}  // extern "C"
