// Flash attention forward (GQA, causal and/or sliding window), for Hopper.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/flash_attention.py (flash_attention_bhsd, body _fa_kernel):
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / rep, :],
//   s_ij = (q[b, i, h, :] * 1/sqrt(D)) . k[b, j, h / rep, :]
//
// masked to j < Sk, and j <= i when causal, and j > i - window when a window
// is given.  q is (B, Sq, H, D), k/v (B, Sk, KV, D), o like q; any strides
// along B, S and H, unit stride along D, so the wrapper transposes nothing.
// Float32 or bfloat16 in; the scores, the running max m, the running sum l
// and the accumulator stay in float32, and o is rounded to q's type once.
// In bfloat16 the probabilities P are also rounded to bf16 for the P V
// product (about 2^-9 relative per weight).
//
// Semantics kept from the TPU kernel: the 1/sqrt(D) scale is applied in
// float32; masked scores take the finite -1e30, not -inf, so a row that is
// wholly masked inside a tile that runs gives exp(0) = 1 there and a later
// correction exp(m_prev - m_new) = 0 erases it (with -inf the same step
// would be NaN); k tiles wholly above the diagonal or wholly outside the
// window are skipped by the same two tests; the final division takes
// max(l, 1e-30).  The TPU's (256, 512) blocks are layout choices of its
// VMEM and MXU and are not carried over.
//
// Bound: at the serving path's shape (one prompt of S = 2048, H = 24,
// KV = 8, D = 128, bf16, causal) the least work is 4 H D S (S + 1) / 2
// = 25.8 GFLOP against 25 MB of q/k/v/o, so the tensor-core rate bounds it
// (0.026 ms at 989 TFLOP/s bf16).
//
// Two kernels behind one entry point, chosen by dtype (not a fallback):
//
// bfloat16 -- fa_tc_kernel, FlashAttention-2 on the tensor cores.  One
// block of 4 warps per (q tile of 64 rows, head, batch), heaviest (last) q
// tiles launched first; each warp owns 16 q rows.  The q tile and a ring of
// two stages of 64-row k and v tiles are copied into shared memory with
// cp.async (16 bytes a thread), so the next tile's copies overlap this
// tile's products; rows past Sq or Sk are zero-filled by the copy (source
// size 0) and never read.  Shared rows are padded by 16 bytes, an odd
// number of 16-byte chunks, so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups.  Each warp loads its q fragments once with ldmatrix
// and keeps them in registers; S = Q K^T reads K row-major with ldmatrix,
// O += P V reads V with ldmatrix.trans, both with
// mma.sync.m16n8k16.bf16 and float32 accumulators.  S is scaled by
// log2(e)/sqrt(D) in float32 after the product (rounding q * scale to bf16
// would add an error the reference does not have) and the online softmax
// runs in the registers of the C fragments: a row lives in one quad of
// lanes, whose max is taken with two shuffles.  The weights are rounded to
// bf16 once; the row sum adds those rounded weights (so o is a convex
// combination of v rows again, exact where a row sees one key), is kept
// per lane and reduced at the end.  P never touches shared memory: two
// neighbouring n8 score tiles are the A fragment of the P V product.  At D = 128 shared memory is 85 KB (q, two stages of k and
// v), so two blocks share an SM.  The wgmma/TMA/warp-specialised design
// that would reach the full tensor-core rate is later work.
//
// float32 -- fa_fwd_kernel, on the CUDA cores (TF32 would break the 3e-5
// contract).  One block of 128 threads per (q tile of 64 rows, head,
// batch), heaviest first.  The block keeps its q tile, pre-scaled, in
// shared memory, and walks the k tiles of 64 rows: the k tile is staged in
// shared memory, each thread computes an 8 x 4 patch of the 64 x 64
// scores, one warp per 16 rows takes the row max and sum with shuffles,
// then the v tile replaces the k tile and each thread updates its
// 8 x (D/16) patch of the accumulator, held in registers.  Rows of the q
// tile past Sq are computed on zeros and never written; k rows past Sk are
// read as zeros and masked.  Shared memory is 83 KB at D = 128.
//
// The entry point launches on the caller's stream, synchronises nothing,
// allocates nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape it does not serve) so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k rows per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides along (B, S, H); D has stride 1
  long long b, s, h;
};

// ------------------------------------------------------------ float32

template <int ND>
constexpr size_t smem_bytes() {
  // q tile, k-or-v tile (rows padded by one float against bank conflicts),
  // score tile, and the per-row m, l and correction
  return sizeof(float) * (2 * kBQ * (ND * 16 + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

template <int ND>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              Strides qs, Strides ks, Strides vs, Strides os,
              int rep, long long sq, long long sk, int causal,
              long long window, float scale) {
  constexpr int D = ND * 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBQ][LD]
  float* kv_s = q_s + kBQ * LD;        // [kBK][LD]
  float* s_s = kv_s + kBK * LD;        // [kBQ][kBK + 1]
  float* m_s = s_s + kBQ * (kBK + 1);  // [kBQ]
  float* l_s = m_s + kBQ;              // [kBQ]
  float* c_s = l_s + kBQ;              // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const long long nq = (sq + kBQ - 1) / kBQ;
  const long long q0 = (nq - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / rep;

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  float* op = o + b * os.b + h * os.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const long long row = q0 + r;
    q_s[r * LD + d] = row < sq ? qp[row * qs.s + d] * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[8][ND];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

  const long long nk = (sk + kBK - 1) / kBK;
  for (long long kt = 0; kt < nk; ++kt) {
    const long long k0 = kt * kBK;
    // the TPU kernel's block skipping, uniform across the block
    if (causal && k0 > q0 + kBQ - 1) break;
    if (window && !(k0 + kBK - 1 > q0 - window)) continue;

    __syncthreads();  // previous tile's readers of kv_s and s_s are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const long long row = k0 + r;
      kv_s[r * LD + d] = row < sk ? kp[row * ks.s + d] : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = q_s[(ty + 8 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      const long long qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const long long kpos = k0 + c;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s_s[r * (kBK + 1) + c] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();  // scores complete; k tile no longer read

    // v tile replaces the k tile while the warps take the row statistics
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const long long row = k0 + r;
      kv_s[r * LD + d] = row < sk ? vp[row * vs.s + d] : 0.f;
    }
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float* srow = s_s + r * (kBK + 1);
      const float a = srow[lane], bb = srow[lane + 32];
      float mx = fmaxf(a, bb);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pb = expf(bb - m_new);
      srow[lane] = pa;
      srow[lane + 32] = pb;
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float corr = c_s[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[8], vv[ND];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = s_s[(ty + 8 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = kv_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s final (also when no tile ran)

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    const long long row = q0 + r;
    if (row >= sq) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) op[row * os.s + tx + 16 * j] = acc[i][j] * inv_l;
  }
}

// ----------------------------------------------------------- bfloat16

constexpr int kTcBQ = 64;              // q rows per block, 16 per warp
constexpr int kTcThreads = 2 * kTcBQ;  // one warp per 16 q rows

template <int D>
struct Tc {
  // bf16 elements per shared row: D plus one 16-byte chunk of padding, so a
  // row is an odd number of 16-byte chunks and ldmatrix is conflict-free
  static constexpr int LD = D + 8;
  static constexpr size_t kSmem =  // q, 2 x (k, v)
      sizeof(__nv_bfloat16) * (kTcBQ + 4 * kBK) * LD;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy rows row0 .. row0 + ROWS - 1 of one head (row stride `ss` elements)
// into a [ROWS][Tc<D>::LD] tile; rows at or past `n` are zero-filled, not
// read.
template <int D, int ROWS>
__device__ __forceinline__ void tc_load_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long ss, long long row0,
                                             long long n, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < ROWS * kChunks; c += kTcThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const long long row = row0 + r;
    const bool ok = row < n;
    wlk::cp_async16(dst + r * Tc<D>::LD + ch * 8,
                    ok ? src + row * ss + ch * 8 : src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_tc_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             Strides qs, Strides ks, Strides vs, Strides os, int rep,
             long long sq, long long sk, int causal, long long window,
             float scale_log2) {
  constexpr int LD = Tc<D>::LD;
  constexpr int kTile = kBK * LD;
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk_s = sq_s + kTcBQ * LD;    // [2][kTile]
  __nv_bfloat16* sv_s = sk_s + 2 * kTile;  // [2][kTile]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const long long nq = (sq + kTcBQ - 1) / kTcBQ;
  const long long q0 = (nq - 1 - blockIdx.x) * kTcBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / rep;

  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;
  __nv_bfloat16* op = o + b * os.b + h * os.h;

  // The k tiles that run: the TPU kernel's two block-skip tests, as a range.
  const long long nk = (sk + kBK - 1) / kBK;
  long long kt_lo = 0, kt_hi = nk;
  if (causal) kt_hi = min(nk, (q0 + kTcBQ - 1) / kBK + 1);
  if (window) {
    const long long lo = q0 - window - (kBK - 1);  // tile kt runs iff kt*64 > lo
    kt_lo = lo < 0 ? 0 : lo / kBK + 1;
  }

  tc_load_tile<D, kTcBQ>(sq_s, qp, qs.s, q0, sq, tid);
  if (kt_lo < kt_hi) {
    tc_load_tile<D, kBK>(sk_s, kp, ks.s, kt_lo * kBK, sk, tid);
    tc_load_tile<D, kBK>(sv_s, vp, vs.s, kt_lo * kBK, sk, tid);
  }
  wlk::cp_async_commit();
  if (kt_lo + 1 < kt_hi) {
    tc_load_tile<D, kBK>(sk_s + kTile, kp, ks.s, (kt_lo + 1) * kBK, sk, tid);
    tc_load_tile<D, kBK>(sv_s + kTile, vp, vs.s, (kt_lo + 1) * kBK, sk, tid);
  }
  wlk::cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8 of the warp, log2 units
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums
  const int wrow = warp * 16;

  for (long long kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (int)((kt - kt_lo) & 1);
    const __nv_bfloat16* kt_s = sk_s + stage * kTile;
    const __nv_bfloat16* vt_s = sv_s + stage * kTile;
    wlk::cp_async_wait<1>();  // this tile's group (and q's) has landed
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        wlk::ldmatrix_x4(qf[ks], sq_s + (wrow + lane % 16) * LD + ks * 16 +
                                     (lane / 16) * 8);
    }

    // S = Q K^T: 16 x 64 per warp, eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        wlk::ldmatrix_x4(bf, kt_s + (np * 16 + (lane / 16) * 8 + lane % 8) * LD +
                                 ks * 16 + ((lane / 8) % 2) * 8);
        wlk::mma_bf16_16816(s[2 * np], qf[ks], bf[0], bf[1]);
        wlk::mma_bf16_16816(s[2 * np + 1], qf[ks], bf[2], bf[3]);
      }
    }

    // scale in float32, mask where the tile straddles an edge
    const long long k0 = kt * kBK;
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0) ||
                      (window && k0 <= q0 + kTcBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const long long qpos = q0 + wrow + g + (e / 2) * 8;
          const long long kpos = k0 + j * 8 + 2 * t + (e % 2);
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window) ok = ok && kpos > qpos - window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
      }

    // online softmax; a row lives in the quad of lanes 4g .. 4g + 3
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // the bf16 weights P V uses, summed
        s[j][2 * r] = round_bf16(exp2f(s[j][2 * r] - m_new));
        s[j][2 * r + 1] = round_bf16(exp2f(s[j][2 * r + 1] - m_new));
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: P's C fragments, rounded to bf16, are the A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          wlk::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          wlk::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          wlk::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          wlk::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        wlk::ldmatrix_x4_trans(
            bf, vt_s + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                    dp * 16 + (lane / 16) * 8);
        wlk::mma_bf16_16816(acc[2 * dp], pa, bf[0], bf[1]);
        wlk::mma_bf16_16816(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (kt + 2 < kt_hi) {
      __nv_bfloat16* kd = sk_s + stage * kTile;
      __nv_bfloat16* vd = sv_s + stage * kTile;
      tc_load_tile<D, kBK>(kd, kp, ks.s, (kt + 2) * kBK, sk, tid);
      tc_load_tile<D, kBK>(vd, vp, vs.s, (kt + 2) * kBK, sk, tid);
    }
    wlk::cp_async_commit();  // possibly empty, so the group count stays even
  }
  wlk::cp_async_wait<0>();  // q's copy, when no tile ran

  // o = acc / max(l, 1e-30), staged in the warp's own q rows, written in
  // 16-byte rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    __nv_bfloat16* row0 = sq_s + (wrow + g) * LD + j * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(row0) =
        __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(row0 + 8 * LD) =
        __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, ch = c % kChunks;
    const long long row = q0 + wrow + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(op + row * os.s + ch * 8) =
          *reinterpret_cast<const uint4*>(sq_s + (wrow + r) * LD + ch * 8);
  }
}

// ------------------------------------------------------------- launch

template <int ND>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides* st, long long B, long long H,
                       long long KV, long long sq, long long sk, int causal,
                       long long window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<ND>();
  auto kernel = fa_fwd_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], (int)(H / KV), sq, sk, causal, window,
      1.0f / sqrtf((float)(ND * 16)));
  return cudaGetLastError();
}

template <int ND>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        const Strides* st, long long B, long long H,
                        long long KV, long long sq, long long sk, int causal,
                        long long window, cudaStream_t stream) {
  constexpr int D = ND * 16;
  constexpr size_t smem = Tc<D>::kSmem;
  auto kernel = fa_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((sq + kTcBQ - 1) / kTcBQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st[0], st[1], st[2], st[3], (int)(H / KV), sq, sk, causal, window,
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*, void*,
                                 const Strides*, long long, long long,
                                 long long, long long, long long, int,
                                 long long, cudaStream_t);

Launcher by_head_dim(long long D, int dtype) {
  static const Launcher f32[] = {launch_f32<1>, launch_f32<2>, launch_f32<3>,
                                 launch_f32<4>, launch_f32<5>, launch_f32<6>,
                                 launch_f32<7>, launch_f32<8>};
  static const Launcher bf16[] = {launch_bf16<1>, launch_bf16<2>, launch_bf16<3>,
                                  launch_bf16<4>, launch_bf16<5>, launch_bf16<6>,
                                  launch_bf16<7>, launch_bf16<8>};
  if (D % 16 || D < 16 || D > 128) return nullptr;
  return (dtype == 0 ? f32 : bf16)[D / 16 - 1];
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Sk, KV, D), o (B, Sq, H, D); strides: 12 host
// element strides, (B, S, H) of q, k, v, o in that order, unit stride along
// D.  dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every
// pointer and every (B, S, H) stride in bytes a multiple of 16, for the
// 16-byte copies).  D a multiple of 16 up to 128; H a multiple of KV; all
// extents > 0.
int wlk_flash_attention(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, long long B, long long H,
                        long long KV, long long Sq, long long Sk, long long D,
                        int dtype, int causal, long long window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || KV < 1 || Sq < 1 || Sk < 1 || H % KV != 0 ||
      B > 65535 || H > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (dtype == 1) {
    uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    for (int i = 0; i < 12; ++i) bits |= (uintptr_t)(strides[i] * 2);
    if (bits % 16) return cudaErrorMisalignedAddress;
  }
  Launcher fn = by_head_dim(D, dtype);
  if (!fn) return cudaErrorInvalidValue;
  return fn(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, s);
}

}  // extern "C"
