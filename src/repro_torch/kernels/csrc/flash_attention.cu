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
// Float32 or bfloat16 in; every product, the running max m, the running sum
// l and the accumulator stay in float32, and o is rounded to q's type once.
//
// Semantics kept from the TPU kernel: q is scaled in float32 before the
// product; masked scores take the finite -1e30, not -inf, so a row that is
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
// (0.026 ms at 989 TFLOP/s).  This first version does its products on the
// CUDA cores in float32 and is far from that bound; tensor cores (mma/wgmma)
// and TMA loads are the lever for a later version.
//
// Design: one block of 128 threads per (q tile of 64 rows, head, batch),
// heaviest (last) q tiles launched first.  The block keeps its q tile,
// pre-scaled, in shared memory as float32, and walks the k tiles of 64 rows:
// the k tile is staged in shared memory, each thread computes an 8 x 4 patch
// of the 64 x 64 scores, one warp per 16 rows takes the row max and sum with
// shuffles, then the v tile replaces the k tile and each thread updates its
// 8 x (D/16) patch of the accumulator, held in registers.  Rows of the q
// tile past Sq are computed on zeros and never written; k rows past Sk are
// read as zeros and masked, so no padded copy exists anywhere.  Shared
// memory is 83 KB at D = 128 (requested with cudaFuncSetAttribute), so two
// blocks share an SM.
//
// The entry point launches on the caller's stream, synchronises nothing,
// allocates nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape it does not serve) so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k rows per tile
constexpr int kThreads = 128;  // 4 warps; thread (ty, tx) = (tid / 16, tid % 16)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

struct Strides {  // element strides along (B, S, H); D has stride 1
  long long b, s, h;
};

template <int ND>
constexpr size_t smem_bytes() {
  // q tile, k-or-v tile (rows padded by one float against bank conflicts),
  // score tile, and the per-row m, l and correction
  return sizeof(float) * (2 * kBQ * (ND * 16 + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

template <int ND, typename T>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
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

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const long long row = q0 + r;
    q_s[r * LD + d] = row < sq ? load_f32(qp + row * qs.s + d) * scale : 0.f;
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
      kv_s[r * LD + d] = row < sk ? load_f32(kp + row * ks.s + d) : 0.f;
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
      kv_s[r * LD + d] = row < sk ? load_f32(vp + row * vs.s + d) : 0.f;
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
    for (int j = 0; j < ND; ++j)
      store_f32(op + row * os.s + tx + 16 * j, acc[i][j] * inv_l);
  }
}

template <int ND, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, long long B, long long H, long long KV,
                   long long sq, long long sk, int causal, long long window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<ND>();
  auto kernel = fa_fwd_kernel<ND, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os,
      (int)(H / KV), sq, sk, causal, window, 1.0f / sqrtf((float)(ND * 16)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(long long D, const void* q, const void* k, const void* v,
                     void* o, const long long* st, long long B, long long H,
                     long long KV, long long sq, long long sk, int causal,
                     long long window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<1, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    case 32: return launch<2, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    case 48: return launch<3, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    case 64: return launch<4, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    case 80: return launch<5, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    case 96: return launch<6, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    case 112: return launch<7, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    case 128: return launch<8, T>(q, k, v, o, st, B, H, KV, sq, sk, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Sk, KV, D), o (B, Sq, H, D); strides: 12 host
// element strides, (B, S, H) of q, k, v, o in that order, unit stride along
// D.  dtype 0 = float32, 1 = bfloat16 (all four tensors).  D a multiple of
// 16 up to 128; H a multiple of KV; all extents > 0.
int wlk_flash_attention(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, long long B, long long H,
                        long long KV, long long Sq, long long Sk, long long D,
                        int dtype, int causal, long long window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || KV < 1 || Sq < 1 || Sk < 1 || H % KV != 0 ||
      B > 65535 || H > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return dispatch<float>(D, q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, s);
    case 1: return dispatch<__nv_bfloat16>(D, q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
