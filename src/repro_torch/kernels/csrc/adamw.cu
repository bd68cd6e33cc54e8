// Fused AdamW of the port's training step, for Hopper: the gradients'
// global norm and the update of every leaf in a few multi-tensor launches.
//
// Replaces no TPU kernel.  The JAX package writes AdamW as array code
// (src/repro/train/optim.py: adamw_update, global_norm) and leaves it to
// XLA, which fuses it into a few passes.  The port's plain version
// (train/optim.py: adamw_update_plain) runs about 24 elementwise launches a
// leaf, each with a float32 temporary the size of its leaf: some 14,000
// launches and 180 B an element for mamba2-2.7b's 578 leaves.
//
// Bound: bytes.  The update reads p, g, m, v and writes p, m, v once per
// element (22 B with bf16 p and g and float32 moments); the norm reads g
// once more (2 B).  At 3.35 TB/s that is 19.4 ms for 2.70e9 parameters.
// There is no arithmetic to hide: about 20 float operations an element.
//
// Design: three kernels, each over a table of leaves passed as the
// kernel's parameters (no table is copied to the device, so nothing waits
// on a host copy), as many launches as the tables need:
//
//   adamw_sumsq_kernel<G>   a grid over (leaf, chunk): every block sums
//                           the squares of one chunk of one gradient in
//                           float32 and writes its partial to scratch, at
//                           the slot the leaf's place in the reference's
//                           order gives it.  No atomics: the same
//                           gradients give the same bits on every run.
//   adamw_finish_kernel     one block: each warp adds one leaf's partials
//                           in a fixed order, then thread 0 adds the leaves
//                           into their reference groups and the groups into
//                           the total, in the reference's order (as
//                           global_norm does), per class of sharding; the
//                           last launch writes the norm and the clip scale
//                           clamp(clip / max(n, 1e-12), max=1).  A table
//                           longer than one launch carries its running sums
//                           in scratch to the next launch.
//   adamw_update_kernel<P,G,M>  a grid over (leaf, chunk), one dtype triple
//                           a launch: each element does the plain loop's
//                           arithmetic in the same order in float32, with
//                           the rounding intrinsics so that nvcc contracts
//                           nothing into an fma, and rounds to the stored
//                           dtype once at the end.  lr, the bias
//                           corrections and the clip scale are read from
//                           device memory: the host never waits.
//
// A block finds its leaf by a binary search of the table's first blocks.
// Where all of a leaf's pointers lie on the 16-byte grid, 8 elements move
// per thread and step as 16-byte vectors (one for bf16, two for float32);
// a misaligned leaf, and each chunk's tail, go element by element.
//
// Each entry point launches on the caller's stream, synchronises nothing,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;        // elements of a leaf per block
constexpr int kMaxNorm = 168;              // leaves per launch, sumsq
constexpr int kMaxUpdate = 80;             // leaves per launch, update
constexpr int kMaxFinish = 960;            // leaves per launch, finish
constexpr int kFinishThreads = 1024;
constexpr int kClasses = 8;                // classes of sharding (DTensor)
constexpr unsigned kGroupEnd = 1u << 31;   // finish entry: last of a group
constexpr int kClassShift = 28;            // finish entry: class bits 28-30
constexpr unsigned kCountMask = (1u << kClassShift) - 1;

// scratch ("stats") layout, float32
constexpr int kNorm = 0, kScale = 1, kTotals = 2;
constexpr int kGroup = kTotals + kClasses, kGroupOpen = kGroup + 1;
constexpr int kStats = kGroupOpen + 1;

struct NormEntry {       // 24 B
  const void* g;
  long long n;
  unsigned block0;       // the launch's first block of this leaf
  unsigned partial0;     // the leaf's first partial (reference order)
};

struct UpdateEntry {     // 48 B
  void* p;
  const void* g;
  void* m;
  void* v;
  long long n;
  unsigned block0;
  unsigned decay;
};

struct NormTable {
  NormEntry e[kMaxNorm];
  int count;
};

struct UpdateTable {
  UpdateEntry e[kMaxUpdate];
  int count;
};

struct FinishTable {
  unsigned counts[kMaxFinish];  // partials of each leaf | class | group end
  long long first_partial;
  int count;
};

struct Scalars {
  const float* lr;
  const float* bc1;
  const float* bc2;
  const float* scale;    // null: no clipping
  float b1, omb1, b2, omb2, eps, wd;
};

// Kernel parameters stay within the 4 KB every toolkit takes.
static_assert(sizeof(NormTable) + sizeof(float*) <= 4096, "sumsq table");
static_assert(sizeof(UpdateTable) + sizeof(Scalars) <= 4096, "update table");
static_assert(sizeof(FinishTable) + 2 * sizeof(float*) + 2 * sizeof(int)
              <= 4096, "finish table");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 elements through 16-byte vectors: one for bf16, two for float32.
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&x)[8]) {
  constexpr int kVecs = sizeof(T) / 2;
  uint4 u[kVecs];
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) u[k] = s[k];
  const T* e = reinterpret_cast<const T*>(u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&x)[8]) {
  constexpr int kVecs = sizeof(T) / 2;
  uint4 u[kVecs];
  T* e = reinterpret_cast<T*>(u);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = from_f<T>(x[i]);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) d[k] = u[k];
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// The entry of table t whose blocks hold blockIdx.x: the last entry whose
// first block is at or below it (written out in each kernel, so the table
// is indexed in the parameter space and never copied to local memory).
#define FIND_ENTRY(t, out)                                      \
  do {                                                          \
    int lo_ = 0, hi_ = (t).count - 1;                           \
    while (lo_ < hi_) {                                         \
      const int mid_ = (lo_ + hi_ + 1) >> 1;                    \
      if ((t).e[mid_].block0 <= blockIdx.x) lo_ = mid_;         \
      else hi_ = mid_ - 1;                                      \
    }                                                           \
    (out) = lo_;                                                \
  } while (0)

// The block's sum of x in a fixed order (valid in thread 0).
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const NormTable t, float* __restrict__ partials) {
  int idx;
  FIND_ENTRY(t, idx);
  const NormEntry en = t.e[idx];
  const unsigned chunk = blockIdx.x - en.block0;
  const long long begin = static_cast<long long>(chunk) * kChunk;
  const long long n = (en.n - begin < kChunk) ? en.n - begin : kChunk;
  const G* g = static_cast<const G*>(en.g) + begin;
  float acc = 0.f;
  long long head = 0;
  if (aligned16(g)) {
    const long long nvec = n / 8;
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      float x[8];
      load8(g + 8 * i, x);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = __fmaf_rn(x[k], x[k], acc);
    }
    head = nvec * 8;
  }
  for (long long i = head + threadIdx.x; i < n; i += kThreads) {
    const float x = to_f(g[i]);
    acc = __fmaf_rn(x, x, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[en.partial0 + chunk] = acc;
}

// flags: 1 the table's first launch, 2 its last, 4 write the norm and the
// clip scale from class 0's total (a tree with one class of sharding).
__global__ void __launch_bounds__(kFinishThreads)
adamw_finish_kernel(const FinishTable t, const float* __restrict__ partials,
                    float* __restrict__ stats, int flags, float clip) {
  __shared__ long long start[kMaxFinish];
  __shared__ float sums[kMaxFinish];
  if (threadIdx.x == 0) {
    long long off = t.first_partial;
    for (int i = 0; i < t.count; ++i) {
      start[i] = off;
      off += t.counts[i] & kCountMask;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < t.count; i += kFinishThreads / 32) {
    const long long n = t.counts[i] & kCountMask;
    float a = 0.f;
    for (long long j = lane; j < n; j += 32) a += partials[start[i] + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) sums[i] = a;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float total[kClasses];
  float group = 0.f;
  bool open = false;
  for (int c = 0; c < kClasses; ++c) total[c] = (flags & 1) ? 0.f : stats[kTotals + c];
  if (!(flags & 1)) {
    group = stats[kGroup];
    open = stats[kGroupOpen] != 0.f;
  }
  for (int i = 0; i < t.count; ++i) {
    group = open ? __fadd_rn(group, sums[i]) : sums[i];
    open = true;
    if (t.counts[i] & kGroupEnd) {
      const int c = (t.counts[i] >> kClassShift) & (kClasses - 1);
      total[c] = __fadd_rn(total[c], group);
      open = false;
    }
  }
  for (int c = 0; c < kClasses; ++c) stats[kTotals + c] = total[c];
  stats[kGroup] = group;
  stats[kGroupOpen] = open ? 1.f : 0.f;
  if ((flags & 2) && (flags & 4)) {
    const float norm = __fsqrt_rn(total[0]);
    stats[kNorm] = norm;
    float scale = 1.f;
    if (clip > 0.f) {   // clamp(clip * reciprocal(clamp(n, min=1e-12)), max=1)
      const float n = norm < 1e-12f ? 1e-12f : norm;   // NaN stays NaN
      scale = __fmul_rn(__fdiv_rn(1.f, n), clip);
      scale = scale > 1.f ? 1.f : scale;
    }
    stats[kScale] = scale;
  }
}

// One element of the plain loop, in its order.
__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v,
                                              float lr, float bc1, float bc2,
                                              float scale, bool clip, bool decay,
                                              const Scalars& s) {
  if (clip) g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.omb2));
  float u = __fdiv_rn(__fdiv_rn(m, bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), s.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(p, s.wd));
  p = __fsub_rn(p, __fmul_rn(u, lr));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const UpdateTable t, const Scalars s) {
  int idx;
  FIND_ENTRY(t, idx);
  const UpdateEntry en = t.e[idx];
  const long long begin = static_cast<long long>(blockIdx.x - en.block0) * kChunk;
  const long long n = (en.n - begin < kChunk) ? en.n - begin : kChunk;
  P* p = static_cast<P*>(en.p) + begin;
  const G* g = static_cast<const G*>(en.g) + begin;
  M* m = static_cast<M*>(en.m) + begin;
  M* v = static_cast<M*>(en.v) + begin;
  const float lr = *s.lr, bc1 = *s.bc1, bc2 = *s.bc2;
  const bool clip = s.scale != nullptr;
  const float scale = clip ? *s.scale : 1.f;
  const bool decay = en.decay != 0;
  long long head = 0;
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
    const long long nvec = n / 8;
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      float pf[8], gf[8], mf[8], vf[8];
      load8(p + 8 * i, pf);
      load8(g + 8 * i, gf);
      load8(m + 8 * i, mf);
      load8(v + 8 * i, vf);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        adamw_element(pf[k], gf[k], mf[k], vf[k], lr, bc1, bc2, scale, clip,
                      decay, s);
      store8(p + 8 * i, pf);
      store8(m + 8 * i, mf);
      store8(v + 8 * i, vf);
    }
    head = nvec * 8;
  }
  for (long long i = head + threadIdx.x; i < n; i += kThreads) {
    float pf = to_f(p[i]), mf = to_f(m[i]), vf = to_f(v[i]);
    adamw_element(pf, to_f(g[i]), mf, vf, lr, bc1, bc2, scale, clip, decay, s);
    p[i] = from_f<P>(pf);
    m[i] = from_f<M>(mf);
    v[i] = from_f<M>(vf);
  }
}

template <typename P, typename G, typename M>
cudaError_t launch_update(const UpdateTable& t, unsigned blocks, const Scalars& s,
                          cudaStream_t stream) {
  adamw_update_kernel<P, G, M><<<blocks, kThreads, 0, stream>>>(t, s);
  return cudaGetLastError();
}

template <typename P, typename G>
cudaError_t update_m(int mdt, const UpdateTable& t, unsigned blocks,
                     const Scalars& s, cudaStream_t stream) {
  return mdt ? launch_update<P, G, __nv_bfloat16>(t, blocks, s, stream)
             : launch_update<P, G, float>(t, blocks, s, stream);
}

template <typename P>
cudaError_t update_g(int gdt, int mdt, const UpdateTable& t, unsigned blocks,
                     const Scalars& s, cudaStream_t stream) {
  return gdt ? update_m<P, __nv_bfloat16>(mdt, t, blocks, s, stream)
             : update_m<P, float>(mdt, t, blocks, s, stream);
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16.

// entries: count NormEntry (24 B each, block0 ascending from 0), blocks:
// the launch's grid (the last entry's block0 plus its chunks).
int wlk_adamw_sumsq(const void* entries, int count, unsigned blocks,
                    float* partials, int gdt, void* stream) {
  if (count < 1 || count > kMaxNorm || gdt < 0 || gdt > 1)
    return cudaErrorInvalidValue;
  NormTable t;
  t.count = count;
  const NormEntry* e = static_cast<const NormEntry*>(entries);
  for (int i = 0; i < count; ++i) t.e[i] = e[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gdt)
    adamw_sumsq_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(t, partials);
  else
    adamw_sumsq_kernel<float><<<blocks, kThreads, 0, s>>>(t, partials);
  return cudaGetLastError();
}

// counts: count leaves in the reference's order, each its partials' count
// | class << 28 | group end << 31; their partials start at first_partial.
int wlk_adamw_finish(const unsigned* counts, int count, long long first_partial,
                     const float* partials, float* stats, int flags, float clip,
                     void* stream) {
  if (count < 1 || count > kMaxFinish) return cudaErrorInvalidValue;
  FinishTable t;
  t.count = count;
  t.first_partial = first_partial;
  for (int i = 0; i < count; ++i) t.counts[i] = counts[i];
  adamw_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, partials, stats, flags, clip);
  return cudaGetLastError();
}

// entries: count UpdateEntry (48 B each, block0 ascending from 0); lr,
// bc1, bc2: device float32 scalars; scale: one, or null for no clipping.
int wlk_adamw_update(const void* entries, int count, unsigned blocks,
                     int pdt, int gdt, int mdt, const float* lr,
                     const float* bc1, const float* bc2, const float* scale,
                     float b1, float omb1, float b2, float omb2, float eps,
                     float wd, void* stream) {
  if (count < 1 || count > kMaxUpdate || pdt < 0 || pdt > 1 || gdt < 0 ||
      gdt > 1 || mdt < 0 || mdt > 1)
    return cudaErrorInvalidValue;
  UpdateTable t;
  t.count = count;
  const UpdateEntry* e = static_cast<const UpdateEntry*>(entries);
  for (int i = 0; i < count; ++i) t.e[i] = e[i];
  const Scalars s{lr, bc1, bc2, scale, b1, omb1, b2, omb2, eps, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pdt ? update_g<__nv_bfloat16>(gdt, mdt, t, blocks, s, st)
             : update_g<float>(gdt, mdt, t, blocks, s, st);
}

// The limits the Python wrapper plans with.
int wlk_adamw_limits(int* out) {
  out[0] = static_cast<int>(kChunk);
  out[1] = kMaxNorm;
  out[2] = kMaxUpdate;
  out[3] = kMaxFinish;
  out[4] = kClasses;
  out[5] = kStats;
  return 0;
}

}  // extern "C"
