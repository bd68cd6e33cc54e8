// Flash attention forward (GQA, causal and/or sliding window), for Hopper.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/flash_attention.py (flash_attention_bhsd, body _fa_kernel):
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / rep, :],
//   s_ij = (q[b, i, h, :] * scale) . k[b, j, h / rep, :]
//
// masked to j < Sk, and j <= i when causal, and j > i - window when a window
// is given.  q is (B, Sq, H, D), k/v (B, Sk, KV, D), o like q; any strides
// along B, S and H, unit stride along D, so the wrapper transposes nothing.
// Float32 or bfloat16 in; the scores, the running max m, the running sum l
// and the accumulator stay in float32, and o is rounded to q's type once.
// In bfloat16 the probabilities P are also rounded to bf16 for the P V
// product (about 2^-9 relative per weight).
//
// The scale is 1/sqrt(D) unless the caller passes another (Zamba2's
// shared attention takes (D/2)^-1/2).  Semantics kept from the TPU kernel:
// the scale is applied in float32; masked scores take the finite -1e30, not -inf, so a row that is
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
// bfloat16 -- fa_wgmma_kernel, FlashAttention-3's shape on wgmma and TMA.
// One block of three warpgroups per (q tile of 128 rows, head, batch),
// one block per SM; the heaviest (last) q tiles of every head are
// launched first, so the causal triangle's light tiles fill the tail.
// k and v tiles hold BK = 128 rows up to D = 128; at D = 224 (Zamba2's
// heads) BK is 64, since q (56 KB) and two stages of 128-row k and v tiles
// (56 KB each) would outgrow shared memory, and the consumers' registers
// (the accumulator O holds D / 2 floats a thread) leave room for a
// 64-column S only.
// - Warpgroup 0 is the producer: after setmaxnreg lowers it to 24
//   registers, one thread loads the q tile once and then each k and v tile
//   of BK rows by TMA into a ring of two stages.  Each stage has a "full"
//   mbarrier for k and one for v (their bytes complete them) and an
//   "empty" one that all 256 consumer threads arrive at when done.  TMA
//   reads the BSHD tensors in place through maps built per call, zero-fills
//   rows past Sq or Sk, and swizzles each box as wgmma reads it: rows of
//   128 bytes (boxes of 64 elements) where 64 divides D, else of 32 bytes
//   (16 elements, one k16 step), so one kernel template serves every D that
//   is a multiple of 16 up to 128, and 224.
// - Warpgroups 1 and 2 are consumers, 64 q rows each, raised to 240
//   registers.  S = Q K^T is wgmma m64nBKk16 with Q and K from shared
//   memory (K-major), D / 16 steps, float32 accumulators.  S is scaled by
//   log2(e) * scale in float32 after the product and masked where the tile
//   straddles an edge of the consumer's rows; the online softmax runs in
//   the accumulator's registers (a row lives in a quad of lanes: two
//   shuffles).  P is rounded to bf16 once, in the accumulator's own layout,
//   which is the register A operand of O += P V (wgmma m64nDk16, BK / 16
//   k16 steps), and the row sum adds those rounded weights.  V is read from
//   shared memory as an N-major ("transposed") B operand, as it is stored.
// - The two consumers take turns on the tensor cores (named barriers 1 and
//   2): each issues its S product only after the other has issued its own,
//   so one's softmax overlaps the other's products.
// - The output is rounded to bf16 into the consumer's own q rows, swizzled
//   as TMA's, and written by a TMA store, which drops rows past Sq.
// Shared memory at D = 128 is 160 KB: q 32 KB and two stages of k and v;
// at D = 224, 168 KB: q 56 KB and two stages of 64-row k and v (28 KB).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int kWgBQ = 128;       // q rows per block, 64 per consumer
constexpr int kWgThreads = 384;  // the producer warpgroup and two consumers
constexpr int kStages = 2;       // k/v tiles in flight
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg

template <int D>
struct Wg {
  // A tile (rows of D bf16) lies in shared memory as D / kBox boxes of its
  // rows x kBox elements, each row kRow bytes, swizzled by TMA: 128-byte
  // rows where 64 divides D, else 32-byte rows (16 elements: one k16 step).
  // A q tile has 128 rows, a k or v tile kBK.
  static constexpr int kBox = D % 64 == 0 ? 64 : 16;
  static constexpr int kRow = 2 * kBox;
  static constexpr int kLayout = kBox == 64 ? 1 : 3;  // descriptor swizzle
  static constexpr int kSwizzleMask = kBox == 64 ? 0x70 : 0x10;
  static constexpr int kBoxes = D / kBox;
  static constexpr int kBK = D > 128 ? 64 : 128;  // k rows per tile
  static constexpr int kQBoxBytes = kWgBQ * kRow;
  static constexpr int kQTile = kBoxes * kQBoxBytes;
  static constexpr int kBoxBytes = kBK * kRow;
  static constexpr int kTile = kBoxes * kBoxBytes;
  // q tile, kStages k tiles, kStages v tiles, then the barriers: q full,
  // k full and v full per stage, empty per stage
  static constexpr int kK = kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr size_t kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
};

// 2^x, approximate (relative error about 2^-22), subnormal results as 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S (+)= Q K^T for one k16 step: m64n128k16, or m64n64k16 for 64-row tiles
template <int BK>
__device__ __forceinline__ void wgmma_scores(float (&s)[BK / 2], uint64_t a,
                                             uint64_t b, int scale_d) {
  if constexpr (BK == 128)
    wlk::wgmma_m64n128k16_ss(s, a, b, scale_d);
  else
    wlk::wgmma_m64n64k16_ss(s, a, b, scale_d);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap qm,
                const __grid_constant__ CUtensorMap km,
                const __grid_constant__ CUtensorMap vm,
                const __grid_constant__ CUtensorMap om, int rep, int sq,
                int sk, int causal, int window, float scale_log2) {
  using W = Wg<D>;
  constexpr int kWgBK = W::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (wlk::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + W::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  // blockIdx.x walks the heads fastest, then the q tiles from the last
  // (heaviest when causal) to the first: every head's heaviest tiles start
  // before any lighter one
  const int tid = threadIdx.x;
  const int nq = (sq + kWgBQ - 1) / kWgBQ;
  const int heads = gridDim.x / nq;
  const int h = blockIdx.x % heads, b = blockIdx.z, hk = h / rep;
  const int q0 = (nq - 1 - (int)blockIdx.x / heads) * kWgBQ;

  // The k tiles that run, kt_lo <= kt < kt_hi: the TPU kernel's two
  // block-skip tests for this 128-row q tile (kernels/flash_attention.py,
  // k_tile_range) over tiles of kWgBK keys.
  const int nk = (sk + kWgBK - 1) / kWgBK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) kt_hi = min(nk, (q0 + kWgBQ - 1) / kWgBK + 1);
  if (window) {
    const int lo = q0 - window - (kWgBK - 1);  // tile kt runs iff kt*BK > lo
    kt_lo = lo < 0 ? 0 : lo / kWgBK + 1;
  }
  const int n = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    wlk::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      wlk::mbar_init(&k_full[s], 1);
      wlk::mbar_init(&v_full[s], 1);
      wlk::mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    wlk::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------ producer warpgroup
    wlk::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      wlk::mbar_arrive_expect_tx(q_full, W::kQTile);
      for (int c = 0; c < W::kBoxes; ++c)
        wlk::tma_load_4d(smem + c * W::kQBoxBytes, &qm, q_full, c * W::kBox,
                         q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages, ph = (i / kStages) & 1;
        const int k0 = (kt_lo + i) * kWgBK;
        wlk::mbar_wait(&empty[s], ph ^ 1);  // both consumers are done with it
        unsigned char* k_s = smem + W::kK + s * W::kTile;
        unsigned char* v_s = smem + W::kV + s * W::kTile;
        wlk::mbar_arrive_expect_tx(&k_full[s], W::kTile);
        for (int c = 0; c < W::kBoxes; ++c)
          wlk::tma_load_4d(k_s + c * W::kBoxBytes, &km, &k_full[s],
                           c * W::kBox, k0, hk, b);
        wlk::mbar_arrive_expect_tx(&v_full[s], W::kTile);
        for (int c = 0; c < W::kBoxes; ++c)
          wlk::tma_load_4d(v_s + c * W::kBoxBytes, &vm, &v_full[s],
                           c * W::kBox, k0, hk, b);
      }
    }
  } else {
    // ---------------------------------------------- consumer warpgroups
    wlk::setmaxnreg_inc<kConsumerRegs>();
    const int w = tid / 128 - 1;  // q rows 64w .. 64w + 63 of the tile
    const int wi = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int qlo = q0 + 64 * w;
    const int row0 = qlo + 16 * wi + g;  // this thread's rows: row0, row0 + 8
    unsigned char* q_s = smem + 64 * w * W::kRow;  // + c * kQBoxBytes: box c

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // rows row0, row0 + 8; log2 units
    float l[2] = {0.f, 0.f};          // this thread's part of the row sums

    wlk::mbar_wait(q_full, 0);
    // Ping-pong: consumer w issues its S product after named barrier 1 + w,
    // which the other consumer arrives at once it has issued its own, so
    // one consumer's softmax runs beside the other's products.  Consumer 0
    // goes first; each barrier sees as many arrivals as waits.
    if (w == 1 && n > 0) wlk::named_arrive(1, 256);

    // One k tile; kMask: the tile straddles an edge of this consumer's rows
    // (Sk, the diagonal or the window), so its scores are masked.
    auto tile = [&](int i, auto mask) {
      constexpr bool kMask = decltype(mask)::value;
      const int st = i % kStages, ph = (i / kStages) & 1;
      const int k0 = (kt_lo + i) * kWgBK;
      const unsigned char* k_s = smem + W::kK + st * W::kTile;
      const unsigned char* v_s = smem + W::kV + st * W::kTile;

      // S = Q K^T: 64 x BK, float32, D / 16 k16 steps; the first step
      // ignores s's (undefined) contents
      float s[kWgBK / 2];
      wlk::mbar_wait(&k_full[st], ph);
      wlk::named_sync(1 + w, 256);
      wlk::fence_regs(s);
      wlk::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int box = ks * 32 / W::kRow, in_row = ks * 32 % W::kRow;
        wgmma_scores<kWgBK>(
            s, wlk::wgmma_desc(q_s + box * W::kQBoxBytes + in_row, 16,
                               8 * W::kRow, W::kLayout),
            wlk::wgmma_desc(k_s + box * W::kBoxBytes + in_row, 16,
                            8 * W::kRow, W::kLayout), ks > 0);
      }
      wlk::wgmma_commit();
      if (w == 0 || i + 1 < n) wlk::named_arrive(2 - w, 256);
      wlk::wgmma_wait<0>();
      wlk::fence_regs(s);

      // Scale in float32.  A masked tile scales first and puts -1e30 on the
      // masked scores, so p = 2^(x - m) is exactly 1 there when a whole row
      // is masked; elsewhere the scale folds into the exponent's fma.
      if constexpr (kMask) {
        // keys kpos with lo <= kpos < hi are seen by row r; the thread's
        // element (j, e) is key k0 + 2t + 8j + e
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qpos = row0 + 8 * r;
          lo[r] = (window ? qpos - window + 1 : k0) - (k0 + 2 * t);
          hi[r] = (causal ? min(qpos + 1, sk) : sk) - (k0 + 2 * t);
        }
#pragma unroll
        for (int j = 0; j < kWgBK / 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x / 2, c = 8 * j + x % 2;
            s[4 * j + x] = c >= lo[r] && c < hi[r] ? s[4 * j + x] * scale_log2
                                                   : kNegInf;
          }
      }

      // online softmax; a row lives in the quad of lanes 4g .. 4g + 3.  P
      // is rounded to bf16 in pairs, already the A operand of P V, and the
      // row sum adds the rounded weights.
      uint32_t p[kWgBK / 8][2];
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kWgBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], kMask ? mx : mx * scale_log2);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kWgBK / 8; ++j) {
          const float x0 = s[4 * j + 2 * r], x1 = s[4 * j + 2 * r + 1];
          const uint32_t pk =
              kMask ? wlk::pack_bf16x2(ex2(x0 - m_new), ex2(x1 - m_new))
                    : wlk::pack_bf16x2(ex2(fmaf(x0, scale_log2, -m_new)),
                                       ex2(fmaf(x1, scale_log2, -m_new)));
          sum += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xffff0000u);
          p[j][r] = pk;
        }
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += P V: V (BK keys x D) read N-major, as stored; the k16 step kk
      // takes P's column blocks 2kk and 2kk + 1
      wlk::mbar_wait(&v_full[st], ph);
      wlk::fence_regs(o);
      wlk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                               p[2 * kk + 1][1]};
        wlk::wgmma_m64k16_rs<D>(
            o, a,
            wlk::wgmma_desc(v_s + kk * 16 * W::kRow, W::kBoxBytes,
                            8 * W::kRow, W::kLayout));
      }
      wlk::wgmma_commit();
      wlk::wgmma_wait<0>();
      wlk::fence_regs(o);
      wlk::mbar_arrive(&empty[st]);
    };

    for (int i = 0; i < n; ++i) {
      const int k0 = (kt_lo + i) * kWgBK;
      if (k0 + kWgBK > sk || (causal && k0 + kWgBK - 1 > qlo) ||
          (window && k0 <= qlo + 63 - window))
        tile(i, std::true_type{});
      else
        tile(i, std::false_type{});
    }

    // o = acc / max(l, 1e-30), rounded to bf16 into this consumer's q rows
    // (same swizzle as TMA's), then stored by TMA (rows past Sq dropped)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.f / fmaxf(sum, 1e-30f);
    }
    wlk::named_sync(3 + w, 128);  // every warp's products have read q
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      unsigned char* box = q_s + (col / W::kBox) * W::kQBoxBytes;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int off = (16 * wi + g + 8 * r) * W::kRow + (col % W::kBox) * 2;
        off ^= (off >> 3) & W::kSwizzleMask;
        *reinterpret_cast<uint32_t*>(box + off) = wlk::pack_bf16x2(
            o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    wlk::fence_proxy_async();
    wlk::named_sync(3 + w, 128);
    if (tid % 128 == 0 && qlo < sq) {
      for (int c = 0; c < W::kBoxes; ++c)
        wlk::tma_store_4d(&om, q_s + c * W::kQBoxBytes, c * W::kBox, qlo, h, b);
      wlk::tma_store_wait();
    }
  }
}

// ------------------------------------------------------------- launch

template <int ND>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides* st, long long B, long long H,
                       long long KV, long long sq, long long sk, int causal,
                       long long window, double scale, cudaStream_t stream) {
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
      scale > 0 ? (float)scale : 1.0f / sqrtf((float)(ND * 16)));
  return cudaGetLastError();
}

// The TMA map of a (B, S, heads, D) bf16 tensor with element strides `st`,
// in place, read or written in boxes of `rows` rows x Wg<D>::kBox elements.
// A dimension of extent 1 is never stepped; it gets a stride TMA accepts.
template <int D>
bool make_map(CUtensorMap* map, const void* base, const Strides& st,
              long long B, long long S, long long heads, int rows) {
  const wlk::EncodeTiled encode = wlk::encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const long long el[3] = {st.s, st.h, st.b};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(dims[i + 1] == 1 ? D : el[i]) * 2;
  const cuuint32_t box[4] = {(cuuint32_t)Wg<D>::kBox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Wg<D>::kBox == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ND>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        const Strides* st, long long B, long long H,
                        long long KV, long long sq, long long sk, int causal,
                        long long window, double scale, cudaStream_t stream) {
  constexpr int D = ND * 16;
  constexpr size_t smem = Wg<D>::kSmem;
  auto kernel = fa_wgmma_kernel<D>;
  // setmaxnreg only moves registers within the block: the consumers' rise
  // is paid by the producer's fall only if the block starts with 168 each.
  static const cudaError_t regs = [&]() -> cudaError_t {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs * kWgThreads >=
                   kConsumerRegs * 256 + kProducerRegs * 128
               ? cudaSuccess
               : cudaErrorInvalidConfiguration;
  }();
  if (regs != cudaSuccess) return regs;
  if (sq > (1 << 30) || sk > (1 << 30) ||
      (sq + kWgBQ - 1) / kWgBQ * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (window >= sq) window = 0;  // no query sees past it: no window
  CUtensorMap qm, km, vm, om;
  if (!make_map<D>(&qm, q, st[0], B, sq, H, kWgBQ) ||
      !make_map<D>(&km, k, st[1], B, sk, KV, Wg<D>::kBK) ||
      !make_map<D>(&vm, v, st[2], B, sk, KV, Wg<D>::kBK) ||
      !make_map<D>(&om, o, st[3], B, sq, H, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((sq + kWgBQ - 1) / kWgBQ * H), 1, (unsigned)B);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, om, (int)(H / KV), (int)sq, (int)sk, causal, (int)window,
      scale > 0 ? (float)(1.4426950408889634 * scale) : kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*, void*,
                                 const Strides*, long long, long long,
                                 long long, long long, long long, int,
                                 long long, double, cudaStream_t);

Launcher by_head_dim(long long D, int dtype) {
  static const Launcher f32[] = {launch_f32<1>, launch_f32<2>, launch_f32<3>,
                                 launch_f32<4>, launch_f32<5>, launch_f32<6>,
                                 launch_f32<7>, launch_f32<8>};
  static const Launcher bf16[] = {launch_bf16<1>, launch_bf16<2>, launch_bf16<3>,
                                  launch_bf16<4>, launch_bf16<5>, launch_bf16<6>,
                                  launch_bf16<7>, launch_bf16<8>};
  if (dtype == 1 && D == 224) return launch_bf16<14>;
  if (D % 16 || D < 16 || D > 128) return nullptr;
  return (dtype == 0 ? f32 : bf16)[D / 16 - 1];
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Sk, KV, D), o (B, Sq, H, D); strides: 12 host
// element strides, (B, S, H) of q, k, v, o in that order, unit stride along
// D.  dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every
// pointer and every (B, S, H) stride in bytes a multiple of 16, as TMA
// needs).  D a multiple of 16 up to 128, or 224 in bfloat16; H a multiple
// of KV; all extents > 0.  scale multiplies the scores; 0 (or less) takes
// 1/sqrt(D).  It comes last, so a caller that passes it can call a build
// that does not take it (the default scale then).
int wlk_flash_attention(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, long long B, long long H,
                        long long KV, long long Sq, long long Sk, long long D,
                        int dtype, int causal, long long window, void* stream,
                        double scale) {
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
  return fn(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
}

}  // extern "C"
