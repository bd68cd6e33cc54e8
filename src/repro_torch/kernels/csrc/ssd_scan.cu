// Mamba-2 SSD intra-chunk step, for Hopper: tensor cores in 3xTF32, fed by
// TMA.
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
// (B, NC, H, N, P); all float32 and C-contiguous, P and N multiples of 4
// and every pointer but dA's on a 16-byte boundary (TMA's rule: the
// wrapper pads P and N and copies a misaligned tensor first).  L is a
// select, never a product with a 0/1 mask: exp(cs_i - cs_j) above the
// diagonal can overflow to inf, and inf * 0 is NaN.
//
// Precision.  One TF32 pass keeps 10 mantissa bits and breaks the 2e-4
// contract; three keep float32's accuracy.  Each operand is split as
// hi = rna(a), lo = rna(a - hi) (rounded as cvt.rna.tf32.f32 rounds) and
// every product is hi hi' + lo hi' + hi lo' in float32 sums (lo lo'
// dropped).  Emulated on
// one chunk at the serving widths (q 256, N 128, P 64, 8 heads) against a
// float64 reference, as the largest share of the 2e-4 limit: float32
// products 0.109 (y) and 0.003 (states), one TF32 pass 220 and 16.0,
// 3xTF32 0.148 and 0.005 (tools/k4_emulate.py;
// tests/test_torch_ssd_tiles.py pins the same finding).
//
// Bound: at the serving path's shape (S = 2048 in chunks of q = 256,
// H = 80, P = 64, G = 1, N = 128) the least work is C B^T once per (batch,
// chunk, group) and lower triangles only: 5.45 GFLOP, which at a third of
// the TF32 rate (495 / 3 TFLOP/s) takes 0.033 ms, level with the 108 MB of
// inputs and outputs at 3.35 TB/s (0.032 ms).  It replaces a kernel on the
// CUDA cores in float32 FMAs (bound 0.081 ms at 67 TFLOP/s; 0.32 ms).  At
// 64 x 64 tiles the work is 6.9 GFLOP, tripled by the split; each x tile
// is read from L2 by every y tile and state tile of its chunk (18 times
// per head and chunk at the serving shape), which with the consumers'
// CUDA-core work (the splits, (S o L)) bounds this design (PERF.md).
//
// Design.  One block per (b, c, g, head subset, tile), a work list whose
// order kernels/ssd_scan.py states (work_list): y tiles of 64 rows i and
// state tiles of 64 rows n, heaviest first -- the last y tile (most j
// tiles), the state tiles, then the other y tiles from the last to the
// first.  A subset is up to 8 heads (4 when P > 64); a unit is a head and
// 64 columns p of it.  Three warpgroups: a producer and two consumers.
// - Warpgroup 0, lowered to 56 registers by setmaxnreg, is the producer:
//   one thread loads every tile by TMA (4-D maps over (B NC, q, H or G,
//   P or N) in place, rows past q read as zeros, 32-float box rows with
//   128-byte swizzle) into rings whose "full" mbarriers the bytes complete
//   and whose "empty" mbarriers the consumers arrive at as soon as they
//   hold a tile's fragments in registers; its warps 1 to 3 compute the
//   cumulative sums (below).
// - Warpgroups 1 and 2 are the consumers, raised to 224 registers; each
//   takes every other unit, one unit at a time.
// - Every product is wgmma m64n64k8 in TF32, A in registers (split there),
//   B from shared memory.  TF32 cannot transpose a shared operand, so each
//   product is laid out so that its shared operand is K-major: S^T = B C^T
//   (A: B's rows; shared: C as loaded, split in place into hi and a lo
//   copy), y^T = x^T (S o L)^T (A: x's rows; shared: (S o L) written by
//   the consumer as [i][j] in hi and lo) and state^T = (w x)^T B (A: x's
//   rows times w; shared: B^T written per j tile as [n][j]).  The A
//   fragments are read as 8-byte pairs: the fragment's rows g, g + 8 are
//   the operand's rows 2g, 2g + 1 and its columns t, t + 4 are columns 2t,
//   2t + 1, and the shared operands the consumers write hold each k8
//   step's columns in that order (even, then odd).  The row order carries
//   into the accumulators, which hold (p, p + 1) pairs, stored as float2.
// - The tensor cores round each instruction's float32 sum toward zero, a
//   bias that grows with the instructions summed into one accumulator at
//   its full scale (S over N = 128 in 48 of them: 6.0e-5 of error where
//   round-to-nearest gives 1.2e-5, tools/k4_emulate.py).  So an
//   accumulator sums one box of S's K (4 k8 steps) or one j tile of y and
//   the states (8), each step's two small products issued before hi hi';
//   the consumers add these partial sums in float32, rounded to nearest
//   (S's error 7.4e-6 at N = 128 on the card, tools/k4_probe.py).
// - In a y block the consumer forms (S o L_h) in two halves of 32 columns
//   j; the first half's products run on the tensor cores while it forms
//   the second.
// - A y block first computes S = C B^T for its 64 rows i and up to 256
//   columns j into shared memory (the S phase: the consumers take the j
//   tiles in turns), then, per unit and j tile, forms (S o L_h) from S and
//   the cumulative sums (one exp each, a select) and multiplies.  The S
//   phase's buffers (C, its lo copy, two B stages) and the y phase's ((S o
//   L) per consumer, a ring of four x tiles) share one 128 KB region: the
//   producer loads x tiles as soon as the consumers have read the last B
//   stage, and waits for a "region free" mbarrier before the next
//   window's C and B.
// - A state block first builds B^T for its 64 rows n and every j tile of
//   the window (both consumers; two B stages in the 64 KB that S takes in
//   a y block), then each unit adds (w x_j)^T B_j^T over the j tiles, w =
//   exp(cs_last - cs), the x ring in that 64 KB.
// - Beyond 256 columns j (q > 256) the two phases repeat per window and
//   each unit adds its window's part to the output written before.
// - The cumulative sums: row after row in float32 -- the order of
//   torch.cumsum along the chunk on the card, so that L rounds as the
//   plain version's does -- one lane per head, in the producer
//   warpgroup's three other warps, while the consumers compute S or B^T.
//   A Hillis-Steele warp scan was tried: it puts 0.45 of the 2e-4 limit
//   between the kernel and the plain version on one chunk, against 0.15
//   in this order (tools/k4_emulate.py), and failed the gate at the
//   serving shape on the card (PORT.md).
// Shared memory is 204 KB: one block of 384 threads an SM.
//
// The entry point launches on the caller's stream, synchronises nothing,
// allocates nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape it does not serve, cudaErrorMisalignedAddress for a pointer off
// the 16-byte grid) so the Python wrapper can raise.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;          // rows i, j or n of a tile; columns p of a unit
constexpr int kWJ = 256;        // columns j of S held at once: a window
constexpr int kWT = kWJ / kT;   // j tiles of a window
constexpr int kSLD = kWJ + 4;   // row stride of S (floats)
constexpr int kHeads = 8;       // heads of a subset (at P <= 64)
constexpr int kThreads = 384;   // the producer warpgroup and two consumers
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // setmaxnreg
constexpr int kBox = 32;                   // floats of a box row: 128 bytes
constexpr int kBoxFloats = kT * kBox;      // a box of 64 rows
constexpr int kBoxBytes = 4 * kBoxFloats;  // 8 KB
constexpr int kXStages = 4;                // x tiles (2 boxes each) in flight

// Shared memory, in bytes past a 1024-byte boundary.  Region 0 ([0, 128
// KB)) holds, in a y block's S phase, C (4 boxes along n), C's lo parts and
// two stages of B (4 boxes each); in its y phase each consumer's (S o L)
// (2 boxes hi, 2 lo) and the x ring; in a state block B^T of the window's
// j tiles (per tile 2 boxes hi, 2 lo).  Region 1 holds a y block's S, and
// in a state block two stages of B's n tile (2 boxes each), then the x
// ring.
constexpr int kC = 0, kCLo = 4 * kBoxBytes, kBStage = 8 * kBoxBytes;
constexpr int kSL = 0;                       // consumer k at + 4k boxes
constexpr int kXY = 8 * kBoxBytes;           // the y block's x ring
constexpr int kBT = 0;                       // j tile k at + 4k boxes
constexpr int kR1 = 16 * kBoxBytes;          // region 1
constexpr int kS = kR1;                      // S: [64][kSLD]
constexpr int kBtStage = kR1, kXS = kR1;     // the state block's
constexpr int kCsI = kR1 + 4 * kT * kSLD;    // cs of rows i: [kHeads][64]
constexpr int kCsW = kCsI + 4 * kHeads * kT; // cs (y) or w (state) of a window
constexpr int kBar = kCsW + 4 * kHeads * kWJ;
enum {
  kCFull, kBFull, kBEmpty = kBFull + 2, kXFull = kBEmpty + 2,
  kXEmpty = kXFull + kXStages, kRegionFree = kXEmpty + kXStages, kBars
};
constexpr size_t kSmem = kBar + 8 * kBars + 1024;

struct Args {
  const float* dA;
  float *y, *st;
  int H, G, q, P, N, R, nsub, ni, nn;
  long long inner;  // blocks of one rank of the work list: B NC G nsub
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Offset of (row r, column c) in a box of 32-float rows, swizzled as TMA's
// 128-byte mode writes it: 16-byte unit c / 4 XOR r % 8.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBox + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// Descriptor of k8 step kk of a K-major operand of 64 rows whose columns
// lie in boxes of 32.
__device__ __forceinline__ uint64_t desc(const float* tile, int kk) {
  return wlk::wgmma_desc(tile + (kk >> 2) * kBoxFloats + 8 * (kk & 3), 16,
                         8 * 4 * kBox, 1);
}

// Writes the 8 columns 8 kk .. 8 kk + 7 of row r of a K-major B operand
// (hi and lo tiles, boxes of 32 columns) in the order the A fragments pair
// them: the even columns in the step's first 16 bytes, the odd ones in its
// second, each split into TF32 hi and lo.
__device__ __forceinline__ void put_step(float* hi, float* lo, int r, int kk,
                                         const float (&v)[8]) {
  uint32_t h[8], l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) wlk::split_tf32(v[e], h[e], l[e]);
  const int off = (kk >> 2) * kBoxFloats, c = 8 * (kk & 3);
  *reinterpret_cast<uint4*>(hi + off + swz(r, c)) = make_uint4(h[0], h[2], h[4], h[6]);
  *reinterpret_cast<uint4*>(hi + off + swz(r, c + 4)) = make_uint4(h[1], h[3], h[5], h[7]);
  *reinterpret_cast<uint4*>(lo + off + swz(r, c)) = make_uint4(l[0], l[2], l[4], l[6]);
  *reinterpret_cast<uint4*>(lo + off + swz(r, c + 4)) = make_uint4(l[1], l[3], l[5], l[7]);
}

// The A fragment (hi, lo) of k8 step kk of A = T^T, T a tile of 64 rows
// (k) and 64 columns (m) in two boxes along m: x as loaded, rows j and
// columns p.  Fragment row g is column m = 16 w + 2g, row g + 8 column
// m + 1; k t is row 2t of the step, k t + 4 row 2t + 1; w scales the two
// rows.
__device__ __forceinline__ void frag_rows(const float* tile, int kk, int m,
                                          int t, float2 w, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float* box = tile + (m >> 5) * kBoxFloats;
  const float2 r0 = ld2(box + swz(8 * kk + 2 * t, m & 31));
  const float2 r1 = ld2(box + swz(8 * kk + 2 * t + 1, m & 31));
  wlk::split_tf32(r0.x * w.x, hi[0], lo[0]);
  wlk::split_tf32(r0.y * w.x, hi[1], lo[1]);
  wlk::split_tf32(r1.x * w.y, hi[2], lo[2]);
  wlk::split_tf32(r1.y * w.y, hi[3], lo[3]);
}

// The A fragment of k8 step kk of A = T, T a tile of 64 rows (m) whose
// columns (k) lie in boxes of 32: B's rows j, columns n.  Rows and k as in
// frag_rows.
__device__ __forceinline__ void frag_cols(const float* tile, int kk, int m,
                                          int t, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float* box = tile + (kk >> 2) * kBoxFloats;
  const int c = 8 * (kk & 3) + 2 * t;
  const float2 r0 = ld2(box + swz(m, c));
  const float2 r1 = ld2(box + swz(m + 1, c));
  wlk::split_tf32(r0.x, hi[0], lo[0]);
  wlk::split_tf32(r1.x, hi[1], lo[1]);
  wlk::split_tf32(r0.y, hi[2], lo[2]);
  wlk::split_tf32(r1.y, hi[3], lo[3]);
}

// The 3xTF32 products of k8 steps kk0 .. kk0 + K - 1 into d (started
// afresh if kFresh): first the small ones, lo hi' and hi lo', then hi hi',
// so that only K of the 3K instructions round toward zero at d's full
// scale.
template <int K, bool kFresh = true>
__device__ __forceinline__ void mma3(float (&d)[32], const uint32_t (&ah)[K][4],
                                     const uint32_t (&al)[K][4],
                                     const float* bh, const float* bl, int kk0) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wlk::wgmma_m64n64k8_tf32_rs(d, al[k], desc(bh, kk0 + k), !kFresh || k > 0);
    wlk::wgmma_m64n64k8_tf32_rs(d, ah[k], desc(bl, kk0 + k), 1);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    wlk::wgmma_m64n64k8_tf32_rs(d, ah[k], desc(bh, kk0 + k), 1);
}

// Waits for the products issued into d and adds d to tot, rounded to
// nearest.
__device__ __forceinline__ void accumulate(float (&tot)[32], float (&d)[32]) {
  wlk::wgmma_commit();
  wlk::wgmma_wait<0>();
  wlk::fence_regs(d);
#pragma unroll
  for (int e = 0; e < 32; ++e) tot[e] += d[e];
}

// Inclusive sums of dA (row stride H) over rows r0 .. r1 - 1 (multiples
// of 32, r1 - r0 <= kWJ) into dst[row - r0] (16-byte aligned), continuing
// `carry`, row after row in float32 (the order of torch.cumsum along the
// chunk on the card); rows at or past q add 0.  One warp; returns the
// carry past r1 - 1.
__device__ __forceinline__ float scan_rows(const float* dA, int H, int q,
                                           int r0, int r1, float carry,
                                           float* dst, int lane) {
  for (int r = r0 + lane; r < r1; r += 32)
    dst[r - r0] = r < q ? dA[(long long)r * H] : 0.f;
  __syncwarp();
  if (lane == 0) {
    // 16 rows at a time in registers: the loads run ahead of the adds
    for (int r = 0; r < r1 - r0; r += 16) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        const float4 u = ld4(dst + r + k);
        v[k] = u.x; v[k + 1] = u.y; v[k + 2] = u.z; v[k + 3] = u.w;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = carry = carry + v[k];
#pragma unroll
      for (int k = 0; k < 16; k += 4)
        *reinterpret_cast<float4*>(dst + r + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, carry, 0);
}

// Position of x tile (unit u, j tile jl) among a window's nu x nj tiles as
// the producer loads them: units in pairs (2m, 2m + 1), per pair the j
// tiles in order, per j tile the pair's units -- so the two consumers,
// which take every other unit, are fed side by side.
__device__ __forceinline__ int x_order(int u, int jl, int nu, int nj) {
  const int m = u >> 1;
  return 2 * m * nj + (nu - 2 * m >= 2 ? 2 * jl + (u & 1) : jl);
}

template <int NP>  // NP = ceil(P / 64): units of a head
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap xm,
              const __grid_constant__ CUtensorMap bm,
              const __grid_constant__ CUtensorMap cm, Args a) {
  constexpr int HS = kHeads / NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (wlk::smem_addr(smem_raw) & 1023)) & 1023);
  float* sm = reinterpret_cast<float*>(base);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + kBar);
  float* cs_i = sm + kCsI / 4;
  float* cs_w = sm + kCsW / 4;

  // the work list (kernels/ssd_scan.py, work_list): rank 0 the last y
  // tile, ranks 1 .. nn the state tiles, then the y tiles ni - 2 .. 0;
  // within a rank the head subset fastest, then the group, then b NC
  const int rank = (int)(blockIdx.x / a.inner);
  long long rest = blockIdx.x % a.inner;
  const int sub = (int)(rest % a.nsub);
  rest /= a.nsub;
  const int g = (int)(rest % a.G);
  const int bc = (int)(rest / a.G);
  const bool is_y = rank == 0 || rank > a.nn;
  const int tile = rank == 0 ? a.ni - 1 : is_y ? a.ni - 1 - (rank - a.nn) : rank - 1;
  const int q = a.q, H = a.H, P = a.P, N = a.N;
  const int h0 = g * a.R + sub * HS;
  const int nh = min(HS, a.R - sub * HS);
  const int nu = nh * NP;                       // units: head u / NP, p block u % NP
  const int i0 = tile * kT;                     // y: rows i; state: rows n
  const int jend = is_y ? min(q, i0 + kT) : q;  // columns j that count
  const int njt = (jend + kT - 1) / kT;         // j tiles
  const int nwin = (jend + kWJ - 1) / kWJ;      // windows of j tiles
  const int nbn = (N + kBox - 1) / kBox;        // boxes of a C or B row
  const int nbt = min(2, (N - i0 + kBox - 1) / kBox);  // boxes of an n tile
  const int x_ring = is_y ? kXY : kXS;
  const int tid = threadIdx.x;

  if (tid == 0) {
    wlk::mbar_init(&bar[kCFull], 1);
    for (int s = 0; s < 2; ++s) {
      wlk::mbar_init(&bar[kBFull + s], 1);
      wlk::mbar_init(&bar[kBEmpty + s], is_y ? 128 : 256);
    }
    for (int s = 0; s < kXStages; ++s) {
      wlk::mbar_init(&bar[kXFull + s], 1);
      wlk::mbar_init(&bar[kXEmpty + s], 128);
    }
    wlk::mbar_init(&bar[kRegionFree], 1);
    wlk::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // -------------------------------------------------- producer warpgroup
    wlk::setmaxnreg_dec<kProducerRegs>();
    if (tid >= 32) {
      // warps 1 .. 3: the cumulative sums of heads w - 1, w + 2, w + 5 --
      // the chain through the last row the block needs (y: i0 + 63, state:
      // q - 1), one window at a time in cs_w; y keeps its rows i in cs_i,
      // state the sum of all rows.  Then per window its sums (y) or w =
      // exp(cs_last - cs) (state) in cs_w, handed to the consumers by
      // named barrier 4; barrier 5 hands the window back.
      const int sw = tid / 32 - 1, lane = tid % 32;
      const float* dA0 = a.dA + (long long)bc * q * H + h0;
      float last[3], carry[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int hh = sw + 3 * k;
        last[k] = carry[k] = 0.f;
        if (hh >= nh) continue;
        float* csw = cs_w + hh * kWJ;
        const int end = is_y ? i0 + kT : njt * kT;
        int w0 = 0;
        for (; w0 + kWJ < end; w0 += kWJ)
          last[k] = scan_rows(dA0 + hh, H, q, w0, w0 + kWJ, last[k], csw, lane);
        last[k] = scan_rows(dA0 + hh, H, q, w0, end, last[k], csw, lane);
        if (is_y)
          for (int r = lane; r < kT; r += 32) cs_i[hh * kT + r] = csw[i0 - w0 + r];
      }
      for (int wi = 0; wi < nwin; ++wi) {
        const int jt0 = wi * kWT, nj = min(njt, jt0 + kWT) - jt0;
        if (wi > 0) wlk::named_sync(5, 352);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int hh = sw + 3 * k;
          if (hh >= nh) continue;
          float* csw = cs_w + hh * kWJ;
          // this window's sums, unless the chain above left them in csw
          if (nwin > 1)
            carry[k] = scan_rows(dA0 + hh, H, q, jt0 * kT, (jt0 + nj) * kT,
                                 carry[k], csw, lane);
          if (!is_y)
            for (int r = lane; r < nj * kT; r += 32)
              csw[r] = (jt0 * kT + r) < q ? expf(last[k] - csw[r]) : 0.f;
        }
        wlk::named_arrive(4, 352);
      }
      return;
    }
    if (tid != 0) return;
    int bseq = 0, xseq = 0;
    for (int wi = 0; wi < nwin; ++wi) {
      const int jt0 = wi * kWT, nj = min(njt, jt0 + kWT) - jt0;
      if (wi > 0) wlk::mbar_wait(&bar[kRegionFree], (wi - 1) & 1);
      if (is_y) {
        wlk::mbar_arrive_expect_tx(&bar[kCFull], nbn * kBoxBytes);
        for (int b = 0; b < nbn; ++b)
          wlk::tma_load_4d(base + kC + b * kBoxBytes, &cm, &bar[kCFull],
                           b * kBox, g, i0, bc);
      }
      for (int jl = 0; jl < nj; ++jl, ++bseq) {  // B: whole rows, or the n tile
        const int s = bseq & 1, boxes = is_y ? nbn : nbt;
        unsigned char* dst = base + (is_y ? kBStage + s * 4 * kBoxBytes
                                          : kBtStage + s * 2 * kBoxBytes);
        wlk::mbar_wait(&bar[kBEmpty + s], ((bseq >> 1) & 1) ^ 1);
        wlk::mbar_arrive_expect_tx(&bar[kBFull + s], boxes * kBoxBytes);
        for (int b = 0; b < boxes; ++b)
          wlk::tma_load_4d(dst + b * kBoxBytes, &bm, &bar[kBFull + s],
                           (is_y ? 0 : i0) + b * kBox, g, (jt0 + jl) * kT, bc);
      }
      // the x ring overlaps the B stages: both must be released
      for (int k = 0; k < 2; ++k)
        wlk::mbar_wait(&bar[kBEmpty + ((bseq + k) & 1)], (((bseq + k) >> 1) & 1) ^ 1);
      for (int m = 0; 2 * m < nu; ++m) {  // x tiles in x_order
        const int pair = min(2, nu - 2 * m);
        for (int jl = 0; jl < nj; ++jl)
          for (int u = 2 * m; u < 2 * m + pair; ++u, ++xseq) {
            const int slot = xseq % kXStages;
            wlk::mbar_wait(&bar[kXEmpty + slot], ((xseq / kXStages) & 1) ^ 1);
            const int p0 = (u % NP) * kT;
            const int nbx = min(2, (P - p0 + kBox - 1) / kBox);
            wlk::mbar_arrive_expect_tx(&bar[kXFull + slot], nbx * kBoxBytes);
            for (int b = 0; b < nbx; ++b)
              wlk::tma_load_4d(base + x_ring + (2 * slot + b) * kBoxBytes, &xm,
                               &bar[kXFull + slot], p0 + b * kBox, h0 + u / NP,
                               (jt0 + jl) * kT, bc);
          }
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  wlk::setmaxnreg_inc<kConsumerRegs>();
  const int t256 = tid - 128;
  // the consumer, broadcast so that ptxas sees it warp-uniform: a loop
  // over it around wgmma is then not a divergent path
  const int c = __shfl_sync(0xffffffffu, t256 / 128, 0);
  const int t128 = t256 % 128;
  const int lane = tid % 32;
  const int wq = t128 / 32, t = lane % 4;
  const int mrow = 16 * wq + 2 * (lane / 4);       // fragment row pair
  int bseq = 0, xseq = 0;
  for (int wi = 0; wi < nwin; ++wi) {
    const int jt0 = wi * kWT, nj = min(njt, jt0 + kWT) - jt0;

    if (is_y) {
      // ---- S phase: C split in place into hi and a lo copy
      wlk::mbar_wait(&bar[kCFull], wi & 1);
      {
        const int r = t256 % 64, box = t256 / 64;
        if (box < nbn) {
          const float* cb = sm + kC / 4 + box * kBoxFloats;
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4) {
            const float4 u0 = ld4(cb + swz(r, 8 * s4)), u1 = ld4(cb + swz(r, 8 * s4 + 4));
            const float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
            put_step(sm + kC / 4, sm + kCLo / 4, r, 4 * box + s4, v);
          }
        }
      }
      wlk::fence_proxy_async();
      wlk::named_sync(1, 256);
      // S^T for j tile jl: M = 64 rows j (B's, from registers), N = 64 rows
      // i (C hi/lo), K = n in chunks of one box (4 k8 steps, zeros past N);
      // the consumers take the window's j tiles in turns
      for (int jl = c; jl < nj; jl += 2) {
        const int sb = bseq + jl, s = sb & 1;
        wlk::mbar_wait(&bar[kBFull + s], (sb >> 1) & 1);
        const float* bt = sm + (kBStage + s * 4 * kBoxBytes) / 4;
        float tot[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) tot[e] = 0.f;
        for (int kc = 0; kc < nbn; ++kc) {
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) frag_cols(bt, 4 * kc + k, mrow, t, ah[k], al[k]);
          if (kc == nbn - 1) wlk::mbar_arrive(&bar[kBEmpty + s]);  // B read
          float d[32];
          wlk::fence_regs(d);
          wlk::wgmma_fence();
          mma3<4>(d, ah, al, sm + kC / 4, sm + kCLo / 4, 4 * kc);
          accumulate(tot, d);
        }
        // tot[4nb + e] = S^T(j = mrow, i = 8nb + 2t + e), [4nb + 2 + e] row j + 1
        float* s_s = sm + kS / 4;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(s_s + (8 * nb + 2 * t + e) * kSLD + jl * kT + mrow) =
                make_float2(tot[4 * nb + e], tot[4 * nb + 2 + e]);
      }
    } else {
      // ---- B^T of every j tile of the window: row n, columns 16 jq ..
      const int n = t256 % 64, jq = t256 / 64;
      for (int jl = 0; jl < nj; ++jl) {
        const int sb = bseq + jl, s = sb & 1;
        wlk::mbar_wait(&bar[kBFull + s], (sb >> 1) & 1);
        const float* bb = sm + (kBtStage + s * 2 * kBoxBytes) / 4 + (n >> 5) * kBoxFloats;
        const bool in = i0 + n < N;
        float v[2][8];
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[s2][e] = in ? bb[swz(16 * jq + 8 * s2 + e, n & 31)] : 0.f;
        wlk::mbar_arrive(&bar[kBEmpty + s]);
        float* hi = sm + (kBT + 4 * jl * kBoxBytes) / 4;
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) put_step(hi, hi + 2 * kBoxFloats, n, 2 * jq + s2, v[s2]);
      }
      wlk::fence_proxy_async();
    }
    bseq += nj;
    wlk::named_sync(1, 256);  // S or B^T complete
    wlk::named_sync(4, 352);  // the window's sums complete

    // ---- per unit of this consumer, over the window's j tiles:
    // y^T += x^T (S o L_h)^T, or state^T += (w x)^T B^T
    float* sl_hi = sm + (kSL + 4 * c * kBoxBytes) / 4;
    float* sl_lo = sl_hi + 2 * kBoxFloats;
    const int fi = t128 % 64, fk = 2 * (t128 / 64);  // (S o L): row i, k8 steps
    for (int u = c; u < nu; u += 2) {
      const int hh = u / NP;
      const float csi = cs_i[hh * kT + fi];
      float tot[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) tot[e] = 0.f;
      for (int jl = 0; jl < nj; ++jl) {
        // y: (S o L_h) of j tile jl into box h (columns 32 h .. 32 h + 31)
        // of this consumer's buffer: row fi, k8 steps 4 h + fk, + 1
        // below: the tile lies wholly below the diagonal and above row q,
        // so L needs no select there
        const bool below = jt0 + jl < tile && i0 + kT <= q;
        auto form = [&](int h) {
          const int gi = i0 + fi;
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const int kk = 4 * h + fk + s2, col = jl * kT + 8 * kk;
            const float* srow = sm + kS / 4 + fi * kSLD + col;
            const float* csj = cs_w + hh * kWJ + col;
            const float4 s0 = ld4(srow), s1 = ld4(srow + 4);
            const float4 c0 = ld4(csj), c1 = ld4(csj + 4);
            const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
            const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              v[e] = sv[e] * __expf(csi - cv[e]);
              if (!below) v[e] = gi < q && gi >= jt0 * kT + col + e ? v[e] : 0.f;
            }
            put_step(sl_hi, sl_lo, fi, kk, v);
          }
          wlk::fence_proxy_async();
          wlk::named_sync(2 + c, 128);
        };
        const int sx = xseq + x_order(u, jl, nu, nj), slot = sx % kXStages;
        const float* xt = sm + (x_ring + 2 * slot * kBoxBytes) / 4;
        const float* wv = cs_w + hh * kWJ + jl * kT;
        uint32_t ah[2][4][4], al[2][4][4];  // the A fragments of k8 steps 4 h ..
        auto frags = [&](int h) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            frag_rows(xt, 4 * h + k, mrow, t,
                      is_y ? make_float2(1.f, 1.f) : ld2(wv + 8 * (4 * h + k) + 2 * t),
                      ah[h][k], al[h][k]);
        };
        const float* bh = is_y ? sl_hi : sm + (kBT + 4 * jl * kBoxBytes) / 4;
        const float* bl = bh + 2 * kBoxFloats;
        float d[32];
        if (is_y) form(0);
        wlk::mbar_wait(&bar[kXFull + slot], (sx / kXStages) & 1);
        frags(0);
        if (!is_y) frags(1);
        wlk::fence_regs(d);
        wlk::wgmma_fence();
        mma3<4>(d, ah[0], al[0], bh, bl, 0);
        if (is_y) {  // the second half forms while the first multiplies
          form(1);
          frags(1);
          wlk::wgmma_fence();
        }
        wlk::mbar_arrive(&bar[kXEmpty + slot]);  // x read: the slot refills now
        mma3<4, false>(d, ah[1], al[1], bh, bl, 4);
        accumulate(tot, d);
      }
      // tot[4nb + e] = y^T or state^T (p = mrow, i or n = 8nb + 2t + e),
      // tot[4nb + 2 + e] p + 1; a later window adds to what is written
      const int p = (u % NP) * kT + mrow;
      if (p < P) {
        float* out = is_y ? a.y + ((long long)bc * q * H + h0 + hh) * P + p
                          : a.st + ((long long)bc * H + h0 + hh) * N * P + p;
        const long long step = is_y ? (long long)H * P : P;
        const int rows = is_y ? q : N;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = i0 + 8 * nb + 2 * t + e;
            if (r >= rows) continue;
            float2* o = reinterpret_cast<float2*>(out + r * step);
            float2 v = make_float2(tot[4 * nb + e], tot[4 * nb + 2 + e]);
            if (wi > 0) {
              const float2 old = *o;
              v = make_float2(old.x + v.x, old.y + v.y);
            }
            *o = v;
          }
      }
    }
    xseq += nu * nj;
    wlk::named_sync(1, 256);  // the region and the sums read
    if (t256 == 0) wlk::mbar_arrive(&bar[kRegionFree]);
    if (wi + 1 < nwin) wlk::named_arrive(5, 352);
  }
}

// The TMA map of a (B NC, q, heads, W) float32 tensor, C-contiguous, read
// in boxes of 64 rows q x 32 elements, 128-byte swizzle; rows past q and
// columns past W read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, long long bnc, long long q,
              long long heads, long long w) {
  const wlk::EncodeTiled encode = wlk::encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)heads, (cuuint64_t)q,
                              (cuuint64_t)bnc};
  const cuuint64_t strides[3] = {(cuuint64_t)(w * 4), (cuuint64_t)(heads * w * 4),
                                 (cuuint64_t)(q * heads * w * 4)};
  const cuuint32_t box[4] = {kBox, 1, kT, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP>
cudaError_t launch(const float* x, const float* Bm, const float* Cm, Args a,
                   long long bnc, cudaStream_t stream) {
  auto kernel = ssd_tc_kernel<NP>;
  // setmaxnreg only moves registers within the block: the consumers' rise
  // is paid by the producer's fall only if the block starts with 168 each.
  static const cudaError_t regs = [&]() -> cudaError_t {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs * kThreads >= kConsumerRegs * 256 + kProducerRegs * 128
               ? cudaSuccess
               : cudaErrorInvalidConfiguration;
  }();
  if (regs != cudaSuccess) return regs;
  CUtensorMap xm, bm, cm;
  if (!make_map(&xm, x, bnc, a.q, a.H, a.P) ||
      !make_map(&bm, Bm, bnc, a.q, a.G, a.N) ||
      !make_map(&cm, Cm, bnc, a.q, a.G, a.N))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(a.inner * (a.ni + a.nn)), kThreads, kSmem, stream>>>(
      xm, bm, cm, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, NC, q, H, P), dA (B, NC, q, H), Bm/Cm (B, NC, q, G, N) in;
// y (B, NC, q, H, P), states (B, NC, H, N, P) out; float32, C-contiguous,
// every pointer but dA's on a 16-byte boundary.  P and N multiples of 4 in [4, 128];
// H a multiple of G; all extents > 0.
int wlk_ssd_intra_chunk(const float* x, const float* dA, const float* Bm,
                        const float* Cm, float* y, float* st, long long B,
                        long long NC, long long q, long long H, long long P,
                        long long G, long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || NC < 1 || q < 1 || H < 1 || G < 1 || H % G != 0 || P < 4 ||
      P > 128 || P % 4 || N < 4 || N > 128 || N % 4 || q > (1 << 30) ||
      B * NC > (1 << 30) || H > (1 << 30))
    return cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)y |
       (uintptr_t)st) % 16)
    return cudaErrorMisalignedAddress;
  const int np = P <= 64 ? 1 : 2;
  Args a;
  a.dA = dA; a.y = y; a.st = st;
  a.H = (int)H; a.G = (int)G; a.q = (int)q; a.P = (int)P; a.N = (int)N;
  a.R = (int)(H / G);
  a.nsub = (a.R + kHeads / np - 1) / (kHeads / np);
  a.ni = (int)((q + kT - 1) / kT);
  a.nn = (int)((N + kT - 1) / kT);
  a.inner = B * NC * G * a.nsub;
  if (a.inner * (a.ni + a.nn) > 0x7fffffffLL) return cudaErrorInvalidValue;
  return np == 1 ? launch<1>(x, Bm, Cm, a, B * NC, s)
                 : launch<2>(x, Bm, Cm, a, B * NC, s);
}

}  // extern "C"
