// PTX helpers shared by the port's kernels.  Header only; every kernel
// source that includes it is rebuilt when it changes (kernels/build.py
// hashes csrc/*.cuh).
//
// sm_90a instructions (K3 in bf16, K4 in 3xTF32):
// - mbarrier: a 64-bit barrier in shared memory whose phase completes when
//   its expected arrivals have arrived and the bytes announced with
//   expect_tx have landed; a waiter names the parity of the phase it waits
//   for (a fresh barrier is in phase 0, so waiting on parity 1 passes).
// - TMA (cp.async.bulk.tensor): one thread copies a box of a tensor that a
//   CUtensorMap describes, device to shared memory (reporting its bytes to
//   an mbarrier) or back (tracked by bulk groups).  Rows outside the tensor
//   are read as zeros and not written.
// - wgmma: a warpgroup (4 warps, 128 threads) issues an asynchronous
//   64 x N x 16 product; B, and A or A from registers, read from shared
//   memory through matrix descriptors, the float32 sum kept in registers.
// - setmaxnreg moves registers between warpgroups; named barriers
//   (bar.sync / bar.arrive) order warpgroups without stopping the block.
//
// wgmma's float32 accumulator of m64nN: thread i of the warpgroup (warp
// w = i / 32, lane l, g = l / 4, t = l % 4) holds, for each block j of 8
// columns, d[4j], d[4j + 1] = (row 16w + g, cols 8j + 2t, 8j + 2t + 1) and
// d[4j + 2], d[4j + 3] = (row 16w + g + 8, the same cols): per warp,
// mma.m16n8k16's C fragment repeated along N.  An A operand in registers
// (64 x 16 bf16) is per warp mma.m16n8k16's A fragment, four .b32 of two
// bf16: (row g, k 2t, 2t+1), (row g+8, k 2t, 2t+1), (row g, k 2t+8, 2t+9),
// (row g+8, k 2t+8, 2t+9).  So the accumulator's column blocks 2k and
// 2k + 1, rounded to bf16 and packed in pairs, are the A operand of the
// k16 step k of a second product.
//
// In TF32 (m64nNk8) the A operand in registers is per warp mma.m16n8k8's:
// four .b32, (row g, k t), (row g + 8, k t), (row g, k t + 4), (row g + 8,
// k t + 4) -- other columns than the accumulator's, so an accumulator is
// not an A operand as it stands.  A TF32 operand in shared memory must be
// K-major: wgmma transposes only 16-bit types.  A k8 step of TF32 is 32
// bytes, as a k16 step of bf16, so the descriptors below serve both.
//
// Shared-memory matrix descriptor: start address >> 4 (bits 0-13), leading
// byte offset (LBO) >> 4 (16-29), stride byte offset (SBO) >> 4 (32-45),
// layout (62-63: 1 = 128-byte swizzle, 3 = 32-byte swizzle).  With a
// W-byte swizzle an operand lies in rows of W bytes whose 16-byte units are
// permuted by XOR with the row's index bits (Swizzle<log2(W/16), 4, 3>, as
// TMA writes them).  K-major (the k index contiguous): one row per m or n
// index, SBO the step between groups of 8 rows, LBO unused.  N-major
// ("transposed" B, the n index contiguous): one row of W/2 n indices per
// k, SBO the step between groups of 8 k rows, LBO the step between blocks
// of W/2 n indices.  Tiles start on 1024-byte boundaries, so the swizzle's
// phase is the address's.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wlk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to nearest even into one .b32 of bf16 (lo in the low
// half, the first element of an A fragment pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ----------------------------------------------------------------- TF32

// a rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the largest floats to inf), in a float whose low 13 mantissa
// bits are zero: half a TF32 ulp added to the magnitude's bits, then the
// low bits cleared.  Two integer operations, where the conversion compiles
// to a longer sequence that also tests for NaN; a NaN whose payload lies
// only in the low 13 bits becomes inf here.
__device__ __forceinline__ float tf32_rna(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

// 3xTF32: a = hi + lo, both TF32, to about 2^-22 of |a|.  The products
// hi hi' + hi lo' + lo hi' then keep float32's accuracy (lo lo' is dropped).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32_rna(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(a - h));
}

// ------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` more to land before the phase
// completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Block until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------- TMA

// Box at coordinates (c0 innermost .. c3) of the 4-D tensor map `map` (the
// address of a __grid_constant__ CUtensorMap parameter) into `dst`; its
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `src` to the box at (c0 .. c3) of `map`; rows outside the tensor are
// dropped.  Commit with tma_store_wait.
__device__ __forceinline__ void tma_store_4d(const void* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commits this thread's stores and waits until they have read shared
// memory (which may then be reused or freed).
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before the async proxy's
// (TMA's) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------- warpgroups and named barriers

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Wait at named barrier `id` until `threads` threads (whole warps) have
// arrived, these included.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------- wgmma

// layout: 1 = 128-byte swizzle, 3 = 32-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo, int layout) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) |
         ((uint64_t)layout << 62);
}

// Before the first wgmma that reads registers (accumulator or A) that
// other instructions wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of `d` across the
// asynchronous window of a wgmma (between its issue and wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WLK_F8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a b, m64n128k16: A (64 x 16) and B (128 x 16) K-major in shared
// memory; scale_d = 0 ignores d's previous contents.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24),
        WLK_F8(d, 32), WLK_F8(d, 40),
        WLK_F8(d, 48), WLK_F8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b, m64n64k16: A (64 x 16) and B (64 x 16) K-major in shared
// memory; scale_d = 0 ignores d's previous contents.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += a b, m64nNk16: A (64 x 16) in registers (the mma.m16n8k16 A
// fragment of each warp's 16 rows), B (16 x N) N-major ("transposed") in
// shared memory.
template <int N>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t b);

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<16>(float (&d)[8],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<32>(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<48>(float (&d)[24],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<80>(float (&d)[40],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24),
        WLK_F8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<96>(float (&d)[48],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24),
        WLK_F8(d, 32), WLK_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<112>(float (&d)[56],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24),
        WLK_F8(d, 32), WLK_F8(d, 40),
        WLK_F8(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24),
        WLK_F8(d, 32), WLK_F8(d, 40),
        WLK_F8(d, 48), WLK_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<224>(float (&d)[112],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24),
        WLK_F8(d, 32), WLK_F8(d, 40),
        WLK_F8(d, 48), WLK_F8(d, 56),
        WLK_F8(d, 64), WLK_F8(d, 72),
        WLK_F8(d, 80), WLK_F8(d, 88),
        WLK_F8(d, 96), WLK_F8(d, 104)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= a b, m64n64k8 in TF32: A (64 x 8) in registers (the mma.m16n8k8
// TF32 A fragment of each warp's 16 rows), B (8 x 64) K-major in shared
// memory; float32 sums, which the tensor cores round toward zero at each
// instruction.  scale_d = 0 ignores d's previous contents.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WLK_F8(d, 0), WLK_F8(d, 8),
        WLK_F8(d, 16), WLK_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef WLK_F8

// ------------------------------------------------------------ TMA maps

// cuTensorMapEncodeTiled is a driver function; the build links only the
// runtime, which hands out the driver's entry points.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace wlk
