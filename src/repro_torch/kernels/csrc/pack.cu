// Block-gather (pack) kernels of the transport's reshard step, for Hopper.
//
// They replace the two Pallas kernels of the JAX package,
// src/repro/kernels/pack.py:
//
//   wlk_pack_rows  <- pack_blocks (K1):
//       out[t*tr:(t+1)*tr, :] = src[offs[t]*tr:(offs[t]+1)*tr, :]
//   wlk_pack_cols  <- pack_cols   (K2):
//       out[:, t*tc:(t+1)*tc] = src[:, offs[t]*tc:(offs[t]+1)*tc]
//
// Rows (K1) or columns (K2) past the end of a ragged source read as zeros,
// as the Pallas version's zero padding gives them.  This fill is the only
// padding on the card: the reshard executor hands the kernels its unpadded
// buffer, so a ragged slab costs no padded copy.
//
// Bound: both kernels are pure data movement -- 2 * T * tile * row_bytes
// (each output byte written once, each gathered byte read once) over the
// card's memory bandwidth.  There is no arithmetic to hide.
//
// Design: the TPU version walks a sequential grid of DMA tiles steered by a
// scalar-prefetch operand.  Here every output tile is independent, so the
// grid is (tile, chunk) and each block reads its own tile offset.  In a
// C-contiguous (R, C) buffer a K1 row tile is ONE contiguous span of
// tr*C elements, so K1 is T span copies cut into 16 KiB chunks; K2 is R*T
// spans of tc elements (tc is arbitrary: tile_rows * inner for flattened
// N-D plans), grouped so one block moves about 16 KiB.  Every dtype is a
// byte copy, so the kernels are templated on the element size only
// (1/2/4/8 bytes) and bf16/int32/float64 need no case of their own.  Spans
// whose source and destination are both 16-byte aligned move with 16-byte
// vector accesses, the remainder (and any misaligned span) element-wise.
//
// Each entry point launches on the caller's stream, synchronises nothing,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 16384;
constexpr unsigned kMaxGridY = 65535;

// d[i] = (i < valid) ? s[i] : 0 for i in [0, n), the block's threads
// cooperating.  The 16-byte vector body covers the aligned valid prefix.
template <typename E>
__device__ __forceinline__ void copy_span(E* __restrict__ d,
                                          const E* __restrict__ s,
                                          long long n, long long valid) {
  long long head = 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(d) |
                         reinterpret_cast<uintptr_t>(s)) & 15) == 0;
  if (aligned) {
    constexpr long long kPerVec = 16 / sizeof(E);
    const long long nvec = (valid < n ? valid : n) / kPerVec;
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    uint4* dv = reinterpret_cast<uint4*>(d);
    for (long long i = threadIdx.x; i < nvec; i += blockDim.x) dv[i] = sv[i];
    head = nvec * kPerVec;
  }
  for (long long i = head + threadIdx.x; i < n; i += blockDim.x)
    d[i] = i < valid ? s[i] : E(0);
}

// K1: block (t, c) copies chunk c of output row tile t.
template <typename E>
__global__ void pack_rows_kernel(const E* __restrict__ src, E* __restrict__ out,
                                 const int32_t* __restrict__ offs,
                                 long long rows, long long cols,
                                 long long tile_rows, long long chunk,
                                 long long nchunks) {
  const long long t = blockIdx.x;
  const long long span = tile_rows * cols;
  const long long src_start = static_cast<long long>(offs[t]) * span;
  long long valid = rows * cols - src_start;
  valid = valid < 0 ? 0 : (valid > span ? span : valid);
  for (long long c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const long long begin = c * chunk;
    const long long n = (span - begin < chunk) ? span - begin : chunk;
    const long long v = valid - begin;
    copy_span<E>(out + t * span + begin, src + src_start + begin, n,
                 v < 0 ? 0 : v);
  }
}

// K2: block (t, g) copies the tile-t column band of row group g
// (rows_per_group rows).  Each row's band is one span of tc elements.
template <typename E>
__global__ void pack_cols_kernel(const E* __restrict__ src, E* __restrict__ out,
                                 const int32_t* __restrict__ offs,
                                 long long rows, long long cols,
                                 long long tile_cols, long long n_tiles,
                                 long long rows_per_group, long long ngroups) {
  const long long t = blockIdx.x;
  const long long col0 = static_cast<long long>(offs[t]) * tile_cols;
  long long valid = cols - col0;
  valid = valid < 0 ? 0 : (valid > tile_cols ? tile_cols : valid);
  const long long out_cols = n_tiles * tile_cols;
  for (long long g = blockIdx.y; g < ngroups; g += gridDim.y) {
    const long long r0 = g * rows_per_group;
    const long long r1 = (r0 + rows_per_group < rows) ? r0 + rows_per_group : rows;
    for (long long r = r0; r < r1; ++r)
      copy_span<E>(out + r * out_cols + t * tile_cols, src + r * cols + col0,
                   tile_cols, valid);
  }
}

unsigned grid_y(long long n) {
  return static_cast<unsigned>(n < kMaxGridY ? n : kMaxGridY);
}

template <typename E>
cudaError_t launch_rows(const void* src, void* out, const int32_t* offs,
                        long long rows, long long cols, long long tile_rows,
                        long long n_tiles, cudaStream_t stream) {
  const long long span = tile_rows * cols;
  const long long chunk = kChunkBytes / static_cast<long long>(sizeof(E));
  const long long nchunks = (span + chunk - 1) / chunk;
  dim3 grid(static_cast<unsigned>(n_tiles), grid_y(nchunks));
  pack_rows_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(src), static_cast<E*>(out), offs, rows, cols,
      tile_rows, chunk, nchunks);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_cols(const void* src, void* out, const int32_t* offs,
                        long long rows, long long cols, long long tile_cols,
                        long long n_tiles, cudaStream_t stream) {
  const long long band_bytes = tile_cols * static_cast<long long>(sizeof(E));
  long long per_group = kChunkBytes / band_bytes;
  per_group = per_group < 1 ? 1 : (per_group > rows ? rows : per_group);
  const long long ngroups = (rows + per_group - 1) / per_group;
  dim3 grid(static_cast<unsigned>(n_tiles), grid_y(ngroups));
  pack_cols_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(src), static_cast<E*>(out), offs, rows, cols,
      tile_cols, n_tiles, per_group, ngroups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: (rows, cols) C-contiguous, esize bytes per element; offs: n_tiles
// device int32 row-tile indices, each in [0, ceil(rows / tile_rows));
// out: (n_tiles * tile_rows, cols).  All extents > 0.
int wlk_pack_rows(const void* src, void* out, const int32_t* offs,
                  long long rows, long long cols, long long tile_rows,
                  long long n_tiles, int esize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (esize) {
    case 1: return launch_rows<uint8_t>(src, out, offs, rows, cols, tile_rows, n_tiles, s);
    case 2: return launch_rows<uint16_t>(src, out, offs, rows, cols, tile_rows, n_tiles, s);
    case 4: return launch_rows<uint32_t>(src, out, offs, rows, cols, tile_rows, n_tiles, s);
    case 8: return launch_rows<uint64_t>(src, out, offs, rows, cols, tile_rows, n_tiles, s);
    default: return cudaErrorInvalidValue;
  }
}

// src: (rows, cols) C-contiguous; offs: n_tiles device int32 column-tile
// indices, each in [0, ceil(cols / tile_cols)); out: (rows, n_tiles *
// tile_cols).  All extents > 0.
int wlk_pack_cols(const void* src, void* out, const int32_t* offs,
                  long long rows, long long cols, long long tile_cols,
                  long long n_tiles, int esize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (esize) {
    case 1: return launch_cols<uint8_t>(src, out, offs, rows, cols, tile_cols, n_tiles, s);
    case 2: return launch_cols<uint16_t>(src, out, offs, rows, cols, tile_cols, n_tiles, s);
    case 4: return launch_cols<uint32_t>(src, out, offs, rows, cols, tile_cols, n_tiles, s);
    case 8: return launch_cols<uint64_t>(src, out, offs, rows, cols, tile_cols, n_tiles, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
