// Shared pieces of the strided pack/unpack kernels (pack.cu, unpack.cu).
//
// Every kernel addresses a batch of byte buffers: buffer b starts at
// `ptr + b * bstride` (bytes), and within a buffer the canonical
// StridedBlock is described by scalars in W-byte words only:
//   block (p, i) starts at word  base + p * plane_stride + i * pitch
//   and runs `lanes` words;      packed word (p, i, l) is at
//   (p * rows + i) * lanes + l.
// base = q * pitch + r and plane_stride = plane_rows * pitch come from
// repro_torch.kernels.geometry.PackGeometry.  No per-block metadata ever
// lives in device memory (the paper's key property).
//
// Every C entry takes the CUDA device and stream of the tensors, launches
// on that stream without synchronising, and returns cudaGetLastError() of
// the launch (cudaErrorInvalidValue for arguments it does not take).
#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace tempi {

// Bytes of one staged tile of the dma kernels.  A tile is `chunk` rows of
// `tile_lanes` words; any size that fits the 48 KB of static shared memory
// works, and 16 KB leaves room for several blocks per SM.
constexpr int kTileBytes = 16384;
constexpr int kThreads = 256;
constexpr long long kMaxGridX = 1LL << 20;

// Copy one T-byte unit from global to shared memory.  For T of 4, 8 or 16
// bytes this is an asynchronous cp.async.ca (Ampere and later, so
// Hopper); narrower units are plain loads and stores.
template <typename T>
__device__ __forceinline__ void copy_to_shared(T* smem, const T* gmem) {
  if constexpr (sizeof(T) >= 4) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(static_cast<int>(sizeof(T)))
                 : "memory");
  } else {
    *smem = *gmem;
  }
}

// Wait until every cp.async this thread issued has landed.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tile shape of the dma kernels: as many whole rows of the block as fit a
// tile, or a slice of one row when a single row is wider than a tile.
struct Tiles {
  int tile_lanes;
  int chunk;
  long long n_ltiles;
  long long n_rtiles;
  long long count;  // tiles per buffer
};

inline Tiles dma_tiles(long long lanes, long long rows, long long planes, int word) {
  Tiles t;
  long long tw = kTileBytes / word;
  long long tl = lanes < tw ? lanes : tw;
  long long ch = tw / tl;
  if (ch > rows) ch = rows;
  t.tile_lanes = static_cast<int>(tl);
  t.chunk = static_cast<int>(ch);
  t.n_ltiles = (lanes + tl - 1) / tl;
  t.n_rtiles = (rows + ch - 1) / ch;
  t.count = planes * t.n_rtiles * t.n_ltiles;
  return t;
}

inline bool bad_launch(int batch, long long grid_x) {
  return batch < 1 || batch > 65535 || grid_x < 1 || grid_x > INT_MAX;
}

inline long long simt_blocks(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return b < kMaxGridX ? b : kMaxGridX;
}

// Whether the row kernels (rows.cuh) may do their index arithmetic in 32
// bits: the packed vector count and the last vector a block touches (plus
// one grid stride of headroom) stay below 2^30, all in V-byte vectors.
// 64-bit division costs several times more instructions than the copy it
// addresses.
inline bool fits_int(long long total, long long lanes, long long rows,
                     long long planes, long long pitch, long long base,
                     long long plane_stride) {
  const long long span =
      base + (planes - 1) * plane_stride + (rows - 1) * pitch + lanes;
  return total < (1LL << 30) && span < (1LL << 30);
}

}  // namespace tempi
