// Strided pack kernels for Hopper (sm_90a), loaded with ctypes from
// repro_torch/kernels/pack.py.  See common.cuh for the addressing scheme.
//
// tempi_pack_rows replaces the Pallas TPU kernel `pack_rows` /
// `_pack_rows_kernel` (src/repro/kernels/pack.py).  It is the paper's own
// "device" kernel, a SIMT grid over the block's rows (rows.cuh).  Bound:
// the bytes it moves at HBM bandwidth, each block byte read once and each
// packed byte written once.  The TPU kernel read whole pitch rows because
// VMEM tiles are rows; this kernel reads only block bytes.
//
// What held the first version back at the rows the main path gives it
// (the y and z faces and the dx = 0 edges of the halo: 1 KB rows at a
// 1,040-byte pitch, 4 MiB per face launch for 8 ranks): one thread per
// 4-byte word, two integer divisions per word, one 4-byte load in flight
// per thread, too few bytes in flight per SM for a cold copy.  Now
// (rows.cuh) a warp takes a row, or a 128-vector chunk of a longer one,
// and finds its offsets once; words become V-byte vectors, V the widest
// that divides every address; each thread has 4 loads in flight before
// it stores.  At the faces V = 8 (rows start at byte 8 mod 16), a row is
// one chunk, and a face's 4 MiB fits in flight at once (about 31 KB per
// SM).  There is no 16-byte path with a peeled head and tail: 8-byte
// lanes already fill whole 32-byte sectors, so 16 bytes would save
// instructions, not bytes.  Short rows (corners: one 8-byte vector)
// take one thread per vector.
//
// tempi_pack_dma replaces the Pallas TPU kernel `pack_dma` /
// `_pack_dma_kernel` (same file).  The TPU version issued one strided DMA
// of `chunk x lanes` words per grid step into VMEM scratch; here thread
// blocks stage the block through shared memory, the Hopper counterpart of
// that scratch, and store what they staged contiguously.  Bound: the
// 32-byte sectors that the block's bytes touch, read once, plus the packed
// bytes written once, at HBM bandwidth (chip_smoke.py, bound_sectors_ms).
//
// The main path gives this kernel only 8-byte rows (2 words of 4 bytes)
// at a 1,040-byte pitch, starting at byte 8 mod 16: the x faces
// (2 x 256 x 256 words, lanes x rows x planes) and the dy = 0 and
// dz = 0 edges (2 x 256 x 2 and 2 x 2 x 256), 8 ranks a launch.  The
// first version, kept as the tiled path for rows longer than 16 bytes
// (pack_tiled_kernel), was written for wide tiles, and at those rows:
//   - a 16 KB tile held whole rows of one plane, so at the dz = 0 edges
//     a 256-thread block staged 2 x 2 words (one thread in 64 worked)
//     over 2,048 blocks, and at the dy = 0 edges the launch had 16
//     blocks for 132 SMs;
//   - it copied 4-byte words, two cp.async of 4 bytes per row, and each
//     thread had one row in flight before its single wait.
// The narrow path (narrow.cuh) takes rows of at most 16 bytes.  A tile
// is a run of consecutive rows across plane boundaries, sized on the host
// (dma_args) so that every thread has rows and the edges spread over the
// SMs (4,096 rows: 128 tiles of 32); a row is one cp.async of V bytes
// (V = 8 at the halo), each thread issues all its rows (2 at the x faces)
// before one wait, and the tile's packed span is stored contiguously in
// 16-byte units.  No TMA: a tiled TMA copy needs its inner box to span a
// multiple of 16 bytes from a 16-byte-aligned address, and these rows
// are 8 bytes long at 8 mod 16.  At the x faces each 8-byte row sits
// alone in a 32-byte sector, so any kernel reads 32 bytes for every 8 it
// packs: the sector bound, not the byte bound, is the one to hold it to.
//
// Neither kernel reads a byte past the last block: the ragged tail of a
// buffer is real data, and no padding copy of the buffer is ever made.

#include "narrow.cuh"

namespace tempi {

// The tiled path: one `chunk x tile_lanes` tile of one plane per block.
template <typename T>
__global__ void pack_tiled_kernel(const unsigned char* __restrict__ src,
                                  long long src_bstride,
                                  unsigned char* __restrict__ out,
                                  long long out_bstride, long long lanes,
                                  long long rows, long long pitch, long long base,
                                  long long plane_stride, int tile_lanes,
                                  int chunk, long long n_ltiles,
                                  long long n_rtiles) {
  __shared__ __align__(16) T tile[kTileBytes / sizeof(T)];
  const T* s = reinterpret_cast<const T*>(src + blockIdx.y * src_bstride);
  T* o = reinterpret_cast<T*>(out + blockIdx.y * out_bstride);

  const long long t = blockIdx.x;
  const long long lt = t % n_ltiles;
  const long long rt = (t / n_ltiles) % n_rtiles;
  const long long p = t / (n_ltiles * n_rtiles);
  const long long l0 = lt * tile_lanes;
  const long long i0 = rt * chunk;
  const int tl = static_cast<int>(lanes - l0 < tile_lanes ? lanes - l0 : tile_lanes);
  const int nr = static_cast<int>(rows - i0 < chunk ? rows - i0 : chunk);
  const int n = tl * nr;

  const T* g = s + base + p * plane_stride + i0 * pitch + l0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int ii = k / tl;
    const int ll = k - ii * tl;
    copy_to_shared(&tile[k], g + ii * pitch + ll);
  }
  copy_wait();
  __syncthreads();

  T* d = o + (p * rows + i0) * lanes + l0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int ii = k / tl;
    const int ll = k - ii * tl;
    d[ii * lanes + ll] = tile[k];
  }
}

template <typename V>
int launch_pack_rows(const void* src, long long src_bstride, void* out,
                     long long out_bstride, int batch, int word,
                     long long lanes, long long rows, long long planes,
                     long long pitch, long long base, long long plane_stride,
                     int vec, int path, cudaStream_t stream) {
  return launch_rows<V, true>(src, src_bstride, out, out_bstride, batch, word,
                              lanes, rows, planes, pitch, base, plane_stride,
                              vec, path, stream);
}

template <typename V>
int launch_pack_dma(const void* src, long long src_bstride, void* out,
                    long long out_bstride, int batch, int word, long long lanes,
                    long long rows, long long planes, long long pitch, long long base,
                    long long plane_stride, int vec, int path, int tile_rows,
                    cudaStream_t stream) {
  if (path == kDmaNarrow)
    return launch_narrow<V, true>(src, src_bstride, out, out_bstride, batch, word,
                                  lanes, rows, planes, pitch, base, plane_stride, vec,
                                  tile_rows, stream);
  if constexpr (sizeof(V) <= 4) {
    const Tiles tiles = dma_tiles(lanes, rows, planes, sizeof(V));
    if (path != kDmaTiled || vec != word || bad_launch(batch, tiles.count))
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(static_cast<unsigned>(tiles.count), static_cast<unsigned>(batch));
    pack_tiled_kernel<V><<<grid, kThreads, 0, stream>>>(
        static_cast<const unsigned char*>(src), src_bstride,
        static_cast<unsigned char*>(out), out_bstride, lanes, rows, pitch, base,
        plane_stride, tiles.tile_lanes, tiles.chunk, tiles.n_ltiles, tiles.n_rtiles);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);  // the tiled path copies words
}

}  // namespace tempi

extern "C" int tempi_pack_rows(const void* src, long long src_bstride,
                               void* out, long long out_bstride, int batch,
                               int word, long long lanes, long long rows,
                               long long planes, long long pitch,
                               long long base, long long plane_stride, int vec,
                               int path, int device, void* stream) {
  TEMPI_DISPATCH_VEC(device, vec, launch_pack_rows, src, src_bstride, out,
                     out_bstride, batch, word, lanes, rows, planes, pitch, base,
                     plane_stride, vec, path, static_cast<cudaStream_t>(stream));
}

extern "C" int tempi_pack_dma(const void* src, long long src_bstride,
                              void* out, long long out_bstride, int batch,
                              int word, long long lanes, long long rows,
                              long long planes, long long pitch, long long base,
                              long long plane_stride, int vec, int path,
                              int tile_rows, int device, void* stream) {
  TEMPI_DISPATCH_VEC(device, vec, launch_pack_dma, src, src_bstride, out,
                     out_bstride, batch, word, lanes, rows, planes, pitch, base,
                     plane_stride, vec, path, tile_rows,
                     static_cast<cudaStream_t>(stream));
}
