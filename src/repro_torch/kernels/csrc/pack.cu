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
// of `chunk x lanes` words per grid step into VMEM scratch.  Here each
// thread block stages one `chunk x tile_lanes` tile of the block into
// shared memory with cp.async (W = 4; plain loads for W = 1, 2), waits,
// and stores the tile contiguously.  Bound: the same bytes at HBM
// bandwidth.  The TPU's VMEM budget (`choose_chunk`) becomes the 16 KB
// tile of common.cuh.  A TMA (cp.async.bulk.tensor) version is the
// roadmap's next step for this kernel.
//
// Neither kernel reads a byte past the last block: the ragged tail of a
// buffer is real data, and no padding copy of the buffer is ever made.

#include "rows.cuh"

namespace tempi {

template <typename T>
__global__ void pack_dma_kernel(const unsigned char* __restrict__ src,
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

template <typename T>
int launch_pack_dma(const void* src, long long src_bstride, void* out,
                    long long out_bstride, int batch, long long lanes,
                    long long rows, long long planes, long long pitch,
                    long long base, long long plane_stride, cudaStream_t stream) {
  const Tiles tiles = dma_tiles(lanes, rows, planes, sizeof(T));
  if (bad_launch(batch, tiles.count)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles.count), static_cast<unsigned>(batch));
  pack_dma_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(src), src_bstride,
      static_cast<unsigned char*>(out), out_bstride, lanes, rows, pitch, base,
      plane_stride, tiles.tile_lanes, tiles.chunk, tiles.n_ltiles,
      tiles.n_rtiles);
  return static_cast<int>(cudaGetLastError());
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
                              long long plane_stride, int device, void* stream) {
  TEMPI_DISPATCH_WORD(device, word, launch_pack_dma, src, src_bstride, out,
                      out_bstride, batch, lanes, rows, planes, pitch, base,
                      plane_stride, static_cast<cudaStream_t>(stream));
}
