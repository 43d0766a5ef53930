// Strided pack kernels for Hopper (sm_90a), loaded with ctypes from
// repro_torch/kernels/pack.py.  See common.cuh for the addressing scheme.
//
// tempi_pack_rows replaces the Pallas TPU kernel `pack_rows` /
// `_pack_rows_kernel` (src/repro/kernels/pack.py).  It is the paper's own
// "device" kernel: a SIMT grid with one thread per W-byte word of the
// packed output.  Threads run over the flattened (plane, row, lane) word
// index on gridDim.x (the largest dimension, so no 65535 cap binds) and
// the batch of buffers on gridDim.y.  Bound: the bytes it moves at HBM
// bandwidth — each block byte read once, each packed byte written once.
// The TPU kernel read whole pitch rows because VMEM tiles are rows; this
// kernel reads only block bytes, so it never over-fetches a row, and the
// writes are fully coalesced.  Reads are coalesced along a block's lanes;
// narrow blocks (the x faces of a halo, 8 bytes at a 1 KB pitch) still
// cost a 32-byte sector per block, which no kernel can avoid.  The index
// arithmetic runs in 32 bits whenever the offsets fit.
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

#include "common.cuh"

namespace tempi {

template <typename T, typename I>
__global__ void pack_rows_kernel(const unsigned char* __restrict__ src,
                                 long long src_bstride,
                                 unsigned char* __restrict__ out,
                                 long long out_bstride, I lanes, I rows,
                                 I total, I pitch, I base, I plane_stride) {
  const T* s = reinterpret_cast<const T*>(src + blockIdx.y * src_bstride);
  T* o = reinterpret_cast<T*>(out + blockIdx.y * out_bstride);
  const I step = static_cast<I>(gridDim.x) * blockDim.x;
  for (I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += step) {
    const I pi = t / lanes;
    const I l = t - pi * lanes;
    const I p = pi / rows;
    const I i = pi - p * rows;
    o[t] = s[base + p * plane_stride + i * pitch + l];
  }
}

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

template <typename T>
int launch_pack_rows(const void* src, long long src_bstride, void* out,
                     long long out_bstride, int batch, long long lanes,
                     long long rows, long long planes, long long pitch,
                     long long base, long long plane_stride,
                     cudaStream_t stream) {
  const long long total = planes * rows * lanes;
  const long long blocks = simt_blocks(total);
  if (bad_launch(batch, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  const auto* s = static_cast<const unsigned char*>(src);
  auto* o = static_cast<unsigned char*>(out);
  if (fits_int(total, lanes, rows, planes, pitch, base, plane_stride)) {
    pack_rows_kernel<T, int><<<grid, kThreads, 0, stream>>>(
        s, src_bstride, o, out_bstride, static_cast<int>(lanes),
        static_cast<int>(rows), static_cast<int>(total),
        static_cast<int>(pitch), static_cast<int>(base),
        static_cast<int>(plane_stride));
  } else {
    pack_rows_kernel<T, long long><<<grid, kThreads, 0, stream>>>(
        s, src_bstride, o, out_bstride, lanes, rows, total, pitch, base,
        plane_stride);
  }
  return static_cast<int>(cudaGetLastError());
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
                               long long base, long long plane_stride,
                               int device, void* stream) {
  TEMPI_DISPATCH_WORD(device, word, launch_pack_rows, src, src_bstride, out,
                      out_bstride, batch, lanes, rows, planes, pitch, base,
                      plane_stride, static_cast<cudaStream_t>(stream));
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
