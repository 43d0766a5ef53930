// Strided unpack kernels for Hopper (sm_90a), loaded with ctypes from
// repro_torch/kernels/unpack.py.  See common.cuh for the addressing scheme.
// Both write in place into the destination buffer and touch only block
// bytes: no read-modify-write of whole rows, no padding copy, nothing past
// the last block (the ragged tail of the buffer is real data).
//
// tempi_unpack_rows replaces the Pallas TPU kernel `unpack_rows` /
// `_unpack_rows_kernel` (src/repro/kernels/unpack.py), which fetched whole
// pitch rows, spliced the packed lanes in VMEM and wrote the rows back
// (input_output_aliases).  Here it is the exact inverse of pack_rows, the
// same template of rows.cuh with the copy turned round: packed vectors
// are read (read-only path) and stored into the block's rows.  Bound:
// packed bytes read once plus block bytes written once, at HBM
// bandwidth.  What held the first version back at the main path's 1 KB
// face rows, and what the row-per-warp, V-byte, 4-loads-in-flight design
// does about it, is in pack.cu's note.  It stores only block bytes: the
// halo cells beside each row share its 32-byte sectors and are never
// read or rewritten.  Like the TPU kernel it takes only planes whose rows
// are disjoint (the Python wrapper refuses the others).
//
// tempi_unpack_dma replaces `unpack_dma` / `_unpack_dma_kernel` (same
// file), which copied a packed row-chunk into VMEM and issued one strided
// DMA into the destination window.  Here thread blocks stage packed
// bytes through shared memory, then scatter them into their strided
// rows.  Bound: the packed bytes read once, plus each 32-byte sector the
// block's bytes touch written back once and, where the block covers it
// only in part, first filled (chip_smoke.py, bound_sectors_ms).  It also
// takes planes that share rows (a self-overlapping type), where the TPU's
// sequential grid lets the last plane win.  Thread blocks run in no order
// here, so instead each row is written only by the last plane that covers
// it: row i of plane p is overwritten by plane p+1 exactly when
// p+1 < planes and i >= plane_rows, and such rows are skipped.  One
// launch, no races, the reference's bytes.
//
// At the main path's 8-byte rows (pack.cu's note has the shapes) the
// first version, kept as the tiled path for rows longer than 16 bytes
// (unpack_tiled_kernel), lost to PyTorch's strided copy for the reasons
// given there: one plane's rows per 16 KB tile, so at the dz = 0 edges
// one thread in 64 of a block worked and at the dy = 0 edges 16 blocks
// ran on 132 SMs; two 4-byte copies per row and one row per thread in
// flight.  The narrow path (narrow.cuh) loads a run of consecutive rows
// across planes as one contiguous packed span, in 16-byte cp.async where
// its alignment allows, waits once, and scatters each row with one V-byte
// store (V = 8 at the halo); the skip above is decided per row, since a
// tile now spans planes.  Each 8-byte store fills part of a 32-byte
// sector that the halo cells beside it share, so the card fetches and
// writes back the whole sector: 8 bytes of data cost 64 bytes of traffic,
// for this kernel and for the library's copy alike.

#include "narrow.cuh"

namespace tempi {

// The tiled path: one packed `chunk x tile_lanes` tile of one plane per block.
template <typename T>
__global__ void unpack_tiled_kernel(unsigned char* __restrict__ dst,
                                    long long dst_bstride,
                                    const unsigned char* __restrict__ packed,
                                    long long packed_bstride, long long lanes,
                                    long long rows, long long planes,
                                    long long pitch, long long base,
                                    long long plane_stride, long long plane_rows,
                                    int tile_lanes, int chunk, long long n_ltiles,
                                    long long n_rtiles) {
  __shared__ __align__(16) T tile[kTileBytes / sizeof(T)];
  T* d = reinterpret_cast<T*>(dst + blockIdx.y * dst_bstride);
  const T* pk = reinterpret_cast<const T*>(packed + blockIdx.y * packed_bstride);

  const long long t = blockIdx.x;
  const long long lt = t % n_ltiles;
  const long long rt = (t / n_ltiles) % n_rtiles;
  const long long p = t / (n_ltiles * n_rtiles);
  const long long l0 = lt * tile_lanes;
  const long long i0 = rt * chunk;
  const int tl = static_cast<int>(lanes - l0 < tile_lanes ? lanes - l0 : tile_lanes);
  const int nr = static_cast<int>(rows - i0 < chunk ? rows - i0 : chunk);
  const int n = tl * nr;
  // rows [0, live) of plane p are final; later planes overwrite the rest
  const long long live = (p + 1 < planes && plane_rows < rows) ? plane_rows : rows;
  if (i0 >= live) return;

  const T* g = pk + (p * rows + i0) * lanes + l0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int ii = k / tl;
    const int ll = k - ii * tl;
    copy_to_shared(&tile[k], g + ii * lanes + ll);
  }
  copy_wait();
  __syncthreads();

  T* w = d + base + p * plane_stride + i0 * pitch + l0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int ii = k / tl;
    const int ll = k - ii * tl;
    if (i0 + ii < live) w[ii * pitch + ll] = tile[k];
  }
}

template <typename V>
int launch_unpack_rows(void* dst, long long dst_bstride, const void* packed,
                       long long packed_bstride, int batch, int word,
                       long long lanes, long long rows, long long planes,
                       long long pitch, long long base,
                       long long plane_stride, int vec, int path,
                       cudaStream_t stream) {
  return launch_rows<V, false>(packed, packed_bstride, dst, dst_bstride, batch,
                               word, lanes, rows, planes, pitch, base,
                               plane_stride, vec, path, stream);
}

template <typename V>
int launch_unpack_dma(void* dst, long long dst_bstride, const void* packed,
                      long long packed_bstride, int batch, int word, long long lanes,
                      long long rows, long long planes, long long pitch, long long base,
                      long long plane_stride, int vec, int path, int tile_rows,
                      cudaStream_t stream) {
  if (path == kDmaNarrow)
    return launch_narrow<V, false>(packed, packed_bstride, dst, dst_bstride, batch,
                                   word, lanes, rows, planes, pitch, base,
                                   plane_stride, vec, tile_rows, stream);
  if constexpr (sizeof(V) <= 4) {
    const Tiles tiles = dma_tiles(lanes, rows, planes, sizeof(V));
    if (path != kDmaTiled || vec != word || bad_launch(batch, tiles.count) || pitch < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(static_cast<unsigned>(tiles.count), static_cast<unsigned>(batch));
    unpack_tiled_kernel<V><<<grid, kThreads, 0, stream>>>(
        static_cast<unsigned char*>(dst), dst_bstride,
        static_cast<const unsigned char*>(packed), packed_bstride, lanes, rows,
        planes, pitch, base, plane_stride, plane_stride / pitch,
        tiles.tile_lanes, tiles.chunk, tiles.n_ltiles, tiles.n_rtiles);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);  // the tiled path copies words
}

}  // namespace tempi

extern "C" int tempi_unpack_rows(void* dst, long long dst_bstride,
                                 const void* packed, long long packed_bstride,
                                 int batch, int word, long long lanes,
                                 long long rows, long long planes,
                                 long long pitch, long long base,
                                 long long plane_stride, int vec, int path,
                                 int device, void* stream) {
  TEMPI_DISPATCH_VEC(device, vec, launch_unpack_rows, dst, dst_bstride, packed,
                     packed_bstride, batch, word, lanes, rows, planes, pitch,
                     base, plane_stride, vec, path,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int tempi_unpack_dma(void* dst, long long dst_bstride,
                                const void* packed, long long packed_bstride,
                                int batch, int word, long long lanes,
                                long long rows, long long planes,
                                long long pitch, long long base,
                                long long plane_stride, int vec, int path,
                                int tile_rows, int device, void* stream) {
  TEMPI_DISPATCH_VEC(device, vec, launch_unpack_dma, dst, dst_bstride, packed,
                     packed_bstride, batch, word, lanes, rows, planes, pitch,
                     base, plane_stride, vec, path, tile_rows,
                     static_cast<cudaStream_t>(stream));
}
