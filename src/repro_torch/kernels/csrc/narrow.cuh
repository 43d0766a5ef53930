// The narrow path of the dma kernels behind tempi_pack_dma (pack.cu) and
// tempi_unpack_dma (unpack.cu), for blocks whose rows are at most
// kNarrowRowBytes long.  One template serves both: kPack gathers strided
// rows into a staged tile and stores it as one contiguous span of the
// packed buffer; !kPack loads the span and scatters it into the rows.
// See common.cuh for the addressing scheme; here every scalar is in V-byte
// vectors, V chosen on the host (repro_torch/kernels/pack.py, dma_args)
// and checked against every address by row_vectors (rows.cuh).
//
// A tile is a run of `tile_rows` consecutive rows j = p * rows + i of the
// flattened (plane, row) index, across plane boundaries; its packed side
// is vectors [j0 * nvec, (j0 + n) * nvec), one contiguous span.  Thread k
// of a block of min(kThreads, tile_rows) threads takes rows j0 + k,
// j0 + k + blockDim.x, ...: it issues one copy of V bytes per vector of
// each of them (cp.async for V >= 4) before a single wait, so every
// thread has tile_rows / blockDim.x rows in flight.  The span side moves
// S bytes at a time, S the widest that divides the packed pointer, its
// batch stride and a tile's span (the launcher picks it), and the last
// tile's ragged tail V bytes at a time.
//
// Unpack keeps "the last plane wins" per row: row i of plane p is
// skipped when p + 1 < planes and i >= plane_rows, since plane p + 1
// writes the same bytes.  No two rows that are written share a byte, so
// blocks run in any order without races.
#pragma once

#include "rows.cuh"

namespace tempi {

constexpr int kNarrowRowBytes = 16;        // longest row the narrow path takes
constexpr int kNarrowTileBytes = 32768;    // largest staged tile it launches
enum DmaPath { kDmaTiled = 0, kDmaNarrow = 1 };

extern __shared__ __align__(16) unsigned char narrow_tile[];

// Copy bytes [begin, end) of a span between global and shared memory in
// S-byte units, thread-strided; begin and end are multiples of S.
template <typename S, bool kLoad>
__device__ __forceinline__ void span_as(unsigned char* smem, unsigned char* gmem,
                                        int begin, int end) {
  S* sm = reinterpret_cast<S*>(smem);
  S* g = reinterpret_cast<S*>(gmem);
  for (int k = begin / static_cast<int>(sizeof(S)) + static_cast<int>(threadIdx.x);
       k < end / static_cast<int>(sizeof(S)); k += blockDim.x) {
    if constexpr (kLoad)
      copy_to_shared(sm + k, g + k);
    else
      g[k] = sm[k];
  }
}

// Copy a tile's span of nbytes (a multiple of sizeof(V)): the body in
// S-byte units (span_bytes = S >= sizeof(V)), the tail in V-byte units.
template <typename V, bool kLoad>
__device__ __forceinline__ void copy_span(unsigned char* smem, unsigned char* gmem,
                                          int nbytes, int span_bytes) {
  int body = 0;
  switch (span_bytes) {
    case 16: body = nbytes & ~15; span_as<uint4, kLoad>(smem, gmem, 0, body); break;
    case 8: body = nbytes & ~7; span_as<uint2, kLoad>(smem, gmem, 0, body); break;
    case 4: body = nbytes & ~3; span_as<unsigned, kLoad>(smem, gmem, 0, body); break;
    case 2: body = nbytes & ~1; span_as<unsigned short, kLoad>(smem, gmem, 0, body); break;
    default: break;
  }
  span_as<V, kLoad>(smem, gmem, body, nbytes);
}

template <typename V, typename I, bool kPack>
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const unsigned char* __restrict__ from, long long from_bstride,
              unsigned char* __restrict__ to, long long to_bstride, I nvec, I rows,
              I planes, I nrows, I pitch, I base, I plane_stride, I plane_rows,
              int tile_rows, int span_bytes) {
  V* tile = reinterpret_cast<V*>(narrow_tile);
  const int nv = static_cast<int>(nvec);
  const I j0 = static_cast<I>(blockIdx.x) * tile_rows;
  const int n = static_cast<int>(nrows - j0 < tile_rows ? nrows - j0 : tile_rows);
  const int nbytes = n * nv * static_cast<int>(sizeof(V));
  // the strided buffer and this tile's span of the packed one
  V* strided = reinterpret_cast<V*>(const_cast<unsigned char*>(kPack ? from : to) +
                                    blockIdx.y * (kPack ? from_bstride : to_bstride));
  auto* span = reinterpret_cast<unsigned char*>(
      reinterpret_cast<V*>(const_cast<unsigned char*>(kPack ? to : from) +
                           blockIdx.y * (kPack ? to_bstride : from_bstride)) +
      j0 * nvec);
  // first vector of row j0 + k, and whether a later plane overwrites it
  auto row = [&](int k, bool& shadowed) {
    const I j = j0 + k;
    const I p = j / rows;
    const I i = j - p * rows;
    shadowed = p + 1 < planes && i >= plane_rows;
    return strided + base + p * plane_stride + i * pitch;
  };
  bool shadowed;
  if constexpr (kPack) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const V* g = row(k, shadowed);
      for (int v = 0; v < nv; ++v) copy_to_shared(tile + k * nv + v, g + v);
    }
  } else {
    copy_span<V, true>(narrow_tile, span, nbytes, span_bytes);
  }
  copy_wait();
  __syncthreads();
  if constexpr (kPack) {
    copy_span<V, false>(narrow_tile, span, nbytes, span_bytes);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      V* g = row(k, shadowed);
      if (shadowed) continue;  // plane p + 1 writes these bytes
      for (int v = 0; v < nv; ++v) g[v] = tile[k * nv + v];
    }
  }
}

// The widest unit of 16, 8, 4, 2, 1 bytes that divides the packed
// pointer, its batch stride (when batch > 1) and a tile's span.
inline int span_unit(const void* packed, long long packed_bstride, int batch,
                     long long tile_bytes) {
  const auto pp = reinterpret_cast<unsigned long long>(packed);
  int s = 16;
  while (s > 1 && (pp % s || tile_bytes % s || (batch > 1 && packed_bstride % s))) s /= 2;
  return s;
}

// Launch the narrow path: `from` is read, `to` written; the strided side
// is `from` when kPack, else `to`.  Refuses (cudaErrorInvalidValue) a V
// that row_vectors refuses, rows longer than kNarrowRowBytes and a tile
// that does not fit kNarrowTileBytes.
template <typename V, bool kPack>
int launch_narrow(const void* from, long long from_bstride, void* to,
                  long long to_bstride, int batch, int word, long long lanes,
                  long long rows, long long planes, long long pitch, long long base,
                  long long plane_stride, int vec, int tile_rows, cudaStream_t stream) {
  const RowVectors v = row_vectors(from, from_bstride, to, to_bstride, batch, word,
                                   vec, lanes, pitch, base, plane_stride);
  const long long row_bytes = lanes * word;
  if (!v.ok || row_bytes > kNarrowRowBytes || pitch < 1 || tile_rows < 1 ||
      tile_rows * row_bytes > kNarrowTileBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = planes * rows;
  const long long tiles = (nrows + tile_rows - 1) / tile_rows;
  if (bad_launch(batch, tiles)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tile_bytes = tile_rows * row_bytes;
  const int span = kPack ? span_unit(to, to_bstride, batch, tile_bytes)
                         : span_unit(from, from_bstride, batch, tile_bytes);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  const unsigned threads = static_cast<unsigned>(tile_rows < kThreads ? tile_rows : kThreads);
  const size_t smem = static_cast<size_t>((tile_bytes + 15) / 16 * 16);
  const auto* f = static_cast<const unsigned char*>(from);
  auto* t = static_cast<unsigned char*>(to);
  const long long plane_rows = plane_stride / pitch;
  if (fits_int(nrows * v.nvec, v.nvec, rows, planes, v.pitch, v.base, v.plane_stride)) {
    narrow_kernel<V, int, kPack><<<grid, threads, smem, stream>>>(
        f, from_bstride, t, to_bstride, static_cast<int>(v.nvec), static_cast<int>(rows),
        static_cast<int>(planes), static_cast<int>(nrows), static_cast<int>(v.pitch),
        static_cast<int>(v.base), static_cast<int>(v.plane_stride),
        static_cast<int>(plane_rows), tile_rows, span);
  } else {
    narrow_kernel<V, long long, kPack><<<grid, threads, smem, stream>>>(
        f, from_bstride, t, to_bstride, v.nvec, rows, planes, nrows, v.pitch, v.base,
        v.plane_stride, plane_rows, tile_rows, span);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tempi
