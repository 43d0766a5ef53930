// The row kernels behind tempi_pack_rows (pack.cu) and tempi_unpack_rows
// (unpack.cu).  One template serves both: kPack copies strided block rows
// into the packed buffer, !kPack copies them back.  See common.cuh for the
// addressing scheme; here every scalar is in V-byte vectors.
//
// The host picks V and the path (repro_torch/kernels/pack.py,
// vector_bytes and row_path), and the launcher refuses a V that does not
// divide both pointers, both batch strides (when batch > 1), every row's
// byte start and the row length.  So a row is a whole number of aligned
// vectors: no peeled head or tail, no byte outside the block is read or
// written.
//
//   kRowsWarp  one chunk of up to kWarp * kUnroll vectors of one row per
//              warp.  The warp finds the row's two offsets once (two
//              divisions per chunk, none per vector), then each thread
//              issues kUnroll independent loads before its stores.  A
//              1 KB row at V = 8 is one chunk: 32 bytes in flight per
//              thread, 1 KB per warp.
//   kRowsFlat  rows shorter than a warp's vectors (halo corners): one
//              thread per vector over the flattened (row, vector) index,
//              so a warp covers several rows.
//
// Loads go through the read-only path (__ldg, ld.global.nc): neither
// kernel writes what it reads.  Thread blocks take the batch of buffers
// on gridDim.y.  Index arithmetic is 32-bit where fits_int holds, 64-bit
// otherwise.
#pragma once

#include "common.cuh"

namespace tempi {

constexpr int kWarp = 32;
constexpr int kUnroll = 4;
constexpr int kChunkVectors = kWarp * kUnroll;
enum RowPath { kRowsFlat = 0, kRowsWarp = 1 };

// The block's scalars in V-byte vectors; ok is false when V does not
// divide a pointer, a batch stride, a row start or the row length.
struct RowVectors {
  bool ok;
  long long nvec, pitch, base, plane_stride;
};

inline RowVectors row_vectors(const void* a, long long a_bstride, const void* b,
                              long long b_bstride, int batch, int word,
                              int vec, long long lanes, long long pitch,
                              long long base, long long plane_stride) {
  RowVectors v{false, 0, 0, 0, 0};
  const long long w = word, V = vec;
  const auto pa = reinterpret_cast<unsigned long long>(a);
  const auto pb = reinterpret_cast<unsigned long long>(b);
  if (vec < 1 || vec > 16 || (vec & (vec - 1)) != 0 || pa % V || pb % V ||
      (lanes * w) % V || (pitch * w) % V || (base * w) % V ||
      (plane_stride * w) % V)
    return v;
  if (batch > 1 && (a_bstride % V || b_bstride % V)) return v;
  v.ok = true;
  v.nvec = lanes * w / V;
  v.pitch = pitch * w / V;
  v.base = base * w / V;
  v.plane_stride = plane_stride * w / V;
  return v;
}

// kRowsWarp: item = (row j, chunk c) of the flattened (plane, row) index.
template <typename V, typename I, bool kPack>
__global__ void __launch_bounds__(kThreads)
rows_warp_kernel(const unsigned char* __restrict__ from, long long from_bstride,
                 unsigned char* __restrict__ to, long long to_bstride, I nvec,
                 I rows, I items, I nchunks, I pitch, I base, I plane_stride) {
  const V* in = reinterpret_cast<const V*>(from + blockIdx.y * from_bstride);
  V* out = reinterpret_cast<V*>(to + blockIdx.y * to_bstride);
  const I lane = static_cast<I>(threadIdx.x % kWarp);
  const I warps = static_cast<I>(blockDim.x / kWarp);
  const I step = static_cast<I>(gridDim.x) * warps;
  for (I item = static_cast<I>(blockIdx.x) * warps + static_cast<I>(threadIdx.x / kWarp);
       item < items; item += step) {
    const I j = item / nchunks;
    const I c = item - j * nchunks;
    const I p = j / rows;
    const I i = j - p * rows;
    const I strided = base + p * plane_stride + i * pitch;
    const I packed = j * nvec;
    const V* src = in + (kPack ? strided : packed);
    V* dst = out + (kPack ? packed : strided);
    const I v0 = c * kChunkVectors + lane;
    V r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (v0 + k * kWarp < nvec) r[k] = __ldg(src + v0 + k * kWarp);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (v0 + k * kWarp < nvec) dst[v0 + k * kWarp] = r[k];
  }
}

// kRowsFlat: one thread per vector t of the packed buffer.
template <typename V, typename I, bool kPack>
__global__ void __launch_bounds__(kThreads)
rows_flat_kernel(const unsigned char* __restrict__ from, long long from_bstride,
                 unsigned char* __restrict__ to, long long to_bstride, I nvec,
                 I rows, I total, I pitch, I base, I plane_stride) {
  const V* in = reinterpret_cast<const V*>(from + blockIdx.y * from_bstride);
  V* out = reinterpret_cast<V*>(to + blockIdx.y * to_bstride);
  const I step = static_cast<I>(gridDim.x) * static_cast<I>(blockDim.x);
  for (I t = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) +
             static_cast<I>(threadIdx.x);
       t < total; t += step) {
    const I j = t / nvec;
    const I v = t - j * nvec;
    const I p = j / rows;
    const I i = j - p * rows;
    const I s = base + p * plane_stride + i * pitch + v;
    if (kPack)
      out[t] = __ldg(in + s);
    else
      out[s] = __ldg(in + t);
  }
}

template <typename V, typename I, bool kPack>
void launch_rows_as(const unsigned char* from, long long from_bstride,
                    unsigned char* to, long long to_bstride, dim3 grid,
                    int path, long long nvec, long long rows, long long units,
                    long long nchunks, const RowVectors& v,
                    cudaStream_t stream) {
  if (path == kRowsWarp) {
    rows_warp_kernel<V, I, kPack><<<grid, kThreads, 0, stream>>>(
        from, from_bstride, to, to_bstride, static_cast<I>(nvec),
        static_cast<I>(rows), static_cast<I>(units), static_cast<I>(nchunks),
        static_cast<I>(v.pitch), static_cast<I>(v.base),
        static_cast<I>(v.plane_stride));
  } else {
    rows_flat_kernel<V, I, kPack><<<grid, kThreads, 0, stream>>>(
        from, from_bstride, to, to_bstride, static_cast<I>(nvec),
        static_cast<I>(rows), static_cast<I>(units), static_cast<I>(v.pitch),
        static_cast<I>(v.base), static_cast<I>(v.plane_stride));
  }
}

// Launch one row kernel: `from` is read, `to` written; the strided side
// is `from` when kPack, else `to`.
template <typename V, bool kPack>
int launch_rows(const void* from, long long from_bstride, void* to,
                long long to_bstride, int batch, int word, long long lanes,
                long long rows, long long planes, long long pitch,
                long long base, long long plane_stride, int vec, int path,
                cudaStream_t stream) {
  const RowVectors v = row_vectors(from, from_bstride, to, to_bstride, batch,
                                   word, vec, lanes, pitch, base, plane_stride);
  if (!v.ok || (path != kRowsWarp && path != kRowsFlat))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = planes * rows * v.nvec;
  const long long nchunks = (v.nvec + kChunkVectors - 1) / kChunkVectors;
  // work units: (row, chunk) items for a warp each, or single vectors
  const long long units = path == kRowsWarp ? planes * rows * nchunks : total;
  long long blocks;
  if (path == kRowsWarp) {
    const long long per_block = kThreads / kWarp;
    blocks = (units + per_block - 1) / per_block;
    if (blocks > kMaxGridX) blocks = kMaxGridX;
  } else {
    blocks = simt_blocks(total);
  }
  if (bad_launch(batch, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  const auto* f = static_cast<const unsigned char*>(from);
  auto* t = static_cast<unsigned char*>(to);
  if (fits_int(total, v.nvec, rows, planes, v.pitch, v.base, v.plane_stride)) {
    launch_rows_as<V, int, kPack>(f, from_bstride, t, to_bstride, grid, path,
                                  v.nvec, rows, units, nchunks, v, stream);
  } else {
    launch_rows_as<V, long long, kPack>(f, from_bstride, t, to_bstride, grid,
                                        path, v.nvec, rows, units, nchunks, v,
                                        stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tempi

// Select the tensors' device, then call fn<V> for the vector width of the
// row kernels (uint2 and uint4 are CUDA's 8- and 16-byte vector types).
#define TEMPI_DISPATCH_VEC(device, vec, fn, ...)                            \
  if (cudaSetDevice(device) != cudaSuccess)                                 \
    return static_cast<int>(cudaGetLastError());                            \
  switch (vec) {                                                            \
    case 1: return tempi::fn<unsigned char>(__VA_ARGS__);                   \
    case 2: return tempi::fn<unsigned short>(__VA_ARGS__);                  \
    case 4: return tempi::fn<unsigned int>(__VA_ARGS__);                    \
    case 8: return tempi::fn<uint2>(__VA_ARGS__);                           \
    case 16: return tempi::fn<uint4>(__VA_ARGS__);                          \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
