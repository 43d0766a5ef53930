// Weighted box-neighbourhood stencil update for Hopper (sm_90a), loaded
// with ctypes from repro_torch/kernels/ops.py (stencil_window_update, and
// stencil_window_pair for two updates in one pass).
//
//   out[i] = (1 - w) * u[i] + (w / N) * sum over the N offsets d of u[i + d]
//
// over a window (origin + shape) of the last three dimensions of every
// buffer of a batch (the local mesh's ranks), the offsets being the
// (2rz+1) x (2ry+1) x (2rx+1) box minus its centre.
//
// It replaces no Pallas kernel: the reference computes this stencil in
// jnp (src/repro/halo/stencil.py), and the port's plain torch version
// zero-fills an accumulator and makes one strided add per offset, so every
// byte of the state went through device memory some 40 times an
// application (161 ms at 8 x 512^3 against a 2.59 ms bound).  This kernel
// reads each input cell from device memory once and writes each output
// once.
//
// Exactness fixes the arithmetic.  The sum starts from 0 and adds the
// offsets in itertools.product order with round-to-nearest adds, and the
// result is fl(fl(acc * (w/N)) + fl(u * (1 - w))), the two scalars
// rounded to the element type on the host exactly as the plain version
// rounds them.  Nothing may be contracted into an FMA (the _rn intrinsics
// are never contracted), so every window of every caller yields the same
// bits for a cell as the plain version: the overlapped iteration's chain,
// slabs and rims splice into the plain result.
//
// What bounds it on this card, and what the design does about each:
//   1. Device-memory bytes: each cell of the still-valid block read once,
//      each computed cell written once, at 3.35 TB/s (2.59 ms an
//      application at 8 x 512^3; a plain 8.8 GB copy takes 2.88 ms on the
//      card).  A block of the fast path owns whole rows of the window (up
//      to 1,024 float32 columns) for a few rows of one buffer and marches
//      along one slice of z, so it reads and writes nearly contiguous
//      spans of each plane.  (The first design, tiles of 16 x 64 cells
//      whose 256-byte row pieces came from many blocks at once, took 6.35
//      ms; without its loads, still 4.5.)  Planes are staged into a
//      ring in shared memory by cp.async, 16 bytes a thread where the
//      input's rows fall on the output's 16-byte phase (the whole state
//      and the stencil's scratch do), three planes ahead of the one
//      computed; rows above and below a tile are shared with its
//      neighbours through L2; the z slices give the grid about 8 blocks
//      per resident slot.
//   2. Instructions.  The fixed order rules out reusing partial sums
//      between outputs, so a cell costs 26 adds, two multiplies and an
//      add (about 1 ms of issue for the card at 8 x 514^3).  The rest is
//      kept small: each thread computes two runs of 16 bytes along x and
//      gives every output its own accumulator, so a staged plane is read
//      from shared memory once per thread, one row at a time (a vector
//      and two rim cells a run, 6 values serving 4 outputs), and added to
//      the 2rz + 1 outputs that read it; staging offsets and store masks
//      are worked out once per thread, and stores are 16 bytes.  Under 80
//      registers, two blocks of 384 threads fit an SM.  Other radii, and
//      windows too narrow to stage that way, take a runtime-radii kernel
//      (tiles of 16 x 64 cells, every value read from the ring).
//
// With a copied rim the destination is the window grown by the radii,
// and its outer layer gets the input's cells unchanged: the stencil's
// scratch chain (halo/stencil.py, stencil_cycle) then writes an
// application and the rim left by the one before it in one pass.
//
// The fused pair (tempi_stencil_pair, pair_kernel) computes two
// consecutive radius-(1, 1, 1) applications in one pass, for the last
// two applications of an odd chain: it reads the scratch's block once
// and writes the state's, and the first application's values never go
// through device memory.  The window W it reads and writes is the first
// application's window grown by one: its outer layer is the input
// copied unchanged (as with a copied rim), the next layer the first
// application, the rest the second.  The chain then ends in the state
// with no splice copy, and passes over the state drop from four to two
// at s = 3.  The arithmetic is the fast path's, so the pair gives the
// bits of its two launches.  What bounds it, and what the design does:
//   1. Registers.  Every output keeps an accumulator for each of the
//      three planes it is fed by, and the pair has two applications in
//      flight, so a thread computes one run of G cells in each (24
//      accumulators); the first design, whole rows and two runs a stage,
//      spilled at any block size and ran 11.5-18 ms at 8 x 516^3.  A
//      block of at most 384 threads (80 registers, two blocks an SM) owns
//      a tile of runs by rows; thread t computes the same run in both
//      stages, the second where it is inside the tile.  The first
//      application is recomputed on a ring of one run and one row around
//      each tile (22 x 14 runs at 8 x 516^3: 25% more of it).
//   2. Device-memory bytes: W read once and written once (2.62 ms at
//      8 x 516^3 float32 by the data sheet; a windowed copy of the same
//      bytes takes 3.8 ms on the card, a windowed fill 2.6).  Input
//      planes are staged by 16-byte cp.async into a ring of four, two in
//      flight; the first application's plane goes into a ring of three in
//      shared memory, where the second reads it a step later, so the two
//      stages share no plane within a step and one barrier a step keeps
//      them apart.  Rows of a 518-float pitch (2,072 bytes) start at two
//      16-byte phases in turn, so each staged row is placed at its own
//      phase and each run starts at its row's phase: every global load
//      and store is 16 bytes, whatever the pitch, except the head and
//      tail of a row; stores are streamed (evict first).  Runs of
//      neighbouring rows are then 0 or 2 cells apart: a run and its side
//      cells are one vector and two cells, or two vectors, and a block
//      orders its rows even ones first so that a warp's rows share a phase
//      and take one branch.  (The vector path wants every row start of
//      both buffers on one 8-byte phase of a float, or 16-byte of a
//      double, and planes on 16 bytes; anything else takes single cells,
//      same arithmetic.)
//   3. Instructions: twice the fast path's adds, a quarter more for the
//      recomputed ring.  On the card the pair takes about 7 ms at
//      8 x 516^3, against 13 for the two launches and the splice copy it
//      replaces; neither the bytes nor the adds alone account for it.

#include <cuda_runtime.h>

namespace tempi {
namespace stencil {

constexpr int kRowThreads = 16;  // runtime-radii path: threads across a tile row, a group each
constexpr int kTileRows = 16;    // runtime-radii path: output rows of a full tile
constexpr int kMaxSharedBytes = 232448;  // dynamic shared memory a block may ask for
constexpr int kFastThreads = 384;        // fast path: threads of a block at most
constexpr int kFastRowThreads = 128;     // fast path: threads across a tile row at most
constexpr int kFastStages = 5;           // fast path: staged planes of the ring
constexpr int kFastItems = 4;            // fast path: groups a thread stages of a plane at most
constexpr int kFastSharedBytes = 110 * 1024;  // fast path: the ring at most (2 blocks an SM)
constexpr int kFastWaves = 8;            // fast path: blocks per resident slot the z slices aim for

template <typename T>
struct Lane;

template <>
struct Lane<float> {
  using V = float4;
  static constexpr int n = 4;
  __device__ static __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static __forceinline__ void store(float* dst, const float (&r)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
  }
  // a store that is not read again soon: evict first
  __device__ static __forceinline__ void stream(float* dst, const float (&r)[4]) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(r[0], r[1], r[2], r[3]));
  }
};

template <>
struct Lane<double> {
  using V = double2;
  static constexpr int n = 2;
  __device__ static __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static __forceinline__ void store(double* dst, const double (&r)[2]) {
    *reinterpret_cast<double2*>(dst) = make_double2(r[0], r[1]);
  }
  __device__ static __forceinline__ void stream(double* dst, const double (&r)[2]) {
    __stcs(reinterpret_cast<double2*>(dst), make_double2(r[0], r[1]));
  }
};

// One launch.  Pointers are at the window's first cell of buffer 0;
// strides are in elements (x is 1).  Window column x lies in 16-byte
// group (x + phase) / G; group k starts at column k * G - phase.
template <typename T>
struct Args {
  const T* in;
  T* out;
  long long in_b, in_z, in_y;
  long long out_b, out_z, out_y;
  int nz, ny, nx;
  int rz, ry, rx;
  int phase;
  int vec_in;       // the input's groups are 16-byte aligned: 16-byte copies
  int vec_out;      // the output's groups are 16-byte aligned: 16-byte stores
  int tiles_x;      // tiles across a row
  int tiles_y;      // tiles down a plane (fast path)
  int tile_rows;    // output rows a tile
  int row_threads;  // threads across a tile row (fast path)
  int zchunk;       // window planes a block marches (fast path)
  int halo_groups;  // groups staged beside a tile on each side, ceil(rx / G)
  int rim;          // 1: the window's outer layer, radii deep, is copied from the input
                    // (the input read is then the window itself), 0: all computed
  T scale;          // w / N
  T keep;           // 1 - w
};

// Window coordinates of the input cells a launch reads along one
// dimension of extent n and radius r: [-r, n + r), or the window itself
// when its rim is copied; and whether a cell is on that copied rim.
__device__ __forceinline__ int read_lo(int r, int rim) { return rim ? 0 : -r; }
__device__ __forceinline__ int read_hi(int n, int r, int rim) { return rim ? n : n + r; }
__device__ __forceinline__ bool on_rim(int i, int n, int r, int rim) {
  return rim && (i < r || i >= n - r);
}

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <typename T>
__device__ __forceinline__ void copy_one(T* smem, const T* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(static_cast<int>(sizeof(T)))
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage input plane z (window coordinates, -rz <= z < nz + rz) of a tile
// into `buf`: rows y0 - ry .. y0 + tile_rows + ry, groups g0 - hx ..
// g0 + kRowThreads + hx, each row `groups * G` elements.  Only cells the
// update may read (window + radius) are copied; the rest stay unset and
// feed only outputs that are never stored.
template <typename T>
__device__ __forceinline__ void stage_plane(T* buf, const Args<T>& p, const T* in, int z,
                                            int y0, int g0, int rows, int groups) {
  constexpr int G = Lane<T>::n;
  if (z < read_lo(p.rz, p.rim) || z >= read_hi(p.nz, p.rz, p.rim)) return;
  const T* plane = in + static_cast<long long>(z) * p.in_z;
  const int count = rows * groups;
  const int x_lo = read_lo(p.rx, p.rim), x_hi = read_hi(p.nx, p.rx, p.rim);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / groups;
    const int j = i - r * groups;
    const int y = y0 - p.ry + r;
    if (y < read_lo(p.ry, p.rim) || y >= read_hi(p.ny, p.ry, p.rim)) continue;
    const int x0 = (g0 - p.halo_groups + j) * G - p.phase;
    T* dst = buf + i * G;
    const T* row = plane + static_cast<long long>(y) * p.in_y;
    if (p.vec_in && x0 >= x_lo && x0 + G <= x_hi) {
      copy16(dst, row + x0);
    } else {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const int x = x0 + e;
        if (x >= x_lo && x < x_hi) copy_one(dst + e, row + x);
      }
    }
  }
}

// Store a thread's G results at window columns x0 .. x0 + G of one row.
template <typename T>
__device__ __forceinline__ void store_run(T* row, int x0, const T (&res)[Lane<T>::n],
                                          const Args<T>& p) {
  constexpr int G = Lane<T>::n;
  if (p.vec_out && x0 >= 0 && x0 + G <= p.nx) {
    Lane<T>::store(row + x0, res);
  } else {
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int x = x0 + e;
      if (x >= 0 && x < p.nx) row[x] = res[e];
    }
  }
}

// The fast path, radii known at compile time.  A tile spans whole rows
// of the window (up to 2 x kFastRowThreads groups) for p.tile_rows rows,
// so a block reads and writes nearly contiguous spans of each plane, and
// its z range is one slice of p.zchunk planes.  Thread (row, gx) computes two
// runs of G cells, groups gx and gx + row_threads of its row.  The ring
// keeps the RZ planes behind the one consumed (the centres of the outputs
// it finishes) and stages kFastStages - RZ - 1 ahead.  Each output keeps
// its own accumulator: staged plane q adds its (2RY+1) x (2RX+1) terms to
// the 2RZ+1 outputs that read it, in (dy, dx) order, and the planes reach
// an output in z order, so every sum is taken in itertools.product
// order.  A plane is read from shared memory once per thread, one row at
// a time.
template <typename T, int RZ, int RY, int RX>
__global__ void __launch_bounds__(kFastThreads, 2) fixed_kernel(const Args<T> p) {
  using L = Lane<T>;
  using V = typename L::V;
  constexpr int G = L::n;
  constexpr int HX = (RX + G - 1) / G;
  constexpr int PZ = 2 * RZ + 1;  // outputs a plane feeds
  constexpr int PX = G + 2 * RX;  // columns of a run and its rim
  constexpr int WHOLE = 1 << G;   // mask of a group copied or stored as one vector
  constexpr int AHEAD = kFastStages - RZ - 1;  // planes staged ahead of the one consumed
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int txt = p.row_threads;
  const int groups = 2 * txt + 2 * HX;
  const int rows = p.tile_rows + 2 * RY;
  const int plane = rows * groups * G;
  const int threads = txt * p.tile_rows;

  int t = blockIdx.x;
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  const int z0 = t / p.tiles_y * p.zchunk;
  const int steps = min(p.nz - z0, p.zchunk) + 2 * RZ;  // staged plane q is window plane z0 - RZ + q
  const int y0 = ty * p.tile_rows;
  const int g0 = tx * 2 * txt;
  const int row = threadIdx.x / txt;
  const int gx = threadIdx.x - row * txt;

  // staging: group i = threadIdx.x + k * threads of the tile's staged
  // rows, `off` elements from the tile's first staged cell, cells by mask
  const T* tile = p.in + static_cast<long long>(blockIdx.y) * p.in_b +
                  static_cast<long long>(z0 - RZ) * p.in_z +
                  static_cast<long long>(y0 - RY) * p.in_y + (g0 - HX) * G - p.phase;
  int off[kFastItems], mask[kFastItems];
#pragma unroll
  for (int k = 0; k < kFastItems; ++k) {
    const int i = threadIdx.x + k * threads;
    const int r = i / groups, j = i - r * groups;
    const int xs = (g0 - HX + j) * G - p.phase;
    const int ys = y0 - RY + r;
    off[k] = r * static_cast<int>(p.in_y) + j * G;
    mask[k] = 0;
    if (i < rows * groups && ys >= read_lo(RY, p.rim) && ys < read_hi(p.ny, RY, p.rim)) {
      if (p.vec_in && xs >= read_lo(RX, p.rim) && xs + G <= read_hi(p.nx, RX, p.rim)) {
        mask[k] = WHOLE;
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e)
          if (xs + e >= read_lo(RX, p.rim) && xs + e < read_hi(p.nx, RX, p.rim))
            mask[k] |= 1 << e;
      }
    }
  }
  auto stage = [&](int q) {
    const int z = z0 - RZ + q;
    if (z < read_lo(RZ, p.rim) || z >= read_hi(p.nz, RZ, p.rim)) return;
    const T* src = tile + static_cast<long long>(q) * p.in_z;
    T* dst = ring + (q % kFastStages) * plane + threadIdx.x * G;
#pragma unroll
    for (int k = 0; k < kFastItems; ++k) {
      if (mask[k] == WHOLE) {
        copy16(dst + k * threads * G, src + off[k]);
      } else if (mask[k]) {
#pragma unroll
        for (int e = 0; e < G; ++e)
          if (mask[k] >> e & 1) copy_one(dst + k * threads * G + e, src + off[k] + e);
      }
    }
  };

  // storing: runs h = 0, 1 of window row y0 + row, columns x[h] .. x[h] + G
  const int y = y0 + row;
  T* const dst = p.out + static_cast<long long>(blockIdx.y) * p.out_b +
                 static_cast<long long>(z0) * p.out_z + static_cast<long long>(y) * p.out_y +
                 (g0 + gx) * G - p.phase;
  const bool yrim = on_rim(y, p.ny, RY, p.rim);
  int smask[2], rmask[2];  // cells stored; cells on the copied rim
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = (g0 + gx + h * txt) * G - p.phase;
    rmask[h] = 0;
#pragma unroll
    for (int e = 0; e < G; ++e)
      if (yrim || on_rim(x + e, p.nx, RX, p.rim)) rmask[h] |= 1 << e;
    smask[h] = 0;
    if (y < p.ny) {
      if (p.vec_out && x >= 0 && x + G <= p.nx) {
        smask[h] = WHOLE;
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e)
          if (x + e >= 0 && x + e < p.nx) smask[h] |= 1 << e;
      }
    }
  }

  for (int q = 0; q < AHEAD; ++q) {
    if (q < steps) stage(q);
    commit();
  }
  // acc[a]: the output of window plane z0 + q - j, a = (q - j) mod PZ
  T acc[PZ][2 * G];
  for (int base = 0; base < steps; base += PZ) {
#pragma unroll
    for (int k = 0; k < PZ; ++k) {
      const int q = base + k;
      if (q < steps) {
        wait_pending<AHEAD - 1>();
        __syncthreads();
        if (q + AHEAD < steps) stage(q + AHEAD);
        commit();
        const T* s = ring + (q % kFastStages) * plane + row * groups * G + (HX + gx) * G;
#pragma unroll
        for (int dy = 0; dy <= 2 * RY; ++dy) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const T* r = s + dy * groups * G + h * txt * G;
            T w[PX];
            const V c = *reinterpret_cast<const V*>(r);
            const T* lanes = reinterpret_cast<const T*>(&c);
#pragma unroll
            for (int e = 0; e < G; ++e) w[RX + e] = lanes[e];
#pragma unroll
            for (int e = 1; e <= RX; ++e) {
              w[RX - e] = r[-e];
              w[RX + G - 1 + e] = r[G - 1 + e];
            }
#pragma unroll
            for (int e = 0; e < G; ++e) {
              const int o = h * G + e;
#pragma unroll
              for (int j = 0; j < PZ; ++j) {  // dz = j - RZ for the output z0 + q - j
                T& a = acc[(k - j + PZ) % PZ][o];
#pragma unroll
                for (int dx = 0; dx <= 2 * RX; ++dx) {
                  if (j == 0 && dy == 0 && dx == 0)
                    a = L::add(T(0), w[e]);
                  else if (j != RZ || dy != RY || dx != RX)
                    a = L::add(a, w[e + dx]);
                }
              }
            }
          }
        }
        if (q >= 2 * RZ) {  // window plane z0 + q - 2RZ has all its terms
          const int a = (k + 1) % PZ;
          const bool zrim = on_rim(z0 + q - 2 * RZ, p.nz, RZ, p.rim);
          const T* centre = ring + ((q - RZ) % kFastStages) * plane +
                            (row + RY) * groups * G + (HX + gx) * G;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!smask[h]) continue;
            const V c = *reinterpret_cast<const V*>(centre + h * txt * G);
            const T* u = reinterpret_cast<const T*>(&c);
            T res[G];
#pragma unroll
            for (int e = 0; e < G; ++e)
              res[e] = zrim || (rmask[h] >> e & 1)
                           ? u[e]
                           : L::add(L::mul(acc[a][h * G + e], p.scale), L::mul(u[e], p.keep));
            T* o = dst + h * txt * G + static_cast<long long>(q - 2 * RZ) * p.out_z;
            if (smask[h] == WHOLE) {
              L::store(o, res);
            } else {
#pragma unroll
              for (int e = 0; e < G; ++e)
                if (smask[h] >> e & 1) o[e] = res[e];
            }
          }
        }
      }
    }
  }
}

// Any radii, known at run time: a ring of 2rz + 2 staged planes in
// dynamic shared memory, one plane staged ahead; every value is read from
// the ring.  A tile has p.tile_rows rows (the host shrinks it until the
// ring fits).
template <typename T>
__global__ void __launch_bounds__(kRowThreads * kTileRows) any_kernel(const Args<T> p) {
  using L = Lane<T>;
  constexpr int G = L::n;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int groups = kRowThreads + 2 * p.halo_groups;
  const int rows = p.tile_rows + 2 * p.ry;
  const int plane = rows * groups * G;
  const int stages = 2 * p.rz + 2;

  const int ty = blockIdx.x / p.tiles_x;
  const int y0 = ty * p.tile_rows;
  const int g0 = (blockIdx.x - ty * p.tiles_x) * kRowThreads;
  const T* in = p.in + static_cast<long long>(blockIdx.y) * p.in_b;
  T* out = p.out + static_cast<long long>(blockIdx.y) * p.out_b;
  const int row = threadIdx.x / kRowThreads;
  const int gx = threadIdx.x - row * kRowThreads;
  const int y = y0 + row;
  const int x0 = (g0 + gx) * G - p.phase;
  const bool stores = y < p.ny && x0 + G > 0 && x0 < p.nx;
  const int planes = p.nz + 2 * p.rz;

  for (int q = 0; q <= 2 * p.rz; ++q) {
    stage_plane(ring + q * plane, p, in, q - p.rz, y0, g0, rows, groups);
    commit();
  }
  const int col = (p.halo_groups + gx) * G - p.rx;  // ring column of x0 - rx
  for (int z = 0; z < p.nz; ++z) {  // output plane z reads staged planes z .. z + 2rz
    __syncthreads();
    const int next = z + 2 * p.rz + 1;
    if (next < planes)
      stage_plane(ring + (next % stages) * plane, p, in, next - p.rz, y0, g0, rows, groups);
    commit();
    wait_pending<1>();
    __syncthreads();
    if (!stores) continue;
    const bool rim = on_rim(y, p.ny, p.ry, p.rim) || on_rim(z, p.nz, p.rz, p.rim);
    T res[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      T acc = T(0);
      for (int dz = 0; dz <= 2 * p.rz; ++dz) {
        const T* s = ring + ((z + dz) % stages) * plane + row * groups * G + col + e;
        for (int dy = 0; dy <= 2 * p.ry; ++dy)
          for (int dx = 0; dx <= 2 * p.rx; ++dx)
            if (dz != p.rz || dy != p.ry || dx != p.rx)
              acc = L::add(acc, s[dy * groups * G + dx]);
      }
      const T c = ring[((z + p.rz) % stages) * plane + (row + p.ry) * groups * G + col + p.rx + e];
      res[e] = rim || on_rim(x0 + e, p.nx, p.rx, p.rim)
                   ? c
                   : L::add(L::mul(acc, p.scale), L::mul(c, p.keep));
    }
    store_run(out + static_cast<long long>(z) * p.out_z + static_cast<long long>(y) * p.out_y,
              x0, res, p);
  }
}

inline bool rows_aligned(long long b, long long z, long long y, int batch, long long es) {
  return (batch == 1 || (b * es) % 16 == 0) && (z * es) % 16 == 0 && (y * es) % 16 == 0;
}

// fast_launch's answer for a window whose shape the fast path does not take
constexpr int kNoFit = -1;
// launch's answer when the runtime-radii kernel ran without a launch error
constexpr int kRanRuntime = -2;

// Shape and launch the fast path for radii (1, 1, 1).  Returns the CUDA
// error of the launch (cudaSuccess when it ran), or kNoFit if the window
// does not fit it (too narrow to stage in kFastItems groups a thread,
// offsets past 32 bits, or a grid past 2^31 blocks), and the
// runtime-radii kernel takes it.
template <typename T>
int fast_launch(Args<T>& p, long long groups, int batch, int device, cudaStream_t stream) {
  const long long tiles_x = (groups + 2 * kFastRowThreads - 1) / (2 * kFastRowThreads);
  const int txt = static_cast<int>((groups + 2 * tiles_x - 1) / (2 * tiles_x));
  int rows = kFastThreads / txt < p.ny ? kFastThreads / txt : p.ny;
  auto ring = [&](int r) { return kFastStages * (r + 2LL) * (2LL * txt + 2) * 16; };
  while (rows > 1 && ring(rows) > kFastSharedBytes) --rows;
  if (rows < 1 || ring(rows) > kFastSharedBytes ||
      (rows + 2LL) * (2LL * txt + 2) > static_cast<long long>(kFastItems) * txt * rows ||
      (rows + 2LL) * p.in_y >= (1LL << 31))
    return kNoFit;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // slice z so that the grid has about kFastWaves blocks for each of the
  // card's resident slots (2 blocks an SM), a slice no thinner than 8
  const long long tiles_y = (p.ny + rows - 1) / rows;
  const long long flat = tiles_x * tiles_y * batch;
  long long chunks = (2LL * kFastWaves * sms + flat - 1) / flat;
  const long long thinnest = p.nz / 8 > 1 ? p.nz / 8 : 1;
  chunks = chunks < thinnest ? chunks : thinnest;
  const int zchunk = static_cast<int>((p.nz + chunks - 1) / chunks);
  const long long blocks = tiles_x * tiles_y * ((p.nz + zchunk - 1) / zchunk);
  const int bytes = static_cast<int>(ring(rows));
  if (blocks > 0x7fffffffLL) return kNoFit;
  err = cudaFuncSetAttribute(fixed_kernel<T, 1, 1, 1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.tiles_x = static_cast<int>(tiles_x);
  p.tiles_y = static_cast<int>(tiles_y);
  p.row_threads = txt;
  p.tile_rows = rows;
  p.zchunk = zchunk;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  fixed_kernel<T, 1, 1, 1><<<grid, txt * rows, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* in, long long in_b, long long in_z, long long in_y, void* out,
           long long out_b, long long out_z, long long out_y, int batch, int nz, int ny,
           int nx, int rz, int ry, int rx, int rim, double scale, double keep, int device,
           cudaStream_t stream) {
  constexpr int G = Lane<T>::n;
  constexpr long long es = sizeof(T);
  const long long ia = reinterpret_cast<long long>(in), oa = reinterpret_cast<long long>(out);
  if (batch < 1 || batch > 65535 || nz < 1 || ny < 1 || nx < 1 || rz < 0 || ry < 0 ||
      rx < 0 || (rim && (nz <= 2 * rz || ny <= 2 * ry || nx <= 2 * rx)) || ia % es || oa % es)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> p;
  p.in = static_cast<const T*>(in);
  p.out = static_cast<T*>(out);
  p.in_b = in_b, p.in_z = in_z, p.in_y = in_y;
  p.out_b = out_b, p.out_z = out_z, p.out_y = out_y;
  p.nz = nz, p.ny = ny, p.nx = nx;
  p.rz = rz, p.ry = ry, p.rx = rx;
  p.rim = rim != 0;
  const bool in_ok = rows_aligned(in_b, in_z, in_y, batch, es);
  const bool out_ok = rows_aligned(out_b, out_z, out_y, batch, es);
  const int in_phase = static_cast<int>((ia % 16) / es), out_phase = static_cast<int>((oa % 16) / es);
  p.phase = out_ok ? out_phase : (in_ok ? in_phase : 0);
  p.vec_out = out_ok;
  p.vec_in = in_ok && in_phase == p.phase;
  const long long groups = (nx + p.phase + G - 1) / G;
  p.tiles_x = static_cast<int>((groups + kRowThreads - 1) / kRowThreads);
  p.halo_groups = (rx + G - 1) / G;
  p.scale = static_cast<T>(scale);
  p.keep = static_cast<T>(keep);

  if (rz == 1 && ry == 1 && rx == 1) {
    const int err = fast_launch(p, groups, batch, device, stream);
    if (err != kNoFit) return err;
  }
  long long bytes = 0;
  for (p.tile_rows = kTileRows; p.tile_rows >= 1; p.tile_rows /= 2) {
    bytes = (2LL * rz + 2) * (p.tile_rows + 2LL * ry) * (kRowThreads + 2LL * p.halo_groups) * 16;
    if (bytes <= kMaxSharedBytes) break;
  }
  if (p.tile_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      static_cast<long long>(p.tiles_x) * ((ny + p.tile_rows - 1) / p.tile_rows);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(any_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  any_kernel<T><<<grid, kRowThreads * p.tile_rows, static_cast<size_t>(bytes), stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? static_cast<int>(err) : kRanRuntime;
}

// ---------------------------------------------------------------------------
// the fused pair
// ---------------------------------------------------------------------------

constexpr int kPairThreads = 384;  // threads of a block at most
constexpr int kPairBlocks = 2;     // blocks an SM holds
constexpr int kPairStages = 4;     // staged input planes: the two in use and two in flight
constexpr int kPairSharedBytes = 224 * 1024 / kPairBlocks;  // the two rings at most
constexpr int kPairWaves = 8;      // blocks per resident slot the z slices aim for

// One launch of the pair.  Pointers are at W's first cell of buffer 0,
// strides in elements.  On the vector path row y of every plane starts
// at 16-byte phase (phase + y * step) mod G, in elements; run j of row y
// is its cells j * G - phase(y) .. + G.
template <typename T>
struct PairArgs {
  const T* in;
  T* out;
  long long in_b, in_z, in_y;
  long long out_b, out_z, out_y;
  int nz, ny, nx;           // W
  int in_phase, in_step;    // the input's row phases (vector path)
  int out_phase, out_step;  // the output's
  int runs;                 // runs a row
  int tile_runs;            // output runs of a tile
  int tile_rows;            // output rows of a tile
  int tiles_x, tiles_y;     // tiles across and down a plane
  int zchunk;               // planes a block marches
  T scale1, keep1;          // the first application's w / N and 1 - w
  T scale2, keep2;          // the second's
};

// a compile-time int, to hand a lambda a constant
template <int N>
struct Int {
  static constexpr int value = N;
};

// w[i] = row[s + i] for i < G + 2: a run's G cells (from s + 1) and one
// cell on each side.  On the vector path s + 1 is on a vector (one vector
// and two cells), or (floats) two cells into one (two vectors); a warp
// holds rows of one phase (pair_kernel's row order), so the branch is the
// warp's.
template <typename T, bool VEC>
__device__ __forceinline__ void read_run(const T* row, int s, T (&w)[Lane<T>::n + 2]) {
  using V = typename Lane<T>::V;
  constexpr int G = Lane<T>::n;
  if constexpr (VEC && G == 4) {
    if ((s & 3) == 3) {
      const float4 c = *reinterpret_cast<const float4*>(row + s + 1);
      w[0] = row[s], w[1] = c.x, w[2] = c.y, w[3] = c.z, w[4] = c.w, w[5] = row[s + 5];
    } else {
      const float4 a = *reinterpret_cast<const float4*>(row + s - 1);
      const float4 b = *reinterpret_cast<const float4*>(row + s + 3);
      w[0] = a.y, w[1] = a.z, w[2] = a.w, w[3] = b.x, w[4] = b.y, w[5] = b.z;
    }
    return;
  }
  if constexpr (VEC && G == 2) {  // s + 1 is on a vector
    const V c = *reinterpret_cast<const V*>(row + s + 1);
    w[0] = row[s], w[1] = c.x, w[2] = c.y, w[3] = row[s + 3];
    return;
  }
#pragma unroll
  for (int i = 0; i < G + 2; ++i) w[i] = row[s + i];
}

// G cells from row[s]: on the vector path s is on a vector, or (floats)
// two cells into one.
template <typename T, bool VEC>
__device__ __forceinline__ void read_cells(const T* row, int s, T (&u)[Lane<T>::n]) {
  using V = typename Lane<T>::V;
  constexpr int G = Lane<T>::n;
  if constexpr (VEC && G == 4) {
    if ((s & 3) == 0) {
      const float4 c = *reinterpret_cast<const float4*>(row + s);
      u[0] = c.x, u[1] = c.y, u[2] = c.z, u[3] = c.w;
    } else {
      const float2 a = *reinterpret_cast<const float2*>(row + s);
      const float2 b = *reinterpret_cast<const float2*>(row + s + 2);
      u[0] = a.x, u[1] = a.y, u[2] = b.x, u[3] = b.y;
    }
    return;
  }
  if constexpr (VEC && G == 2) {
    const V c = *reinterpret_cast<const V*>(row + s);
    u[0] = c.x, u[1] = c.y;
    return;
  }
#pragma unroll
  for (int e = 0; e < G; ++e) u[e] = row[s + e];
}

// Add one staged row (w: a run and its two side cells, row dy of the
// three an output reads) to the accumulators of the three planes it
// feeds: acc[(k - j) mod 3] is the output that takes it at dz = j - 1.
// Every output takes its terms in itertools.product order: planes come
// in z order, rows in y order, cells in x order; the centre is skipped.
template <typename T>
__device__ __forceinline__ void feed(T (&acc)[3][Lane<T>::n], int k, int dy,
                                     const T (&w)[Lane<T>::n + 2]) {
  using L = Lane<T>;
  constexpr int G = L::n;
#pragma unroll
  for (int e = 0; e < G; ++e) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T& a = acc[(k - j + 3) % 3][e];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (j == 0 && dy == 0 && dx == 0)
          a = L::add(T(0), w[e]);
        else if (j != 1 || dy != 1 || dx != 1)
          a = L::add(a, w[e + dx]);
      }
    }
  }
}

// The pair.  Staged input plane q is W's plane z0 - 2 + q, the middle
// ring's plane u (the first application) W's plane z0 - 1 + u, the
// second application's plane o W's plane z0 + o.  A tile: output runs
// j0 .. j0 + tile_runs of rows y0 .. y0 + tile_rows; the first
// application's runs and rows one more on each side, the input's groups
// and rows two more.  Thread t computes run j0 - 1 + t % (tile_runs + 2)
// of row y0 - 1 + t / (tile_runs + 2) in both stages, the second where
// that cell is in the tile.  In both rings a row's cell x sits at x +
// phase(row) + G - (j0 - 1) * G, so run j0 - 1 + m starts at (m + 1) * G.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kPairThreads, kPairBlocks) pair_kernel(const PairArgs<T> p) {
  using L = Lane<T>;
  constexpr int G = L::n;
  constexpr int AHEAD = kPairStages - 2;
  constexpr int WHOLE = (1 << G) - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = p.tile_runs + 4;  // groups of a staged row, and of a row of the middle ring
  const int W = groups * G;
  const int rows_in = p.tile_rows + 4, rows_mid = p.tile_rows + 2;
  const int plane_in = rows_in * W, plane_mid = rows_mid * W;
  T* const ring_in = reinterpret_cast<T*>(smem);
  T* const ring_mid = ring_in + kPairStages * plane_in;

  int b = blockIdx.x;
  const int tx = b % p.tiles_x;
  b /= p.tiles_x;
  const int ty = b % p.tiles_y;
  const int z0 = b / p.tiles_y * p.zchunk;
  const int j0 = tx * p.tile_runs, y0 = ty * p.tile_rows;
  const int staged = min(p.nz - z0, p.zchunk) + 4;  // input planes of the block
  const T* const in = p.in + static_cast<long long>(blockIdx.y) * p.in_b;
  T* const out = p.out + static_cast<long long>(blockIdx.y) * p.out_b;
  auto in_ph = [&](int y) { return VEC ? (p.in_phase + y * p.in_step) & (G - 1) : 0; };
  auto out_ph = [&](int y) { return VEC ? (p.out_phase + y * p.out_step) & (G - 1) : 0; };

  // staging: thread (row r0, group g) of the first rows_step * groups
  // threads copies group g of rows r0, r0 + rows_step, ...; staged group
  // g covers cells (j0 - 2 + g) * G - phase(row) .. + G
  const int rows_step = blockDim.x / groups;
  const int g = threadIdx.x % groups, r0 = threadIdx.x / groups;
  auto stage = [&](int q) {
    const int z = z0 - 2 + q;
    if (z < 0 || z >= p.nz || r0 >= rows_step) return;
    const T* plane = in + static_cast<long long>(z) * p.in_z;
    T* const ring = ring_in + (q % kPairStages) * plane_in + g * G;
    for (int r = r0; r < rows_in; r += rows_step) {
      const int y = y0 - 2 + r;
      if (y < 0 || y >= p.ny) continue;
      const int x = (j0 - 2 + g) * G - in_ph(y);
      const T* src = plane + static_cast<long long>(y) * p.in_y + x;
      T* dst = ring + r * W;
      if (VEC && x >= 0 && x + G <= p.nx) {
        copy16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e)
          if (x + e >= 0 && x + e < p.nx) copy_one(dst + e, src + e);
      }
    }
  };

  // this thread's run: row y of W, its first cell x; at = where it
  // starts in a row of either ring; flags: the cells copied unchanged
  // into the middle ring (bits 0..), the thread has a run (bit 7), the
  // cells that keep the first application (bits 8..), the cells stored
  // (bits 16..; bit 16 + G: not as one vector)
  // rows in the order 0, 2, 4, ..., 1, 3, ...: a warp's rows share a
  // phase where rows alternate, so its reads take one branch
  const int slot = threadIdx.x / (p.tile_runs + 2), mj = threadIdx.x % (p.tile_runs + 2);
  const int mr = slot < (rows_mid + 1) / 2 ? 2 * slot : 2 * (slot - (rows_mid + 1) / 2) + 1;
  const int y = y0 - 1 + mr;
  const int x = (j0 - 1 + mj) * G - out_ph(y);
  const int at = mr * W + (mj + 1) * G;
  // read_run's start in the input row above (the row below: two rows
  // on, same phase) and in the row itself; in the middle ring's row above
  const int in_side = at - 1 + in_ph(y - 1) - out_ph(y);
  const int in_mid = at + W - 1 + in_ph(y) - out_ph(y);
  const int mid_side = at - W - 1 + out_ph(y - 1) - out_ph(y);
  unsigned flags = 0;
  {
    if (mr < rows_mid) flags |= 1u << 7;
    unsigned store = 0;
    const bool out_cell = mr >= 1 && mr <= p.tile_rows && mj >= 1 && mj <= p.tile_runs &&
                          y < p.ny;
#pragma unroll
    for (int e = 0; e < G; ++e) {
      if (y == 0 || y == p.ny - 1 || x + e == 0 || x + e == p.nx - 1) flags |= 1u << e;
      if (y <= 1 || y >= p.ny - 2 || x + e <= 1 || x + e >= p.nx - 2) flags |= 1u << (8 + e);
      if (out_cell && x + e >= 0 && x + e < p.nx) store |= 1u << e;
    }
    if (store == WHOLE && !VEC) store |= 1u << G;
    flags |= store << 16;
  }
  T* const dst_row = out + static_cast<long long>(y) * p.out_y + x;

  for (int q = 0; q < AHEAD; ++q) {
    if (q < staged) stage(q);
    commit();
  }
  T acc1[3][G], acc2[3][G];
  // Step q: input plane q feeds the first application, which completes its
  // plane q - 2 into the middle ring; the middle ring's plane q - 3,
  // written a step before, feeds the second, which completes its plane
  // q - 5.  So the two stages share no plane within a step and one
  // barrier a step keeps them apart.  q = base + k with k known at compile
  // time, so that every accumulator and ring index is: plane q feeds
  // acc1[(k - j) mod 3], the middle plane q - 3 acc2[(k - j) mod 3].
  auto step = [&](auto kc, int q) {
    constexpr int k = decltype(kc)::value;
    if (q >= staged + 1) return;
    wait_pending<AHEAD - 1>();
    __syncthreads();
    if (q + AHEAD < staged) stage(q + AHEAD);
    commit();
    if (q < staged && (flags >> 7 & 1)) {
      // stage 1: input plane q feeds the first application's planes q, q - 1, q - 2
      const T* const plane = ring_in + (q % kPairStages) * plane_in;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        T w[G + 2];
        read_run<T, VEC>(plane, dy == 1 ? in_mid : in_side + dy * W, w);
        feed<T>(acc1, k, dy, w);
      }
      if (q >= 2) {  // its plane q - 2 (W's plane z0 + q - 3) is complete
        const int z = z0 + q - 3;
        const bool zcopy = z == 0 || z == p.nz - 1;
        const T* const centre = ring_in + ((q - 1) % kPairStages) * plane_in;
        T u[G], res[G];
        read_cells<T, VEC>(centre, in_mid + 1, u);
#pragma unroll
        for (int e = 0; e < G; ++e)
          res[e] = zcopy || (flags >> e & 1)
                       ? u[e]
                       : L::add(L::mul(acc1[(k + 1) % 3][e], p.scale1), L::mul(u[e], p.keep1));
        L::store(ring_mid + ((k + 1) % 3) * plane_mid + at, res);
      }
    }
    const unsigned store = flags >> 16;
    if (q < 3 || !store) return;
    // stage 2: the middle plane q - 3 feeds the second application's planes q - 3, q - 4,
    // q - 5
    const T* const mid = ring_mid + k * plane_mid;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      T w[G + 2];
      read_run<T, VEC>(mid, dy == 1 ? at - 1 : mid_side + dy * W, w);
      feed<T>(acc2, k, dy, w);
    }
    if (q < 5) return;
    // its plane q - 5 (W's plane z0 + q - 5) is complete; the centre is the middle plane
    // q - 4
    const int z = z0 + q - 5;
    const bool zkeep = z <= 1 || z >= p.nz - 2;
    T u[G], res[G];
    read_cells<T, VEC>(ring_mid + ((k + 2) % 3) * plane_mid, at, u);
#pragma unroll
    for (int e = 0; e < G; ++e)
      res[e] = zkeep || (flags >> (8 + e) & 1)
                   ? u[e]
                   : L::add(L::mul(acc2[(k + 1) % 3][e], p.scale2), L::mul(u[e], p.keep2));
    T* o = dst_row + static_cast<long long>(z) * p.out_z;
    if (store == WHOLE) {
      L::stream(o, res);
    } else {
#pragma unroll
      for (int e = 0; e < G; ++e)
        if (store >> e & 1) o[e] = res[e];
    }
  };
  for (int base = 0; base <= staged; base += 3) {
    step(Int<0>{}, base);
    step(Int<1>{}, base + 1);
    step(Int<2>{}, base + 2);
  }
}

template <typename T>
int pair_launch(const void* in, long long in_b, long long in_z, long long in_y, void* out,
                long long out_b, long long out_z, long long out_y, int batch, int nz, int ny,
                int nx, double scale1, double keep1, double scale2, double keep2, int device,
                cudaStream_t stream) {
  constexpr int G = Lane<T>::n;
  constexpr long long es = sizeof(T);
  const long long ia = reinterpret_cast<long long>(in), oa = reinterpret_cast<long long>(out);
  if (batch < 1 || batch > 65535 || nz < 5 || ny < 5 || nx < 5 || ia % es || oa % es)
    return static_cast<int>(cudaErrorInvalidValue);
  PairArgs<T> p;
  p.in = static_cast<const T*>(in);
  p.out = static_cast<T*>(out);
  p.in_b = in_b, p.in_z = in_z, p.in_y = in_y;
  p.out_b = out_b, p.out_z = out_z, p.out_y = out_y;
  p.nz = nz, p.ny = ny, p.nx = nx;
  // the vector path: planes (and buffers) on 16 bytes, every row start
  // of both on one phase modulo two elements
  auto planes16 = [&](long long b, long long z) {
    return (batch == 1 || (b * es) % 16 == 0) && (z * es) % 16 == 0;
  };
  const bool vec = planes16(in_b, in_z) && planes16(out_b, out_z) && in_y % 2 == 0 &&
                   out_y % 2 == 0 && ia % (2 * es) == oa % (2 * es);
  p.in_phase = static_cast<int>(ia % 16 / es);
  p.out_phase = static_cast<int>(oa % 16 / es);
  p.in_step = static_cast<int>((in_y % G + G) % G);
  p.out_step = static_cast<int>((out_y % G + G) % G);
  p.runs = (nx + 2 * G - 2) / G;
  p.scale1 = static_cast<T>(scale1), p.keep1 = static_cast<T>(keep1);
  p.scale2 = static_cast<T>(scale2), p.keep2 = static_cast<T>(keep2);
  // the tile: for each split of a row into tiles, the most rows whose
  // runs (with the recomputed ring) fit kPairThreads and whose two rings
  // fit the shared memory; of those, the one with the fewest first-
  // application runs a plane
  auto bytes = [&](long long runs, long long rows) {
    return (kPairStages * (rows + 4) + 3 * (rows + 2)) * (runs + 4) * G * es;
  };
  long long best = -1;
  for (int tiles_x = 1; tiles_x <= p.runs; ++tiles_x) {
    const int runs = (p.runs + tiles_x - 1) / tiles_x;
    if (runs + 4 > kPairThreads) continue;
    int rows = kPairThreads / (runs + 2) - 2;
    rows = rows < ny ? rows : ny;
    while (rows >= 1 && bytes(runs, rows) > kPairSharedBytes) --rows;
    if (rows < 1) continue;
    const long long cost = 1LL * tiles_x * ((ny + rows - 1) / rows) * (rows + 2) * (runs + 2);
    if (best < 0 || cost < best) {
      best = cost;
      p.tile_runs = runs, p.tile_rows = rows;
      p.tiles_x = (p.runs + runs - 1) / runs;
    }
  }
  if (best < 0) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_y = (ny + p.tile_rows - 1) / p.tile_rows;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long flat = 1LL * p.tiles_x * p.tiles_y * batch;
  long long chunks = (1LL * kPairBlocks * kPairWaves * sms + flat - 1) / flat;
  const long long thinnest = nz / 8 > 1 ? nz / 8 : 1;
  chunks = chunks < thinnest ? chunks : thinnest;
  p.zchunk = static_cast<int>((nz + chunks - 1) / chunks);
  const long long blocks = 1LL * p.tiles_x * p.tiles_y * ((nz + p.zchunk - 1) / p.zchunk);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((p.tile_rows + 2) * (p.tile_runs + 2) + 31) / 32 * 32;
  const int shared = static_cast<int>(bytes(p.tile_runs, p.tile_rows));
  auto kernel = vec ? pair_kernel<T, true> : pair_kernel<T, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  kernel<<<grid, threads, shared, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stencil
}  // namespace tempi

// Two radius-(1, 1, 1) updates in one pass (the fused pair): `in` and
// `out` point at the first cell of W, the window the first update reads
// (its own window grown by one), strides in elements.  W is written into
// `out`: its outer layer copied from `in`, the next layer the first
// update (`scale1`, `keep1`), the rest the second (`scale2`, `keep2`)
// computed from the first.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int tempi_stencil_pair(const void* in, long long in_b, long long in_z, long long in_y,
                                  void* out, long long out_b, long long out_z, long long out_y,
                                  int batch, int nz, int ny, int nx, int elem, double scale1,
                                  double keep1, double scale2, double keep2, int device,
                                  void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 4:
      return tempi::stencil::pair_launch<float>(in, in_b, in_z, in_y, out, out_b, out_z, out_y,
                                                batch, nz, ny, nx, scale1, keep1, scale2, keep2,
                                                device, s);
    case 8:
      return tempi::stencil::pair_launch<double>(in, in_b, in_z, in_y, out, out_b, out_z, out_y,
                                                 batch, nz, ny, nx, scale1, keep1, scale2, keep2,
                                                 device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One stencil update of a window on the stream: `in` and `out` point at
// the window's first cell of buffer 0, strides in elements, `elem` the
// element size (4: float32, 8: float64), `scale` = w / N and `keep` =
// 1 - w already rounded to the element type.  With `rim` the window's
// outer layer, radii deep, is copied from `in` unchanged and only the
// cells inside it are computed.  Returns the launch's cudaGetLastError()
// (cudaSuccess: the fast path ran), -2 when the runtime-radii kernel ran
// without error, or cudaErrorInvalidValue for what it does not take.
extern "C" int tempi_stencil_update(const void* in, long long in_b, long long in_z,
                                    long long in_y, void* out, long long out_b,
                                    long long out_z, long long out_y, int batch, int nz,
                                    int ny, int nx, int rz, int ry, int rx, int rim,
                                    int elem, double scale, double keep, int device,
                                    void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 4:
      return tempi::stencil::launch<float>(in, in_b, in_z, in_y, out, out_b, out_z, out_y,
                                           batch, nz, ny, nx, rz, ry, rx, rim, scale, keep, device, s);
    case 8:
      return tempi::stencil::launch<double>(in, in_b, in_z, in_y, out, out_b, out_z, out_y,
                                            batch, nz, ny, nx, rz, ry, rx, rim, scale, keep, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
