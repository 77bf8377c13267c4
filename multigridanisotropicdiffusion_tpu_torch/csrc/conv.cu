// Gaussian smoothing and Gaussian-derivative passes of the VED pipeline: the
// 1-D correlation along z (B6), the fused y-then-x correlation (B7), and the
// single-axis correlations along y and x (B10).
//
// Replace the Pallas kernels `_conv_z_kernel` (built by `_build_conv_z`),
// `_conv_yx_kernel` (`_build_conv_yx`), `_conv_y_kernel` (`_build_conv_y`)
// and `_conv_x_kernel` (`_build_conv_x`) in
// multigridanisotropicdiffusion_tpu/ops/pallas_conv.py.  The TPU kernels
// phrase the y and x passes as banded matrix products on the MXU, pad z to
// whole tiles and take only x % 128 == 0, y % 8 == 0 shapes; these kernels
// sum the taps directly and take any shape.
//
//   conv_z:   out[k,j,i] = sum_t w[t] u[z(k,t), j, i]
//             z(k,t) = k + t (valid mode: the input carries r-plane halos)
//                    = clamp(k + t - r, 0, Z - 1) (edge replication)
//   conv_yx:  mid[k,j,i] = sum_t wy[t] u[k, clamp(j + t - ry), i]   (not rounded)
//             out[k,j,i] = sum_t wx[t] mid[k, j, clamp(i + t - rx)]
//   conv_y:   out[k,j,i] = sum_t wy[t] u[k, clamp(j + t - ry), i]   (rounded)
//   conv_x:   out[k,j,i] = sum_t wx[t] u[k, j, clamp(i + t - rx)]   (rounded)
//
// Taps run in ascending t and zero taps are skipped (the z-slab pipeline pads
// short kernels with zeros), as in ops/hessian.py's `_conv_axis`; the sums
// are in the compute type (float for bf16 storage) and round once at the
// store.  conv_y and conv_x are the single-axis passes of the
// gaussian_derivative Hessian, which rounds to the storage type after every
// pass, so they cannot be served by conv_yx (which rounds only after x).
// Each product and sum rounds on its own (no fused multiply-add), as
// in the plain versions, so the smoothed fields agree bit for bit: the
// vesselness select downstream compares responses of different scales, and
// a last-bit difference at a near-tie would pick another scale's Hessian.
// At most 129 taps (kernel_radius caps r at 64); the host passes them in a
// buffer that the launch copies into the kernel's parameters (conv_z and the
// single-axis tile kernel stage them in shared memory).
//
// Bound on the card: device-memory bandwidth for conv_z, conv_y and conv_x;
// for conv_yx at large radii also instruction issue, since every tap is a
// separately rounded multiply and add.  At 512^3 f32 with sigma = 2 (r = 8),
// conv_z reads 530 planes and writes 514 (1.10 GB, 0.33 ms at 3.35 TB/s);
// conv_yx reads and writes 514 planes (1.08 GB, 0.32 ms) and issues
// 2 (2r + 1) float instructions per output and pass (68 at r = 8, ~0.31 ms
// at the card's float rate); conv_y and conv_x each read and write 512
// planes (1.07 GB, 0.32 ms).
//
// conv_z runs one thread per 8 consecutive z outputs of one (y, x) column,
// threads along x so every plane load is one coalesced row; the 8 outputs
// slide over (nt + 7) input planes held one at a time in a register, so each
// input plane is read about (nt + 7) / 8 times instead of nt times (the
// re-reads hit L2).
//
// conv_yx: one block of 288 threads owns a tile of 32 rows x 128 columns on
// kYXPlanes consecutive z planes.  The y pass runs down the columns (halo
// columns included): a thread owns a run of 16 consecutive rows of one
// column and slides over the 16 + 2 ry input rows read straight from global
// memory (lanes along x, coalesced; no clamping on tiles away from the y
// borders), each value multiplied into every output of the run it reaches,
// so one load serves up to 2 ry + 1 taps; the sums go unrounded into a
// shared (32 x (128 + 2 rx)) intermediate.  The x pass has one lane per row
// (a row stride that is odd, so no bank conflicts) and 16 consecutive
// outputs per thread, on 8 warps, sliding over the shared row the same way;
// its results go to a shared output tile, written and read as 16-byte
// vectors, that the block stores as 16-byte rows with streaming stores.  For the main path's radii
// (2, 4, 5, 8, the same on y and x, no zero tap) the radius is compiled in,
// so both windows unroll fully and each weight is an operand from the
// kernel's parameters; any other taps (up to r = 64, zero-padded, or
// different radii) take the generic form, which loops over the host's
// ascending list of the non-zero taps.
//
// conv_y and conv_x are one tile kernel with a compile-time choice of axis:
// one block per (z, y-tile, x-tile) loads the input tile with its halos
// along the convolved axis, clamped (clamping is the edge replication),
// into shared memory, and the 32 x 8 threads walk the tile in rows, lanes
// along x (coalesced loads, conflict-free shared memory).  Tiles (32 x 64
// outputs) shrink until they fit the 227 KB of shared memory a block may
// use.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 129;
constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kZB = 8;  // conv_z outputs per thread along z
constexpr size_t kMaxSmem = 232448;

template <typename A>
struct Taps {
  A w[kMaxTaps];
};

template <typename A>
Taps<A> taps_from_host(const void* host, int64_t n) {
  Taps<A> t{};
  std::memcpy(t.w, host, static_cast<size_t>(n) * sizeof(A));
  return t;
}

__device__ __forceinline__ int64_t clamp_index(int64_t v, int64_t n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
    conv_z_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t zi,
                  int64_t ny, int64_t nx, int64_t zo,
                  Taps<typename mad::Compute<T>::type> taps, int nt, int valid) {
  using A = typename mad::Compute<T>::type;
  __shared__ A w[kMaxTaps];
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int t = tid; t < nt; t += kBX * kBY) w[t] = taps.w[t];
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBY + threadIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * kZB;
  if (i >= nx || j >= ny) return;
  const int64_t plane = ny * nx;
  const T* col = in + j * nx + i;
  const int r = (nt - 1) / 2;
  // outputs k0 .. k0 + kZB - 1 slide over the input planes: window position
  // p feeds tap t = p - o of output k0 + o, so each output still sums its
  // taps in ascending order
  A acc[kZB];
#pragma unroll
  for (int o = 0; o < kZB; ++o) acc[o] = 0;
  for (int p = 0; p < nt + kZB - 1; ++p) {
    const int64_t z = valid ? k0 + p : clamp_index(k0 + p - r, zi);
    if (z >= zi) break;  // only outputs past zo would read it
    const A v = mad::load(col + z * plane);
#pragma unroll
    for (int o = 0; o < kZB; ++o) {
      const int t = p - o;
      if (t < 0 || t >= nt) continue;
      const A wt = w[t];
      if (wt != A(0)) acc[o] = mad::add_rn(acc[o], mad::mul_rn(wt, v));
    }
  }
#pragma unroll
  for (int o = 0; o < kZB; ++o) {
    if (k0 + o < zo) mad::store(out + (k0 + o) * plane + j * nx + i, acc[o]);
  }
}

// Axes of the single-axis tile kernel.
constexpr int kPassY = 1;
constexpr int kPassX = 2;

// The tile kernel of conv_y (kPassY) and conv_x (kPassX).  The axis the
// kernel does not convolve comes with one tap (radius 0), so its tile
// carries no halo along that axis; its taps are never read.
template <typename T, int kPass>
__global__ void __launch_bounds__(kBX * kBY)
    conv_tile_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t ny,
                     int64_t nx, Taps<typename mad::Compute<T>::type> taps_y,
                     int nty, Taps<typename mad::Compute<T>::type> taps_x,
                     int ntx, int tile_y, int tile_x) {
  using A = typename mad::Compute<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* wy = reinterpret_cast<A*>(smem_raw);
  A* wx = wy + nty;
  const int ry = (nty - 1) / 2;
  const int rx = (ntx - 1) / 2;
  const int width = tile_x + 2 * rx;
  const int height = tile_y + 2 * ry;
  A* tile = wx + ntx;  // height x width input tile

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  for (int t = tid; t < nty; t += kBX * kBY) wy[t] = taps_y.w[t];
  for (int t = tid; t < ntx; t += kBX * kBY) wx[t] = taps_x.w[t];

  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * tile_y;
  const int64_t x0 = static_cast<int64_t>(blockIdx.x) * tile_x;
  const int64_t k = blockIdx.z;
  const T* src = in + k * ny * nx;
  for (int row = ty; row < height; row += kBY) {
    const T* line = src + clamp_index(y0 - ry + row, ny) * nx;
    for (int c = tx; c < width; c += kBX) {
      tile[row * width + c] = mad::load(line + clamp_index(x0 - rx + c, nx));
    }
  }
  __syncthreads();

  T* dst = out + k * ny * nx;
  if constexpr (kPass == kPassY) {
    for (int row = ty; row < tile_y; row += kBY) {
      for (int c = tx; c < width; c += kBX) {
        A acc = 0;
        for (int t = 0; t < nty; ++t) {
          const A wt = wy[t];
          if (wt != A(0)) {
            acc = mad::add_rn(acc, mad::mul_rn(wt, tile[(row + t) * width + c]));
          }
        }
        if (y0 + row < ny && x0 + c < nx) {
          mad::store(dst + (y0 + row) * nx + x0 + c, acc);
        }
      }
    }
  } else {
    for (int row = ty; row < tile_y && y0 + row < ny; row += kBY) {
      for (int c = tx; c < tile_x && x0 + c < nx; c += kBX) {
        A acc = 0;
        for (int t = 0; t < ntx; ++t) {
          const A wt = wx[t];
          if (wt != A(0)) {
            acc = mad::add_rn(acc, mad::mul_rn(wt, tile[row * width + c + t]));
          }
        }
        mad::store(dst + (y0 + row) * nx + x0 + c, acc);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// conv_yx
// ---------------------------------------------------------------------------

constexpr int kTY = 32;        // tile rows: one x-pass lane each
constexpr int kTX = 128;       // tile columns
constexpr int kRunY = 16;      // y outputs per thread in the y pass
constexpr int kRunX = 16;      // x outputs per thread in the x pass
constexpr int kXWarps = kTX / kRunX;  // x-pass warps, one run each
// One more warp than the x pass needs: at r = 8 the y pass has exactly
// 2 (kTX + 16) = 288 runs, so it takes one round.
constexpr int kYXThreads = 32 * (kXWarps + 1);
constexpr int kYXPlanes = 4;   // z planes per block
constexpr int kOutStride = kTX + 4;  // 16-byte rows, odd in 16-byte units

// The taps of one axis: dense (t = 0 .. 2r) for a compiled radius, else the
// non-zero taps in ascending order, each with its offset t - r.
template <typename A>
struct TapList {
  A w[kMaxTaps];
  short off[kMaxTaps];
  int n;
  int r;
};

template <typename A>
__device__ __forceinline__ void tap(A& acc, bool first, A w, A v) {
  const A prod = mad::mul_rn(w, v);
  acc = first ? prod : mad::add_rn(acc, prod);
}

// 16 bytes of compute-type values, from registers to shared memory.
__device__ __forceinline__ void put16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// 16 bytes of storage type T from compute-type values in shared memory,
// each rounded once; a streaming store, so the output does not push the
// inputs' halo rows out of L2.
template <typename T>
__device__ __forceinline__ void store16(T* p, const typename mad::Compute<T>::type* v) {
  if constexpr (sizeof(T) == 2) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[2 * q]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[2 * q + 1])))
              << 16);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  } else {
    static_assert(sizeof(T) == sizeof(*v), "no rounding: T is its compute type");
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(v));
  }
}

// kR > 0: both axes have the dense taps of radius kR; kR == 0: the generic
// form over the tap lists.
template <typename T, int kR>
__global__ void __launch_bounds__(kYXThreads)
    conv_yx_kernel(const T* __restrict__ in, T* __restrict__ out, int nz,
                   int ny, int nx, TapList<typename mad::Compute<T>::type> ty,
                   TapList<typename mad::Compute<T>::type> tx, int mid_stride,
                   int vec) {
  using A = typename mad::Compute<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* otile = reinterpret_cast<A*>(smem_raw);  // kTY x kOutStride
  A* mid = otile + kTY * kOutStride;            // kTY x mid_stride
  const int rx = kR > 0 ? kR : tx.r;
  const int ncols = kTX + 2 * rx;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int y0 = blockIdx.y * kTY;
  const int x0 = blockIdx.x * kTX;
  const int64_t plane_size = static_cast<int64_t>(ny) * nx;
  const int z1 = min(static_cast<int>(blockIdx.z) * kYXPlanes + kYXPlanes, nz);
  // the tile's input rows all lie inside the plane: no clamping along y
  const bool interior = kR > 0 && y0 - kR >= 0 && y0 + kTY + kR <= ny;

  for (int z = blockIdx.z * kYXPlanes; z < z1; ++z) {
    const T* src = in + z * plane_size;
    // y pass: a run of kRunY rows of one column per task
    for (int task = tid; task < ncols * (kTY / kRunY); task += kYXThreads) {
      const int col = task % ncols;
      const int row0 = task / ncols * kRunY;
      const T* column = src + min(max(x0 - rx + col, 0), nx - 1);
      const int yb = y0 + row0;
      A acc[kRunY];
      if constexpr (kR > 0) {
        const T* row = column + static_cast<int64_t>(yb - kR) * nx;
#pragma unroll
        for (int p = 0; p < kRunY + 2 * kR; ++p) {
          A v;
          if (interior) {
            v = mad::load(row);
            row += nx;
          } else {
            const int y = min(max(yb + p - kR, 0), ny - 1);
            v = mad::load(column + static_cast<int64_t>(y) * nx);
          }
#pragma unroll
          for (int o = 0; o < kRunY; ++o) {
            const int t = p - o;
            if (t >= 0 && t <= 2 * kR) tap(acc[o], t == 0, ty.w[t], v);
          }
        }
      } else {
        for (int k = 0; k < ty.n; ++k) {
          const int d = ty.off[k];
          const A w = ty.w[k];
#pragma unroll
          for (int o = 0; o < kRunY; ++o) {
            const int y = min(max(yb + o + d, 0), ny - 1);
            tap(acc[o], k == 0, w, mad::load(column + static_cast<int64_t>(y) * nx));
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kRunY; ++o) mid[(row0 + o) * mid_stride + col] = acc[o];
    }
    __syncthreads();

    // x pass: lane = row, kRunX consecutive outputs per thread
    if (warp < kXWarps) {
      const int xs = warp * kRunX;
      const A* m = mid + lane * mid_stride + xs;  // mid column xs + t feeds tap t
      A acc[kRunX];
      if constexpr (kR > 0) {
#pragma unroll
        for (int p = 0; p < kRunX + 2 * kR; ++p) {
          const A v = m[p];
#pragma unroll
          for (int o = 0; o < kRunX; ++o) {
            const int t = p - o;
            if (t >= 0 && t <= 2 * kR) tap(acc[o], t == 0, tx.w[t], v);
          }
        }
      } else {
        for (int k = 0; k < tx.n; ++k) {
          const int d = tx.off[k] + rx;
          const A w = tx.w[k];
#pragma unroll
          for (int o = 0; o < kRunX; ++o) tap(acc[o], k == 0, w, m[o + d]);
        }
      }
      A* orow = otile + lane * kOutStride + xs;
#pragma unroll
      for (int o = 0; o < kRunX; o += 16 / sizeof(A)) put16(orow + o, acc + o);
    }
    __syncthreads();

    // store the tile, 16 bytes of storage per thread where the row allows
    T* dst = out + z * plane_size;
    constexpr int V = 16 / sizeof(T);
    for (int idx = tid * V; idx < kTY * kTX; idx += kYXThreads * V) {
      const int row = idx / kTX;
      const int c = idx % kTX;
      const int y = y0 + row;
      const int x = x0 + c;
      if (y >= ny) continue;
      const A* o = otile + row * kOutStride + c;
      T* d = dst + static_cast<int64_t>(y) * nx + x;
      if (vec && x + V <= nx) {
        store16<T>(d, o);
      } else {
        for (int q = 0; q < V && x + q < nx; ++q) mad::store(d + q, o[q]);
      }
    }
  }
}

template <typename T>
int launch_conv_z(const void* in, void* out, int64_t zi, int64_t ny,
                  int64_t nx, int64_t zo, const void* taps, int64_t nt,
                  int valid, void* stream) {
  using A = typename mad::Compute<T>::type;
  if (nt < 1 || nt > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY),
                  mad::blocks_for(zo, kZB));
  conv_z_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), zi, ny, nx, zo,
      taps_from_host<A>(taps, nt), static_cast<int>(nt), valid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kPass>
int launch_conv_tile(const void* in, void* out, int64_t nz, int64_t ny,
                     int64_t nx, const void* taps_y, int64_t nty,
                     const void* taps_x, int64_t ntx, void* stream) {
  using A = typename mad::Compute<T>::type;
  if (nty < 1 || nty > kMaxTaps || ntx < 1 || ntx > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ry = static_cast<int>(nty - 1) / 2;
  const int rx = static_cast<int>(ntx - 1) / 2;
  int tile_y = 32;
  int tile_x = 64;
  auto smem = [&]() {
    const size_t width = tile_x + 2 * rx;
    return (nty + ntx + (tile_y + 2 * ry) * width) * sizeof(A);
  };
  while (smem() > kMaxSmem) {
    if (tile_y > 1) {
      tile_y /= 2;
    } else {
      tile_x /= 2;
    }
  }
  const size_t bytes = smem();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_tile_kernel<T, kPass>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(mad::blocks_for(nx, tile_x), mad::blocks_for(ny, tile_y),
                  static_cast<unsigned>(nz));
  conv_tile_kernel<T, kPass><<<grid, dim3(kBX, kBY), bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), ny, nx,
      taps_from_host<A>(taps_y, nty), static_cast<int>(nty),
      taps_from_host<A>(taps_x, ntx), static_cast<int>(ntx), tile_y, tile_x);
  return static_cast<int>(cudaGetLastError());
}

// One axis of the tile kernel: the other axis gets a single unit tap.
template <typename T, int kPass>
int launch_conv_axis(const void* in, void* out, int64_t nz, int64_t ny,
                     int64_t nx, const void* taps, int64_t nt, void* stream) {
  using A = typename mad::Compute<T>::type;
  const A unit = A(1);
  if (kPass == kPassY) {
    return launch_conv_tile<T, kPass>(in, out, nz, ny, nx, taps, nt, &unit, 1, stream);
  }
  return launch_conv_tile<T, kPass>(in, out, nz, ny, nx, &unit, 1, taps, nt, stream);
}

template <typename A>
bool tap_list(const void* w, const void* off, int64_t n, int64_t r, TapList<A>* t) {
  if (n < 1 || n > kMaxTaps || r < 0 || r > (kMaxTaps - 1) / 2) return false;
  *t = TapList<A>{};
  std::memcpy(t->w, w, static_cast<size_t>(n) * sizeof(A));
  const int32_t* o = static_cast<const int32_t*>(off);
  for (int64_t k = 0; k < n; ++k) {
    if (o[k] < -r || o[k] > r) return false;
    t->off[k] = static_cast<short>(o[k]);
  }
  t->n = static_cast<int>(n);
  t->r = static_cast<int>(r);
  return true;
}

template <typename T, int kR>
int launch_conv_yx_r(const T* in, T* out, int64_t nz, int64_t ny, int64_t nx,
                     const TapList<typename mad::Compute<T>::type>& ty,
                     const TapList<typename mad::Compute<T>::type>& tx,
                     cudaStream_t stream) {
  using A = typename mad::Compute<T>::type;
  const int rx = kR > 0 ? kR : tx.r;
  const int mid_stride = (kTX + 2 * rx) | 1;  // odd: the x pass's lanes hit 32 banks
  const size_t bytes = static_cast<size_t>(kTY) * (kOutStride + mid_stride) * sizeof(A);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_yx_kernel<T, kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = nx % (16 / sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(mad::blocks_for(nx, kTX), mad::blocks_for(ny, kTY),
                  mad::blocks_for(nz, kYXPlanes));
  conv_yx_kernel<T, kR><<<grid, kYXThreads, bytes, stream>>>(
      in, out, static_cast<int>(nz), static_cast<int>(ny), static_cast<int>(nx),
      ty, tx, mid_stride, vec);
  return static_cast<int>(cudaGetLastError());
}

// radius: the compiled radius (2, 4, 5 or 8: dense taps of that radius on
// both axes) or 0 (the generic form over the tap lists).
template <typename T>
int launch_conv_yx(const void* in, void* out, int64_t nz, int64_t ny,
                   int64_t nx, int64_t radius, const void* wy, const void* offy,
                   int64_t nty, int64_t ry, const void* wx, const void* offx,
                   int64_t ntx, int64_t rx, void* stream) {
  using A = typename mad::Compute<T>::type;
  TapList<A> ty, tx;
  if (!tap_list(wy, offy, nty, ry, &ty) || !tap_list(wx, offx, ntx, rx, &tx) ||
      nz * ny * nx == 0 || ny * nx > (int64_t(1) << 31) || nz > 65535 * kYXPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (radius != 0 && (ry != radius || rx != radius || nty != 2 * radius + 1 ||
                      ntx != 2 * radius + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return launch_conv_yx_r<T, 0>(src, dst, nz, ny, nx, ty, tx, s);
    case 2: return launch_conv_yx_r<T, 2>(src, dst, nz, ny, nx, ty, tx, s);
    case 4: return launch_conv_yx_r<T, 4>(src, dst, nz, ny, nx, ty, tx, s);
    case 5: return launch_conv_yx_r<T, 5>(src, dst, nz, ny, nx, ty, tx, s);
    case 8: return launch_conv_yx_r<T, 8>(src, dst, nz, ny, nx, ty, tx, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define MAD_CONV_ENTRY(SUF, T)                                                \
  extern "C" int mad_conv_z_##SUF(                                            \
      const void* in, void* out, int64_t zi, int64_t ny, int64_t nx,          \
      int64_t zo, const void* taps, int64_t ntaps, int valid, void* stream) { \
    return launch_conv_z<T>(in, out, zi, ny, nx, zo, taps, ntaps, valid,      \
                            stream);                                          \
  }                                                                           \
  extern "C" int mad_conv_yx_##SUF(                                           \
      const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,          \
      int64_t radius, const void* wy, const void* offy, int64_t nty,          \
      int64_t ry, const void* wx, const void* offx, int64_t ntx, int64_t rx,  \
      void* stream) {                                                         \
    return launch_conv_yx<T>(in, out, nz, ny, nx, radius, wy, offy, nty, ry,  \
                             wx, offx, ntx, rx, stream);                      \
  }                                                                           \
  extern "C" int mad_conv_y_##SUF(                                            \
      const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,          \
      const void* taps, int64_t ntaps, void* stream) {                        \
    return launch_conv_axis<T, kPassY>(in, out, nz, ny, nx, taps, ntaps,      \
                                       stream);                               \
  }                                                                           \
  extern "C" int mad_conv_x_##SUF(                                            \
      const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,          \
      const void* taps, int64_t ntaps, void* stream) {                        \
    return launch_conv_axis<T, kPassX>(in, out, nz, ny, nx, taps, ntaps,      \
                                       stream);                               \
  }

MAD_FOR_EACH_TYPE(MAD_CONV_ENTRY)
