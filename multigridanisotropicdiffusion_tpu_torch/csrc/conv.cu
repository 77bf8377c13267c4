// Gaussian smoothing of the VED pipeline: the 1-D correlation along z (B6)
// and the fused y-then-x correlation (B7).
//
// Replace the Pallas kernels `_conv_z_kernel` (built by `_build_conv_z`) and
// `_conv_yx_kernel` (built by `_build_conv_yx`) in
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
//
// Taps run in ascending t and zero taps are skipped (the z-slab pipeline pads
// short kernels with zeros), as in ops/hessian.py's `_conv_axis`; the sums
// are in the compute type (float for bf16 storage) and round once at the
// store.  Each product and sum rounds on its own (no fused multiply-add), as
// in the plain versions, so the smoothed fields agree bit for bit: the
// vesselness select downstream compares responses of different scales, and
// a last-bit difference at a near-tie would pick another scale's Hessian.
// At most 129 taps (kernel_radius caps r at 64); the host passes them in a
// buffer that the launch copies into the kernel's parameters, and each block
// stages them in shared memory.
//
// Bound on the card: device-memory bandwidth.  At 512^3 f32 with sigma = 2
// (r = 8), conv_z reads 530 planes and writes 514 (1.10 GB, 0.33 ms at
// 3.35 TB/s); conv_yx reads and writes 514 planes (1.08 GB, 0.32 ms).
// Design: conv_z runs one thread per 8 consecutive z outputs of one (y, x)
// column, threads along x so every plane load is one coalesced row; the 8
// outputs slide over (nt + 7) input planes held one at a time in a register,
// so each input plane is read about (nt + 7) / 8 times instead of nt times
// (the re-reads hit L2).  conv_yx runs one block per (z, y-tile, x-tile):
// it loads the (TY + 2ry) x (TX + 2rx) input tile with clamped indices into
// shared memory (clamping is the edge replication), runs the y pass into a
// shared TY x (TX + 2rx) intermediate and the x pass to the output, so the
// volume makes one round trip through device memory, as on the TPU.  Its
// 32 x 8 threads walk the tile in rows, lanes along x (coalesced loads,
// conflict-free shared memory).  Tiles (32 x 64 outputs) shrink until they
// fit the 227 KB of shared memory a block may use.
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

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
    conv_yx_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t ny,
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
  A* tile = wx + ntx;              // height x width input tile
  A* mid = tile + height * width;  // tile_y x width after the y pass

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

  for (int row = ty; row < tile_y; row += kBY) {
    for (int c = tx; c < width; c += kBX) {
      A acc = 0;
      for (int t = 0; t < nty; ++t) {
        const A wt = wy[t];
        if (wt != A(0)) {
          acc = mad::add_rn(acc, mad::mul_rn(wt, tile[(row + t) * width + c]));
        }
      }
      mid[row * width + c] = acc;
    }
  }
  __syncthreads();

  T* dst = out + k * ny * nx;
  for (int row = ty; row < tile_y && y0 + row < ny; row += kBY) {
    for (int c = tx; c < tile_x && x0 + c < nx; c += kBX) {
      A acc = 0;
      for (int t = 0; t < ntx; ++t) {
        const A wt = wx[t];
        if (wt != A(0)) {
          acc = mad::add_rn(acc, mad::mul_rn(wt, mid[row * width + c + t]));
        }
      }
      mad::store(dst + (y0 + row) * nx + x0 + c, acc);
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

template <typename T>
int launch_conv_yx(const void* in, void* out, int64_t nz, int64_t ny,
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
    return (nty + ntx + (tile_y + 2 * ry) * width + tile_y * width) * sizeof(A);
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
        conv_yx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(mad::blocks_for(nx, tile_x), mad::blocks_for(ny, tile_y),
                  static_cast<unsigned>(nz));
  conv_yx_kernel<T><<<grid, dim3(kBX, kBY), bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), ny, nx,
      taps_from_host<A>(taps_y, nty), static_cast<int>(nty),
      taps_from_host<A>(taps_x, ntx), static_cast<int>(ntx), tile_y, tile_x);
  return static_cast<int>(cudaGetLastError());
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
      const void* taps_y, int64_t nty, const void* taps_x, int64_t ntx,       \
      void* stream) {                                                         \
    return launch_conv_yx<T>(in, out, nz, ny, nx, taps_y, nty, taps_x, ntx,   \
                             stream);                                         \
  }

MAD_FOR_EACH_TYPE(MAD_CONV_ENTRY)
