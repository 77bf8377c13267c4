// 3D full-weighting restriction and linear prolongation, every centring.
//
// Replace the Pallas kernels `_restrict_kernel` (built by `_build_restrict`)
// and `_prolong_kernel` (built by `_build_prolong`) in
// multigridanisotropicdiffusion_tpu/ops/pallas_transfer.py.  The TPU kernels
// take only all-cell fields with X % 256 == 0 and leave every other level to
// XLA; these take every centring per axis and every shape.
//
// Both transfers are tensor products of 1-D operators with border rows.  The
// host builds, per axis, a table from the dense 1-D matrices
// (ops/transfer.py: restrict_taps / prolong_taps): for each output index the
// first input index and its weights, 4 per coarse index for restriction
// ([1] / [1/4 1/2 1/4] vertex, [1/2 3/8 1/8] / [1/8 3/8 3/8 1/8] cell) and 2
// per fine index for prolongation ((1), (1/2, 1/2) vertex; (1), (3/4, 1/4)
// cell).  A tap past the end of its row has weight 0 and a clamped index, so
// no read leaves the array.
//
//   restrict:  out[b,k,j,i] = sum wz[k,a] wy[j,c] wx[i,e] in[b, sz[k]+a, sy[j]+c, sx[i]+e]
//   prolong:   out[b,k,j,i] = same sums over 2 taps per axis (P e only; the
//              cycle adds it to x as a separate torch op)
//
// A leading batch axis lets the six tensor planes be restricted in one
// launch.  Bound on the card: device-memory bandwidth (restriction reads 8
// fine values per coarse value written, prolongation writes 8 fine values
// per coarse value read); the repeated tap reads of neighbouring threads hit
// L1/L2.  Design: one thread per output cell, threads along x, grid over
// (x-blocks, y-blocks, batch * z), 64-bit element offsets.
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

template <typename T, int kTaps>
__global__ void __launch_bounds__(kBX * kBY)
    transfer_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t iz,
                    int64_t iy, int64_t ix, int64_t oz, int64_t oy, int64_t ox,
                    const int32_t* __restrict__ sz,
                    const int32_t* __restrict__ sy,
                    const int32_t* __restrict__ sx,
                    const typename mad::Compute<T>::type* __restrict__ wz,
                    const typename mad::Compute<T>::type* __restrict__ wy,
                    const typename mad::Compute<T>::type* __restrict__ wx) {
  using A = typename mad::Compute<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBY + threadIdx.y;
  if (i >= ox || j >= oy) return;
  const int64_t batch = blockIdx.z / oz;
  const int64_t k = blockIdx.z % oz;
  const T* src = in + batch * (iz * iy * ix);

  A acc = 0;
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
    const int64_t z = mad::imin(sz[k] + a, iz - 1);
    A acc_y = 0;
#pragma unroll
    for (int c = 0; c < kTaps; ++c) {
      const int64_t y = mad::imin(sy[j] + c, iy - 1);
      const T* row = src + (z * iy + y) * ix;
      A acc_x = 0;
#pragma unroll
      for (int e = 0; e < kTaps; ++e) {
        const int64_t x = mad::imin(sx[i] + e, ix - 1);
        acc_x += wx[i * kTaps + e] * mad::load(row + x);
      }
      acc_y += wy[j * kTaps + c] * acc_x;
    }
    acc += wz[k * kTaps + a] * acc_y;
  }
  mad::store(out + batch * (oz * oy * ox) + (k * oy + j) * ox + i, acc);
}

template <typename T, int kTaps>
int launch(const void* in, void* out, int64_t batch, int64_t iz, int64_t iy,
           int64_t ix, int64_t oz, int64_t oy, int64_t ox, const void* sz,
           const void* sy, const void* sx, const void* wz, const void* wy,
           const void* wx, void* stream) {
  using A = typename mad::Compute<T>::type;
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(ox, kBX), mad::blocks_for(oy, kBY),
                  static_cast<unsigned>(batch * oz));
  transfer_kernel<T, kTaps><<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), iz, iy, ix, oz, oy, ox,
      static_cast<const int32_t*>(sz), static_cast<const int32_t*>(sy),
      static_cast<const int32_t*>(sx), static_cast<const A*>(wz),
      static_cast<const A*>(wy), static_cast<const A*>(wx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MAD_TRANSFER_ENTRY(SUF, T)                                            \
  extern "C" int mad_restrict3d_##SUF(                                        \
      const void* in, void* out, int64_t batch, int64_t fz, int64_t fy,       \
      int64_t fx, int64_t cz, int64_t cy, int64_t cx, const void* sz,         \
      const void* sy, const void* sx, const void* wz, const void* wy,         \
      const void* wx, void* stream) {                                         \
    return launch<T, 4>(in, out, batch, fz, fy, fx, cz, cy, cx, sz, sy, sx,  \
                        wz, wy, wx, stream);                                  \
  }                                                                           \
  extern "C" int mad_prolong3d_##SUF(                                         \
      const void* in, void* out, int64_t batch, int64_t cz, int64_t cy,       \
      int64_t cx, int64_t fz, int64_t fy, int64_t fx, const void* sz,         \
      const void* sy, const void* sx, const void* wz, const void* wy,         \
      const void* wx, void* stream) {                                         \
    return launch<T, 2>(in, out, batch, cz, cy, cx, fz, fy, fx, sz, sy, sx,  \
                        wz, wy, wx, stream);                                  \
  }

MAD_FOR_EACH_TYPE(MAD_TRANSFER_ENTRY)
