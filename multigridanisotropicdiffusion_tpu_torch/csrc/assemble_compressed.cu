// Assembly of the 10-plane compressed DCA operator from the 6 tensor planes.
//
// Replaces the Pallas kernel `_assemble_kernel` (built by `_build_assemble`)
// in multigridanisotropicdiffusion_tpu/ops/pallas_assemble.py.  The TPU
// kernel computed the z derivative centrally everywhere and left the two
// z-border planes to an XLA patch (`_xla_z_border_faces` and the z fold);
// this kernel computes every border in place, so no patch follows it.
//
// Spec: ops.compressed.assemble_compressed_dca.  Per cell, with tensor
// components a00 a01 a02 a11 a12 a22 (axes z, y, x) and the host's weights
// w2[d] = -dt / h_d^2 and wd[d][d2] = -dt / (4 h_d h_d2):
//   D(m, axis)  = m[+1] - m[-1] inside, -3 m[0] + 4 m[1] - m[2] on the first
//                 shell, 3 m[-1] - 4 m[-2] + m[-3] on the last
//   v2_d        = w2[d] * a_dd
//   t_d         = sum_d2 wd[d][d2] * D(a_dd2, d2)
//   diag        = 1 - 2 v2_z - 2 v2_y - 2 v2_x
//   fp_d, fm_d  = v2_d + t_d, v2_d - t_d, then the Neumann fold along d:
//                 first shell fp += fm, fm = 0; last shell fm += fp, fp = 0
//   m_dd2       = 2 wd[d][d2] * a_dd2, zero on the border shells of d and d2
// Output plane order: fp_z, fm_z, fp_y, fm_y, fp_x, fm_x, m_zy, m_zx, m_yx,
// diag.  Needs at least 3 points per axis (the multigrid levels have >= 6).
//
// Bound on the card: device-memory bandwidth, 6 planes read and 10 written
// (64 B/cell in f32); the derivative stencils re-read neighbours that
// L1/L2 serve.  Design: one thread per cell, threads along x, grid over
// (x-blocks, y-blocks, z), 64-bit element offsets (10 * 512^3 elements).
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

// Derivative surrogate of plane m along an axis of extent len and element
// stride s, at the cell whose index on that axis is idx.
template <typename T>
__device__ __forceinline__ typename mad::Compute<T>::type derivative(
    const T* m, int64_t idx, int64_t len, int64_t s) {
  using A = typename mad::Compute<T>::type;
  if (idx == 0) {
    return A(-3) * mad::load(m) + A(4) * mad::load(m + s) - mad::load(m + 2 * s);
  }
  if (idx == len - 1) {
    return A(3) * mad::load(m) - A(4) * mad::load(m - s) + mad::load(m - 2 * s);
  }
  return mad::load(m + s) - mad::load(m - s);
}

template <typename A>
__device__ __forceinline__ void fold(A& fp, A& fm, int64_t idx, int64_t len) {
  if (idx == 0) {
    fp = fp + fm;
    fm = A(0);
  }
  if (idx == len - 1) {
    fm = fm + fp;
    fp = A(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
    assemble_kernel(const T* __restrict__ tensor, T* __restrict__ out,
                    int64_t nz, int64_t ny, int64_t nx, double w2z, double w2y,
                    double w2x, double wzz, double wzy, double wzx, double wyz,
                    double wyy, double wyx, double wxz, double wxy,
                    double wxx) {
  using A = typename mad::Compute<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBY + threadIdx.y;
  const int64_t k = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const int64_t sz = ny * nx;
  const int64_t n = nz * sz;
  const int64_t c = k * sz + j * nx + i;
  const T* a00 = tensor + c;
  const T* a01 = a00 + n;
  const T* a02 = a01 + n;
  const T* a11 = a02 + n;
  const T* a12 = a11 + n;
  const T* a22 = a12 + n;

  auto dz = [&](const T* m) { return derivative(m, k, nz, sz); };
  auto dy = [&](const T* m) { return derivative(m, j, ny, nx); };
  auto dx = [&](const T* m) { return derivative(m, i, nx, int64_t(1)); };

  const A v2_z = A(w2z) * mad::load(a00);
  const A v2_y = A(w2y) * mad::load(a11);
  const A v2_x = A(w2x) * mad::load(a22);
  const A t_z = A(wzz) * dz(a00) + A(wzy) * dy(a01) + A(wzx) * dx(a02);
  const A t_y = A(wyz) * dz(a01) + A(wyy) * dy(a11) + A(wyx) * dx(a12);
  const A t_x = A(wxz) * dz(a02) + A(wxy) * dy(a12) + A(wxx) * dx(a22);
  const A diag = A(1) - A(2) * v2_z - A(2) * v2_y - A(2) * v2_x;

  A fp_z = v2_z + t_z, fm_z = v2_z - t_z;
  A fp_y = v2_y + t_y, fm_y = v2_y - t_y;
  A fp_x = v2_x + t_x, fm_x = v2_x - t_x;
  fold(fp_z, fm_z, k, nz);
  fold(fp_y, fm_y, j, ny);
  fold(fp_x, fm_x, i, nx);

  const bool z_in = k > 0 && k < nz - 1;
  const bool y_in = j > 0 && j < ny - 1;
  const bool x_in = i > 0 && i < nx - 1;
  const A m_zy = z_in && y_in ? A(2 * wzy) * mad::load(a01) : A(0);
  const A m_zx = z_in && x_in ? A(2 * wzx) * mad::load(a02) : A(0);
  const A m_yx = y_in && x_in ? A(2 * wyx) * mad::load(a12) : A(0);

  T* o = out + c;
  mad::store(o, fp_z);
  mad::store(o + n, fm_z);
  mad::store(o + 2 * n, fp_y);
  mad::store(o + 3 * n, fm_y);
  mad::store(o + 4 * n, fp_x);
  mad::store(o + 5 * n, fm_x);
  mad::store(o + 6 * n, m_zy);
  mad::store(o + 7 * n, m_zx);
  mad::store(o + 8 * n, m_yx);
  mad::store(o + 9 * n, diag);
}

}  // namespace

#define MAD_ASSEMBLE_ENTRY(SUF, T)                                           \
  extern "C" int mad_assemble_compressed_##SUF(                              \
      const void* tensor, void* out, int64_t nz, int64_t ny, int64_t nx,     \
      double w2z, double w2y, double w2x, double wzz, double wzy,            \
      double wzx, double wyz, double wyy, double wyx, double wxz,            \
      double wxy, double wxx, void* stream) {                                \
    const dim3 block(kBX, kBY);                                              \
    const dim3 grid(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY),      \
                    static_cast<unsigned>(nz));                              \
    assemble_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>( \
        static_cast<const T*>(tensor), static_cast<T*>(out), nz, ny, nx, w2z, \
        w2y, w2x, wzz, wzy, wzx, wyz, wyy, wyx, wxz, wxy, wxx);              \
    return static_cast<int>(cudaGetLastError());                             \
  }

MAD_FOR_EACH_TYPE(MAD_ASSEMBLE_ENTRY)
