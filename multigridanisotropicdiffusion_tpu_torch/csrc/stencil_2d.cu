// Red-black Gauss-Seidel half-sweep and residual on 2D operators: the
// compressed DCA operator (6 planes) and stored radius-1 operators (at most
// 9 planes, the host's tap plan).
//
// Replaces the Pallas kernel `_stencil_kernel_2d` with `_emit_halfsweep_2d`
// and `_emit_residual_2d`, and its contractions `_offdiag_contraction_2d`
// and `_offdiag_contraction_stored_2d`
// (multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py, built by
// `_build_stencil_pass_2d`).
//
//   half-sweep:  out = (y+x) % 2 == color ? (b - offdiag(A) x) / diag : x
//   residual:    out = b - diag * x - offdiag(A) x
//
// Compressed planes: fp_y, fm_y, fp_x, fm_x, m_yx, diag; the mixed term is
// m_yx * (x[+1,+1] - x[+1,-1] - x[-1,+1] + x[-1,-1]).  Stored operators:
// the planes in the operator's own order, the centre index given.
//
// Borders: a neighbour outside the grid reads as 0, as in the plain
// version's zero padding, whatever its coefficient.  Out of place (the
// mixed offsets couple cells of the same colour); red (colour 0) first.
//
// Bound on the card: device-memory bandwidth, (P + 3) values per cell (P =
// 6 compressed, 9 stored: 2.42 / 3.22 GB per f32 call at 8192^2).
//
// The compressed form: one thread per cell, threads along x (coalesced
// plane reads), a 2D grid of 32 x 8 blocks, so gridDim.y = ceil(Y / 8)
// stays within 65535 up to Y = 524280; 64-bit element offsets.  16-bit
// storage computes in f32 and rounds once at the store.
//
// The stored form is B12's kernel (stencil_stored.cuh) on one plane with no
// z ring (RZ = 0): 8 taps compiled in (the 9-plane operators of the 2D
// solves: stored DCA and collapsed Galerkin levels), the generic loop for
// fewer planes and for rows that are not whole 4-cell vectors.  Each
// product and sum rounds on its own, so it is its plain version's bytes.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (utils/bench_kernels.py;
// PERF.md): at 8192^2 88-92% [86-87%] of the bound in f32 [bf16], 1.4x
// [2.3-2.5x] faster than the one-thread-per-cell kernel it replaces.
#include "common.cuh"
#include "stencil_stored.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kBX * kBY)
    compressed2d_kernel(const T* __restrict__ planes, const T* __restrict__ x,
                        const T* __restrict__ b, T* __restrict__ out,
                        int64_t ny, int64_t nx, int color) {
  using A = typename mad::Compute<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBY + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int64_t n = ny * nx;
  const int64_t c = j * nx + i;
  if (!kResidual && static_cast<int>((j + i) & 1) != color) {
    out[c] = x[c];
    return;
  }
  const bool yp = j + 1 < ny;
  const bool ym = j > 0;
  const bool xp = i + 1 < nx;
  const bool xm = i > 0;
  const T* xc = x + c;
  const T* pc = planes + c;
  auto X = [&](bool in, int64_t o) -> A { return in ? mad::load(xc + o) : A(0); };
  auto P = [&](int p) -> A { return mad::load(pc + p * n); };

  A off = P(0) * X(yp, nx) + P(1) * X(ym, -nx);
  off += P(2) * X(xp, 1) + P(3) * X(xm, -1);
  off += P(4) * (X(yp && xp, nx + 1) - X(yp && xm, nx - 1) -
                 X(ym && xp, 1 - nx) + X(ym && xm, -nx - 1));
  const A diag = P(5);
  const A bv = mad::load(b + c);
  if (kResidual) {
    mad::store(out + c, bv - diag * mad::load(xc) - off);
  } else {
    mad::store(out + c, (bv - off) / diag);
  }
}

dim3 grid2d(int64_t ny, int64_t nx) {
  return dim3(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY));
}

template <typename T, bool kResidual>
int launch_compressed(const void* planes, const void* x, const void* b,
                      void* out, int64_t ny, int64_t nx, int color,
                      void* stream) {
  compressed2d_kernel<T, kResidual>
      <<<grid2d(ny, nx), dim3(kBX, kBY), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(planes), static_cast<const T*>(x),
          static_cast<const T*>(b), static_cast<T*>(out), ny, nx, color);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kResidual>
int launch_stored(const void* planes, const void* x, const void* b, void* out,
                  int64_t ny, int64_t nx, const void* host_plan, int64_t n_taps,
                  int64_t center, int color, void* stream) {
  mad::stored::Plan plan;
  int rz = 0, r = 0;
  if (ny < 1 || nx < 1 ||
      !mad::stored::make_plan(host_plan, n_taps, center, ny * nx, 2, &plan, &rz, &r) ||
      r > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return mad::stored::launch_taps<T, 0, 1, kResidual, 8>(
      static_cast<const T*>(planes), static_cast<const T*>(x),
      static_cast<const T*>(b), static_cast<T*>(out), 1, ny, nx, plan, color,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

#define MAD_2D_ENTRY(SUF, T)                                                  \
  extern "C" int mad_stencil2d_compressed_halfsweep_##SUF(                    \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t ny, int64_t nx, int color, void* stream) {                      \
    return launch_compressed<T, false>(planes, x, b, out, ny, nx, color,      \
                                       stream);                               \
  }                                                                           \
  extern "C" int mad_stencil2d_compressed_residual_##SUF(                     \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t ny, int64_t nx, void* stream) {                                 \
    return launch_compressed<T, true>(planes, x, b, out, ny, nx, 0, stream);  \
  }                                                                           \
  extern "C" int mad_stencil2d_stored_halfsweep_##SUF(                        \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t ny, int64_t nx, const void* host_plan, int64_t n_taps,          \
      int64_t center, int color, void* stream) {                              \
    return launch_stored<T, false>(planes, x, b, out, ny, nx, host_plan,      \
                                   n_taps, center, color, stream);            \
  }                                                                           \
  extern "C" int mad_stencil2d_stored_residual_##SUF(                         \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t ny, int64_t nx, const void* host_plan, int64_t n_taps,          \
      int64_t center, void* stream) {                                         \
    return launch_stored<T, true>(planes, x, b, out, ny, nx, host_plan,       \
                                  n_taps, center, 0, stream);                 \
  }

MAD_FOR_EACH_TYPE(MAD_2D_ENTRY)
