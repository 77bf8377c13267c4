// B12: red-black Gauss-Seidel half-sweep and residual on a 3D stored
// stencil operator (K coefficient planes, the host's tap plan), and its
// shard-local form B14 stored (the same kernel on a rank's block).
//
// Replaces the Pallas kernel `_stencil_kernel` with `_emit_halfsweep` and
// `_emit_residual` in its stored form, `_offdiag_contraction_stored`
// (multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py, built by
// `_build_stencil_pass` with `offsets` given).  The kernel, its bound and its
// design are in stencil_stored.cuh; this file compiles its 3D forms: radius
// 1 (the 19-plane stored DCA operator, 27-plane collapsed Galerkin levels)
// and radius 2 (exact Galerkin levels: 117 planes on the first coarse level,
// 125 below), each tap count compiled in, and the generic loop for any other
// count (pruned levels) and for rows that are not whole 4-cell vectors.
//
// Out of place: offsets like (+-2,0,0) and (+-1,+-1,0) couple cells of the
// same colour; red (colour 0) goes first.  On a rank's block the zero ring
// is exactly the plain version's masking of every term across the block's
// border (`_mask_local_shells_stored`), up to the sign of an exact zero.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (utils/bench_kernels.py;
// PERF.md), f32 [bf16] share of the bound: 512^3 stored DCA 90-91%
// [89-90%], 256^3 exact level 91-92% [86-88%], 128^3 125-plane level
// 90-92% [90-91%], 256^3 collapsed level 86-90% [85-87%], a pruned
// 81-plane level (the generic loop) 89% [73-79%]; the one-thread-per-cell
// kernel it replaces ran at 44-59% [23-32%], 1.5-2.0x [2.7-4.0x] slower.  SASS per
// tap and lane (utils/sass_count.py): ~43-48 instructions for a residual's 4
// cells (8 of them float), ~28-34 for a half-sweep's 2; at the card's issue
// rate that is, by estimate, about 2/3 of a bf16 call's time.
#include "stencil_stored.cuh"

namespace {

using mad::stored::Plan;

template <typename T, bool kRes>
int launch(const void* planes, const void* x, const void* b, void* out, int64_t nz,
           int64_t ny, int64_t nx, const void* host_plan, int64_t n_taps,
           int64_t center, int color, void* stream) {
  Plan plan;
  int rz = 0, r = 0;
  if (nz < 1 || ny < 1 || nx < 1 ||
      !mad::stored::make_plan(host_plan, n_taps, center, nz * ny * nx, 3, &plan, &rz,
                              &r) ||
      r > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* p = static_cast<const T*>(planes);
  const T* xv = static_cast<const T*>(x);
  const T* bv = static_cast<const T*>(b);
  T* o = static_cast<T*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (r == 1) {
    return mad::stored::launch_taps<T, 1, 1, kRes, 18, 26>(p, xv, bv, o, nz, ny, nx,
                                                           plan, color, s);
  }
  return mad::stored::launch_taps<T, 2, 2, kRes, 116, 124>(p, xv, bv, o, nz, ny, nx,
                                                           plan, color, s);
}

}  // namespace

#define MAD_STORED_ENTRY(SUF, T)                                              \
  extern "C" int mad_stencil_stored_halfsweep_##SUF(                          \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, const void* host_plan,              \
      int64_t n_taps, int64_t center, int color, void* stream) {              \
    return launch<T, false>(planes, x, b, out, nz, ny, nx, host_plan, n_taps, \
                            center, color, stream);                           \
  }                                                                           \
  extern "C" int mad_stencil_stored_residual_##SUF(                           \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, const void* host_plan,              \
      int64_t n_taps, int64_t center, void* stream) {                         \
    return launch<T, true>(planes, x, b, out, nz, ny, nx, host_plan, n_taps,  \
                           center, 0, stream);                                \
  }

MAD_FOR_EACH_TYPE(MAD_STORED_ENTRY)
