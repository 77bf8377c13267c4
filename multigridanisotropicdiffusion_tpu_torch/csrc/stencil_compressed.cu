// Red-black Gauss-Seidel half-sweep and residual on the 3D compressed DCA
// operator, whole-domain (B1, B2) and shard-local (B14).
//
// Replaces the Pallas kernel `_stencil_kernel` with `_emit_halfsweep` and
// `_emit_residual` (multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py,
// built by `_build_stencil_pass`, compressed form with offsets=None), with
// local_mask=False (the `mad_stencil_*` entry points) and local_mask=True
// (`mad_stencil_*_local`, the masking of `_mask_local_shells`).
//
//   half-sweep:  out = parity == color ? (b - offdiag(A) x) / diag : x
//   residual:    out = b - diag * x - offdiag(A) x
//
// offdiag(A) x is the 18-term contraction of `_offdiag_contraction`: six
// folded face planes and three mixed planes, each mixed plane times the
// signed sum of its four diagonal neighbours.  Plane order:
// fp_z, fm_z, fp_y, fm_y, fp_x, fm_x, m_zy, m_zx, m_yx, diag.
//
// Out of place: the mixed offsets (0,±1,±1), (±1,0,±1), (±1,±1,0) have an
// even index sum, so they couple cells of the SAME colour; the kernel reads
// only the old x and writes a separate output.  Red (even z+y+x) is colour
// 0.  Border reads are clamped into the domain without branching: Neumann
// folding makes every coefficient that reaches out of the domain exactly 0,
// and a clamped read is a finite in-domain value.
//
// Bound on the card: device-memory bandwidth.  Each cell reads 10
// coefficients + b + x and writes 1 value: 52 B/cell in f32, 26 B in bf16
// (about 7 GB per f32 half-sweep at 512^3).  The 19 reads of x per cell hit
// L1/L2 because neighbouring threads share them.  Design: one thread per
// cell, threads along x so every plane access is coalesced, a grid over
// (x-blocks, y-blocks, z); 64-bit element offsets (10 * 512^3 is within 1.6x
// of 2^31).  Shared-memory tiling of x is later work.
//
// Shard-local form (kLocalMask, the block of one rank in the distributed
// solve, parallel/halo.py): the coefficients at the block's borders are not
// zero there, so the kernel zeroes every term that reaches across the block
// itself, as `_mask_local_shells` does: fp_d on the last shell of axis d,
// fm_d on the first, and each mixed plane as a whole wherever either of its
// two axes is on either shell (not only the out-of-range terms of its
// four-term sum: the halo code recomputes those cells in full).  The reads
// stay clamped (a zeroed coefficient times a finite value); the bound is the
// same 52 B/cell.
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

template <typename T, bool kResidual, bool kLocalMask>
__global__ void __launch_bounds__(kBX * kBY)
    stencil_kernel(const T* __restrict__ planes, const T* __restrict__ x,
                   const T* __restrict__ b, T* __restrict__ out, int64_t nz,
                   int64_t ny, int64_t nx, int color) {
  using A = typename mad::Compute<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBY + threadIdx.y;
  const int64_t k = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const int64_t sz = ny * nx;
  const int64_t n = nz * sz;
  const int64_t c = k * sz + j * nx + i;
  if (!kResidual && static_cast<int>((k + j + i) & 1) != color) {
    out[c] = x[c];
    return;
  }
  // clamped neighbour offsets (0 at a border: multiplied by a zero coefficient)
  const int64_t zp = k + 1 < nz ? sz : 0;
  const int64_t zm = k > 0 ? -sz : 0;
  const int64_t yp = j + 1 < ny ? nx : 0;
  const int64_t ym = j > 0 ? -nx : 0;
  const int64_t xp = i + 1 < nx ? 1 : 0;
  const int64_t xm = i > 0 ? -1 : 0;
  const T* xc = x + c;
  const T* pc = planes + c;
  auto X = [&](int64_t o) -> A { return mad::load(xc + o); };
  auto P = [&](int p) -> A { return mad::load(pc + p * n); };

  A cf[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) cf[p] = P(p);
  if (kLocalMask) {
    // the offsets above are 0 exactly on the shells they would cross
    const bool zin = zp != 0 && zm != 0;
    const bool yin = yp != 0 && ym != 0;
    const bool xin = xp != 0 && xm != 0;
    if (zp == 0) cf[0] = A(0);
    if (zm == 0) cf[1] = A(0);
    if (yp == 0) cf[2] = A(0);
    if (ym == 0) cf[3] = A(0);
    if (xp == 0) cf[4] = A(0);
    if (xm == 0) cf[5] = A(0);
    if (!(zin && yin)) cf[6] = A(0);
    if (!(zin && xin)) cf[7] = A(0);
    if (!(yin && xin)) cf[8] = A(0);
  }
  A off = cf[0] * X(zp) + cf[1] * X(zm);
  off += cf[2] * X(yp) + cf[3] * X(ym);
  off += cf[4] * X(xp) + cf[5] * X(xm);
  off += cf[6] * (X(zp + yp) - X(zp + ym) - X(zm + yp) + X(zm + ym));
  off += cf[7] * (X(zp + xp) - X(zp + xm) - X(zm + xp) + X(zm + xm));
  off += cf[8] * (X(yp + xp) - X(yp + xm) - X(ym + xp) + X(ym + xm));
  const A diag = P(9);
  const A bv = mad::load(b + c);
  if (kResidual) {
    mad::store(out + c, bv - diag * X(0) - off);
  } else {
    mad::store(out + c, (bv - off) / diag);
  }
}

template <typename T, bool kResidual, bool kLocalMask>
int launch(const void* planes, const void* x, const void* b, void* out,
           int64_t nz, int64_t ny, int64_t nx, int color, void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY),
                  static_cast<unsigned>(nz));
  stencil_kernel<T, kResidual, kLocalMask><<<grid, block, 0,
                                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(planes), static_cast<const T*>(x),
      static_cast<const T*>(b), static_cast<T*>(out), nz, ny, nx, color);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MAD_STENCIL_ENTRY(SUF, T)                                             \
  extern "C" int mad_stencil_halfsweep_##SUF(                                 \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, int color, void* stream) {          \
    return launch<T, false, false>(planes, x, b, out, nz, ny, nx, color,      \
                                   stream);                                   \
  }                                                                           \
  extern "C" int mad_stencil_residual_##SUF(                                  \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, void* stream) {                     \
    return launch<T, true, false>(planes, x, b, out, nz, ny, nx, 0, stream);  \
  }                                                                           \
  extern "C" int mad_stencil_halfsweep_local_##SUF(                           \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, int color, void* stream) {          \
    return launch<T, false, true>(planes, x, b, out, nz, ny, nx, color,       \
                                  stream);                                    \
  }                                                                           \
  extern "C" int mad_stencil_residual_local_##SUF(                            \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, void* stream) {                     \
    return launch<T, true, true>(planes, x, b, out, nz, ny, nx, 0, stream);   \
  }

MAD_FOR_EACH_TYPE(MAD_STENCIL_ENTRY)

extern "C" const char* mad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
