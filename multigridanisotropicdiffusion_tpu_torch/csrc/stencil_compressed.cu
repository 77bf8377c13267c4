// Red-black Gauss-Seidel half-sweep and residual on the 3D compressed DCA
// operator.
//
// Replaces the Pallas kernel `_stencil_kernel` with `_emit_halfsweep` and
// `_emit_residual` (multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py,
// built by `_build_stencil_pass`, compressed form with offsets=None).
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
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

template <typename T, bool kResidual>
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

  A off = P(0) * X(zp) + P(1) * X(zm);
  off += P(2) * X(yp) + P(3) * X(ym);
  off += P(4) * X(xp) + P(5) * X(xm);
  off += P(6) * (X(zp + yp) - X(zp + ym) - X(zm + yp) + X(zm + ym));
  off += P(7) * (X(zp + xp) - X(zp + xm) - X(zm + xp) + X(zm + xm));
  off += P(8) * (X(yp + xp) - X(yp + xm) - X(ym + xp) + X(ym + xm));
  const A diag = P(9);
  const A bv = mad::load(b + c);
  if (kResidual) {
    mad::store(out + c, bv - diag * X(0) - off);
  } else {
    mad::store(out + c, (bv - off) / diag);
  }
}

template <typename T, bool kResidual>
int launch(const void* planes, const void* x, const void* b, void* out,
           int64_t nz, int64_t ny, int64_t nx, int color, void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY),
                  static_cast<unsigned>(nz));
  stencil_kernel<T, kResidual><<<grid, block, 0,
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
    return launch<T, false>(planes, x, b, out, nz, ny, nx, color, stream);    \
  }                                                                           \
  extern "C" int mad_stencil_residual_##SUF(                                  \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, void* stream) {                     \
    return launch<T, true>(planes, x, b, out, nz, ny, nx, 0, stream);         \
  }

MAD_FOR_EACH_TYPE(MAD_STENCIL_ENTRY)

extern "C" const char* mad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
