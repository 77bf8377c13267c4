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
//   residual:    out = (b - diag * x) - offdiag(A) x
//
// offdiag(A) x is the 18-term contraction of `CompressedDCAOperator.
// offdiag_apply` (ops/compressed.py), in its order: per axis z, y, x the
// face pair fp * x[+e] + fm * x[-e], added in that order, then per mixed
// plane zy, zx, yx its coefficient times the signed four-point sum
// ((x[++] - x[+-]) - x[-+]) + x[--].  Plane order: fp_z, fm_z, fp_y, fm_y,
// fp_x, fm_x, m_zy, m_zx, m_yx, diag.  Every product, sum and the division
// round on their own and x is zero outside the grid, as in the plain
// versions, so every output is their bytes.
//
// Out of place: the mixed offsets (0,±1,±1), (±1,0,±1), (±1,±1,0) have an
// even index sum, so they couple cells of the SAME colour; the kernel reads
// only the old x and writes a separate output.  Red (even z+y+x) is colour
// 0.
//
// Bound on the card: device-memory bandwidth.  Each cell reads 10
// coefficients + b + x and writes 1 value: 52 B/cell in f32, 26 B in bf16
// (about 7 GB per f32 half-sweep at 512^3).  The kernel is stencil_tile.cuh's
// tile march (x staged once in a ring of 4 zero-padded planes in shared
// memory; a lane owns 4 cells, a half-sweep contracts its 2 on-colour ones;
// planes and b as one vector per lane, evict-first) with the contraction
// `Compressed` below: a lane loads the 9 off-diagonal planes' vectors, and
// each of its cells reads its 18 neighbours from the ring at compile-time
// offsets (cells of a lane share many of them).  bf16 moves half of f32's
// bytes for the same instructions, so its vector forms run three blocks an
// SM (80 registers) to keep more loads in flight.  The launch geometry
// (tile, planes per block, grid) is the host's (ops/cuda_smoothers.py
// `launch_geometry`): runs of 4-8 planes at the solves' sizes, so the last
// wave of blocks is a small share of a launch; the launcher refuses a grid
// beyond the limits.
//
// Shard-local form (kLocal, the block of one rank in the distributed solve,
// parallel/halo.py): the coefficients at the block's borders are not zero
// there, so the kernel zeroes every coefficient that reaches across the
// block itself, as `_mask_local_shells` does: fp_d on the last shell of axis
// d, fm_d on the first, and each mixed plane as a whole wherever either of
// its two axes is on either shell (not only the out-of-range terms of its
// four-term sum: the halo code recomputes those cells in full).  The masks
// apply to the loaded vectors before they are widened, and only where the
// lane's cells touch a shell (the z and row tests are warp-uniform; only the
// block's first and last columns differ within a lane), so the form costs
// the whole-domain form's registers.  A zeroed coefficient times the staged
// x is the plain version's product, so the outputs are its values.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (utils/bench_kernels.py;
// PERF.md), share of the bound f32 [bf16]: 512^3 92% [90-91%], a rank's
// (256, 512, 512) block 92% [86-89%]; 1.01-1.06x [1.43-1.71x] faster than
// the one-thread-per-cell kernel it replaces.
#include "stencil_tile.cuh"

namespace {

using mad::tile::kVec;
using mad::tile::ring_offset;

// The 18-term contraction; kLocal: with `_mask_local_shells`' masking.
template <typename T, bool kLocal>
struct Compressed {
  using A = typename mad::Compute<T>::type;
  using Where = mad::tile::Where;
  // 16-bit rows of whole vectors: three blocks an SM (80 registers a
  // thread) keep more of bf16's plane loads in flight (PERF.md: 86% of the
  // bound against 79% at two); f32 gained nothing at three, and the scalar
  // forms would spill
  static constexpr int min_blocks(bool vec) { return sizeof(T) == 2 && vec ? 3 : 2; }
  template <bool kV>
  struct Frag {
    mad::tile::Raw4<T, kV> p[9];
  };
  int64_t n;  // values per plane

  __device__ __forceinline__ int64_t diag() const { return 9 * n; }

  // The 9 off-diagonal planes' values of the lane's cells; kLocal: each
  // zeroed where `_mask_local_shells` zeroes it.  Only warps on a border
  // plane or row of the block, and lanes holding its first or last column,
  // have anything to mask.
  template <bool kV>
  __device__ __forceinline__ Frag<kV> fetch(const T* pb, const bool (&iok)[kVec],
                                            const Where& at) const {
    Frag<kV> f;
#pragma unroll
    for (int p = 0; p < 9; ++p) f.p[p] = mad::tile::fetch4<T, kV, true>(pb + p * n, iok);
    if (kLocal && (at.z == 0 || at.z == at.nz - 1 || at.y == 0 || at.y == at.ny - 1 ||
                   at.x == 0 || at.x + kVec >= at.nx)) {
      const bool zlo = at.z > 0, zhi = at.z < at.nz - 1;
      const bool ylo = at.y > 0, yhi = at.y < at.ny - 1;
      bool keep[9][kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool xlo = at.x + j > 0, xhi = at.x + j < at.nx - 1;
        const bool k[9] = {zhi, zlo, yhi, ylo, xhi, xlo, zlo && zhi && ylo && yhi,
                           zlo && zhi && xlo && xhi, ylo && yhi && xlo && xhi};
#pragma unroll
        for (int p = 0; p < 9; ++p) keep[p][j] = k[p];
      }
#pragma unroll
      for (int p = 0; p < 9; ++p) mad::tile::mask4<T, kV>(f.p[p], keep[p]);
    }
    return f;
  }

  template <bool kV, bool kRes, int P, int NC, typename XR>
  __device__ __forceinline__ void contract(A (&acc)[NC], const Frag<kV>& frag, const T*,
                                           const bool (&)[kVec], XR&& xr) const {
    using mad::add_rn;
    using mad::mul_rn;
    using mad::sub_rn;
    const A* ring[3] = {xr(0), xr(1), xr(2)};  // planes z - 1, z, z + 1
    A cf[9][kVec];
#pragma unroll
    for (int p = 0; p < 9; ++p) mad::tile::unpack4<T, kV>(frag.p[p], cf[p]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = kRes ? c : P + 2 * c;
      // x[z + dz, y + dy, x + dx] of cell j
      auto X = [&](int dz, int dy, int dx) { return ring[dz + 1][ring_offset(dy, dx, j)]; };
      auto face = [&](int p, A xp, A xm) {
        return add_rn(mul_rn(cf[p][j], xp), mul_rn(cf[p + 1][j], xm));
      };
      auto mixed = [&](int p, A pp, A pm, A mp, A mm) {
        return mul_rn(cf[p][j], add_rn(sub_rn(sub_rn(pp, pm), mp), mm));
      };
      A off = face(0, X(1, 0, 0), X(-1, 0, 0));
      off = add_rn(off, face(2, X(0, 1, 0), X(0, -1, 0)));
      off = add_rn(off, face(4, X(0, 0, 1), X(0, 0, -1)));
      off = add_rn(off, mixed(6, X(1, 1, 0), X(1, -1, 0), X(-1, 1, 0), X(-1, -1, 0)));
      off = add_rn(off, mixed(7, X(1, 0, 1), X(1, 0, -1), X(-1, 0, 1), X(-1, 0, -1)));
      off = add_rn(off, mixed(8, X(0, 1, 1), X(0, 1, -1), X(0, -1, 1), X(0, -1, -1)));
      acc[c] = off;
    }
  }
};

template <typename T, bool kRes, bool kLocal>
int launch(const void* planes, const void* x, const void* b, void* out, int64_t nz,
           int64_t ny, int64_t nx, int64_t zrun, int color, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* p = static_cast<const T*>(planes);
  const T* xv = static_cast<const T*>(x);
  const T* bv = static_cast<const T*>(b);
  T* o = static_cast<T*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const Compressed<T, kLocal> op{nz * ny * nx};
  if (mad::tile::vector_rows(nx, p, xv, bv, o)) {
    return mad::tile::launch_form<T, 1, 1, kRes, true>(p, xv, bv, o, nz, ny, nx, zrun, op,
                                                       color, s);
  }
  return mad::tile::launch_form<T, 1, 1, kRes, false>(p, xv, bv, o, nz, ny, nx, zrun, op,
                                                      color, s);
}

}  // namespace

#define MAD_STENCIL_ENTRY(SUF, T)                                                   \
  extern "C" int mad_stencil_halfsweep_##SUF(                                       \
      const void* planes, const void* x, const void* b, void* out, int64_t nz,      \
      int64_t ny, int64_t nx, int64_t zrun, int color, void* stream) {              \
    return launch<T, false, false>(planes, x, b, out, nz, ny, nx, zrun, color,      \
                                   stream);                                         \
  }                                                                                 \
  extern "C" int mad_stencil_residual_##SUF(                                        \
      const void* planes, const void* x, const void* b, void* out, int64_t nz,      \
      int64_t ny, int64_t nx, int64_t zrun, void* stream) {                         \
    return launch<T, true, false>(planes, x, b, out, nz, ny, nx, zrun, 0, stream);  \
  }                                                                                 \
  extern "C" int mad_stencil_halfsweep_local_##SUF(                                 \
      const void* planes, const void* x, const void* b, void* out, int64_t nz,      \
      int64_t ny, int64_t nx, int64_t zrun, int color, void* stream) {              \
    return launch<T, false, true>(planes, x, b, out, nz, ny, nx, zrun, color,       \
                                  stream);                                          \
  }                                                                                 \
  extern "C" int mad_stencil_residual_local_##SUF(                                  \
      const void* planes, const void* x, const void* b, void* out, int64_t nz,      \
      int64_t ny, int64_t nx, int64_t zrun, void* stream) {                         \
    return launch<T, true, true>(planes, x, b, out, nz, ny, nx, zrun, 0, stream);   \
  }

MAD_FOR_EACH_TYPE(MAD_STENCIL_ENTRY)

extern "C" const char* mad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
