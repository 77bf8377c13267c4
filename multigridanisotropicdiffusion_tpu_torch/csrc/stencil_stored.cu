// Red-black Gauss-Seidel half-sweep and residual on a 3D stored stencil
// operator: K coefficient planes with a run-time offset table.
//
// Replaces the Pallas kernel `_stencil_kernel` with `_emit_halfsweep` and
// `_emit_residual` in its stored form, `_offdiag_contraction_stored`
// (multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py, built by
// `_build_stencil_pass` with `offsets` given).
//
//   half-sweep:  out[p] = (z+y+x) % 2 == color
//                         ? (b[p] - sum_{k != c} A_k[p] x[p + o_k]) / A_c[p]
//                         : x[p]
//   residual:    out[p] = b[p] - A_c[p] x[p] - sum_{k != c} A_k[p] x[p + o_k]
//
// The operators: stored DCA (19 planes), collapsed Galerkin levels (27) and
// exact Galerkin levels (up to 117-125 planes, radius 2 in every dimension,
// x included).  The planes stay in the operator's own order; the table and
// the centre index come from the operator, by value in the launch.
//
// Borders: a term whose neighbour lies outside the grid is skipped, as the
// plain version's zero padding makes it 0, whatever its coefficient (the
// assembled operators hold exact zeros there, tests feed random planes).
// Cells at least `R` (the radius, a template parameter) from every border
// skip the range checks.  Out of place: offsets like (+-2,0,0) and
// (+-1,+-1,0) couple cells of the same colour; red (colour 0) goes first.
//
// Bound on the card: device-memory bandwidth.  Each cell reads K planes,
// b and x and writes 1 value: (K + 3) values per cell (11.8 GB per f32
// call for the 19-plane operator at 512^3, 8.05 GB for 117 planes at
// 256^3).  The neighbours of x hit L1/L2.  Design: one thread per cell,
// threads along x so each plane read is coalesced, the offset loop at run
// time (the table is uniform across a warp), 64-bit element offsets.
// 16-bit storage computes in f32 and rounds once at the store.
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

template <typename T, int R, bool kResidual>
__global__ void __launch_bounds__(kBX * kBY)
    stored_kernel(const T* __restrict__ planes, const T* __restrict__ x,
                  const T* __restrict__ b, T* __restrict__ out, int64_t nz,
                  int64_t ny, int64_t nx, const mad::OffsetTable tab,
                  int color) {
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
  const bool interior = k >= R && k < nz - R && j >= R && j < ny - R &&
                        i >= R && i < nx - R;
  A off = A(0);
  for (int t = 0; t < tab.n; ++t) {
    if (t == tab.center) continue;
    const int dz = tab.d[t][0];
    const int dy = tab.d[t][1];
    const int dx = tab.d[t][2];
    if (!interior && (k + dz < 0 || k + dz >= nz || j + dy < 0 ||
                      j + dy >= ny || i + dx < 0 || i + dx >= nx)) {
      continue;
    }
    off += mad::load(planes + t * n + c) *
           mad::load(x + c + dz * sz + dy * nx + dx);
  }
  const A diag = mad::load(planes + tab.center * n + c);
  const A bv = mad::load(b + c);
  if (kResidual) {
    mad::store(out + c, bv - diag * mad::load(x + c) - off);
  } else {
    mad::store(out + c, (bv - off) / diag);
  }
}

template <typename T, bool kResidual>
int launch(const void* planes, const void* x, const void* b, void* out,
           int64_t nz, int64_t ny, int64_t nx, const void* host_offsets,
           int64_t n_offsets, int64_t center, int color, void* stream) {
  mad::OffsetTable tab;
  if (!mad::offset_table(host_offsets, n_offsets, center, 3, &tab) ||
      tab.radius > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY),
                  static_cast<unsigned>(nz));
  const auto s = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(planes);
  const T* xv = static_cast<const T*>(x);
  const T* bv = static_cast<const T*>(b);
  T* o = static_cast<T*>(out);
  if (tab.radius <= 1) {
    stored_kernel<T, 1, kResidual><<<grid, block, 0, s>>>(p, xv, bv, o, nz, ny,
                                                          nx, tab, color);
  } else {
    stored_kernel<T, 2, kResidual><<<grid, block, 0, s>>>(p, xv, bv, o, nz, ny,
                                                          nx, tab, color);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MAD_STORED_ENTRY(SUF, T)                                              \
  extern "C" int mad_stencil_stored_halfsweep_##SUF(                          \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, const void* host_offsets,           \
      int64_t n_offsets, int64_t center, int color, void* stream) {           \
    return launch<T, false>(planes, x, b, out, nz, ny, nx, host_offsets,      \
                            n_offsets, center, color, stream);                \
  }                                                                           \
  extern "C" int mad_stencil_stored_residual_##SUF(                           \
      const void* planes, const void* x, const void* b, void* out,            \
      int64_t nz, int64_t ny, int64_t nx, const void* host_offsets,           \
      int64_t n_offsets, int64_t center, void* stream) {                      \
    return launch<T, true>(planes, x, b, out, nz, ny, nx, host_offsets,       \
                           n_offsets, center, 0, stream);                     \
  }

MAD_FOR_EACH_TYPE(MAD_STORED_ENTRY)
