// The stored-operator stencil kernel: red-black Gauss-Seidel half-sweeps
// and the residual on an operator of K coefficient planes in its own order,
// 3D (B12, csrc/stencil_stored.cu) and 2D (B13's stored form,
// csrc/stencil_2d.cu).
//
// Replaces the Pallas kernel `_stencil_kernel` with `_emit_halfsweep` and
// `_emit_residual` in its stored forms, `_offdiag_contraction_stored`
// (built by `_build_stencil_pass` with `offsets`) and
// `_offdiag_contraction_stored_2d` (`_build_stencil_pass_2d`), in
// multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py.  The TPU
// kernel compiles one kernel per static offset table; this one compiles the
// tap count (the layouts the solves use) and takes the table from the host.
//
//   half-sweep:  out[p] = (z+y+x) % 2 == color ? (b[p] - off[p]) / A_c[p] : x[p]
//   residual:    out[p] = (b[p] - A_c[p] x[p]) - off[p]
//   off[p]       = sum over the non-centre taps k, in the operator's order,
//                  of A_k[p] x[p + o_k], x zero outside the grid
//
// Each product and sum rounds on its own (no fused multiply-add) and the sum
// starts at its first product, as in the plain versions (core/stencil.py's
// `_contract`, ops/smoothers.py's `gs_halfsweep`), so the outputs are their
// bytes; 16-bit storage computes in float and rounds once at the store.
//
// Bound on the card: device-memory bandwidth.  Each cell reads K planes, b
// and x and writes one value: (K + 3) values per cell (8.05 GB per f32
// call for 117 planes at 256^3, 11.8 GB for the 19-plane operator at
// 512^3).  Two products' worth of float work per tap is far below it.
//
// The host plan (ops/cuda_smoothers.py `tap_plan`, cached per offset
// table) lists the non-centre taps in the operator's order: plane index,
// (dz, dy, dx) and, for each of a lane's four cells, the offset of its
// neighbour in the staged x tile.  The launcher checks the offsets against
// this file's tile geometry and passes the plan by value (each tap's plane
// as an element offset).  Where the tap count is one of the solves' layouts
// (3D: 18, 26 at radius 1, 116, 124 at radius 2; 2D: 8) it is compiled in:
// the tap loop unrolls, every plan entry is an operand from the kernel's
// parameters, and the plane loads of many taps are in flight.  Any other
// count (a pruned operator) takes the generic form, a loop over the plan.
//
// The tile march, ring staging, vector loads and the launch are
// stencil_tile.cuh's, shared with the compressed operator's kernel
// (stencil_compressed.cu); this file is the stored operator's contraction,
// `Taps`.  Each tap's ring slot, ring offsets and plane address are
// warp-uniform work beside one plane load and 4 (half-sweep: 2) ring reads,
// products and sums; bf16 moves half the bytes of f32 for the same
// instructions per tap.
// What it measured: stencil_stored.cu (3D) and stencil_2d.cu (2D).
#pragma once

#include "stencil_tile.cuh"

namespace mad {
namespace stored {

using tile::kVec;
using tile::ring_offset;

constexpr int kMaxTaps = 124;  // 125 planes, the centre apart
constexpr int kPlanCols = 8;   // host plan row: t, dz, dy, dx, offset per cell

// The plan as the kernel takes it, by value: tap k reads plane poff[k]
// (elements from plane 0) and, for cell j of its lane, the ring value
// off[k][j] from the lane's base in the ring slot of plane z + dz[k] - RZ.
struct Plan {
  int64_t poff[kMaxTaps];
  short off[kMaxTaps][kVec];
  signed char dz[kMaxTaps];
  int n;
  int64_t diag;
};

// The plan from the host's (n_taps, kPlanCols) int32 rows; false if a row
// does not fit this geometry, names the centre or a plane out of range.
inline bool make_plan(const void* host, int64_t n_taps, int64_t center,
                      int64_t plane_elems, int ndim, Plan* p, int* rz, int* r) {
  if (n_taps < 1 || n_taps > kMaxTaps || center < 0 || center > n_taps) {
    return false;
  }
  const int32_t* h = static_cast<const int32_t*>(host);
  auto iabs = [](int v) { return v < 0 ? -v : v; };
  int rz_ = 0, ryx = 0;
  for (int64_t k = 0; k < n_taps; ++k) {
    const int32_t* row = h + k * kPlanCols;
    const int t = row[0], dz = row[1], dy = row[2], dx = row[3];
    if (t < 0 || t > n_taps || t == center || iabs(dz) > 2 || iabs(dy) > 2 ||
        iabs(dx) > 2 || (dz == 0 && dy == 0 && dx == 0) || (ndim == 2 && dz != 0)) {
      return false;
    }
    for (int j = 0; j < kVec; ++j) {
      if (row[4 + j] != ring_offset(dy, dx, j)) return false;
      p->off[k][j] = static_cast<short>(row[4 + j]);
    }
    p->poff[k] = t * plane_elems;
    p->dz[k] = static_cast<signed char>(dz);
    rz_ = iabs(dz) > rz_ ? iabs(dz) : rz_;
    ryx = iabs(dy) > ryx ? iabs(dy) : ryx;
    ryx = iabs(dx) > ryx ? iabs(dx) : ryx;
  }
  p->n = static_cast<int>(n_taps);
  p->diag = center * plane_elems;
  // a 3D operator's ring takes its radius on every axis (the solves' layouts
  // reach it on all three); 2D: no z
  *r = ndim == 3 && rz_ > ryx ? rz_ : ryx;
  *rz = ndim == 3 ? *r : 0;
  for (int64_t k = 0; k < n_taps; ++k) p->dz[k] = static_cast<signed char>(p->dz[k] + *rz);
  return true;
}

// ---------------------------------------------------------------------------
// the contraction and its launcher
// ---------------------------------------------------------------------------

// The plan's taps in order, NT of them compiled in (0: the generic loop over
// plan.n).  Blocks an SM must hold (the register cap): two for the compiled
// forms (up to 128 registers a thread keep the plane loads of many taps in
// flight), three for the 26-tap form, which measured 41-65% of its bound at
// 128 registers and 84-89% at 80 (PERF.md), and for float64.
template <typename T, int NT>
struct Taps {
  using A = typename Compute<T>::type;
  static constexpr int min_blocks(bool) { return sizeof(T) == 8 || NT == 26 ? 3 : 2; }
  // the taps' planes load in the tap loop, many in flight at once
  template <bool kV>
  struct Frag {};
  Plan plan;

  __device__ __forceinline__ int64_t diag() const { return plan.diag; }

  template <bool kV>
  __device__ __forceinline__ Frag<kV> fetch(const T*, const bool (&)[kVec],
                                            const tile::Where&) const {
    return {};
  }

  template <bool kV, bool kRes, int P, int NC, typename XR>
  __device__ __forceinline__ void contract(A (&acc)[NC], const Frag<kV>&, const T* pb,
                                           const bool (&iok)[kVec], XR&& xr) const {
    auto tap = [&](int k, bool first) {
      const A* rp = xr(plan.dz[k]);
      A pv[kVec];
      tile::load4<T, kV, true>(pb + plan.poff[k], iok, pv);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = kRes ? c : P + 2 * c;
        const A prod = mul_rn(pv[j], rp[plan.off[k][j]]);
        acc[c] = first ? prod : add_rn(acc[c], prod);
      }
    };
    if constexpr (NT > 0) {
#pragma unroll
      for (int k = 0; k < NT; ++k) tap(k, k == 0);
    } else {
      tap(0, true);
#pragma unroll 4
      for (int k = 1; k < plan.n; ++k) tap(k, false);
    }
  }
};

template <typename T, int RZ, int R, bool kRes, int NT, bool kV>
int launch_form(const T* planes, const T* x, const T* b, T* out, int64_t nz,
                int64_t ny, int64_t nx, const Plan& plan, int color,
                cudaStream_t stream) {
  return tile::launch_form<T, RZ, R, kRes, kV>(
      planes, x, b, out, nz, ny, nx, tile::run_planes(nz, ny, nx, tile::tile_y<T>()),
      Taps<T, NT>{plan}, color, stream);
}

template <typename T, int RZ, int R, bool kRes, int... kNT>
int launch_taps(const T* planes, const T* x, const T* b, T* out, int64_t nz,
                int64_t ny, int64_t nx, const Plan& plan, int color,
                cudaStream_t stream) {
  if (tile::vector_rows(nx, planes, x, b, out)) {
    // the compiled tap count that matches (float32 and bf16, the solves'
    // storage; float64 takes the loop), else the generic loop
    int err = -1;
    if constexpr (sizeof(T) != 8) {
      ((err = err < 0 && plan.n == kNT
                  ? launch_form<T, RZ, R, kRes, kNT, true>(planes, x, b, out, nz, ny,
                                                            nx, plan, color, stream)
                  : err),
       ...);
    }
    if (err >= 0) return err;
    return launch_form<T, RZ, R, kRes, 0, true>(planes, x, b, out, nz, ny, nx, plan,
                                                color, stream);
  }
  return launch_form<T, RZ, R, kRes, 0, false>(planes, x, b, out, nz, ny, nx, plan,
                                               color, stream);
}

}  // namespace stored
}  // namespace mad
