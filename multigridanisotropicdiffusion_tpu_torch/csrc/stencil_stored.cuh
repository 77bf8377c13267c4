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
// The host plan (ops/cuda_stencil_stored.py `tap_plan`, cached per offset
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
// Design, against what held the one-thread-per-cell kernel back (idle
// off-colour lanes, many instructions and few loads in flight per tap, x
// re-read through L1/L2, bf16 paying f32's instruction count, FMA
// contraction):
// * x is staged once: a block owns 8 rows (float64: 4) x 128 columns and marches
//   down a run of z planes, keeping a ring of 2 RZ + 2 planes of x, each
//   with an R-wide halo, in shared memory (float for bf16).  Each step
//   stores the plane loaded during the last one, syncs once, loads the next
//   into registers and computes a plane.  Cells outside the grid are staged
//   as 0, the plain version's zero padding: no border tests, and a term
//   across the border is coeff * 0 as there.
// * every lane works: a lane owns 4 consecutive cells of a row; a half-sweep
//   contracts its 2 on-colour cells (the row's parity is warp-uniform, and
//   each parity has its own unrolled body) and copies the other 2 from the
//   ring.  Ring rows keep the 4 column phases (column mod 4) apart, so a
//   warp's neighbour reads are 32 consecutive words whatever the offset.
// * the planes stream as one 16-byte (f32, f64: two) or 8-byte (bf16)
//   vector per lane and tap, evict-first, so they do not push x's halo rows
//   out of L2; rows of a width that is not a multiple of 4 take scalar
//   loads in the generic form.
// * the loop is unrolled over the compiled tap count with the plan's
//   entries as parameter operands, so the plane loads of many taps are in
//   flight at once; each tap's ring slot, ring offsets and plane address are
//   warp-uniform work beside one plane load and 4 (half-sweep: 2) ring
//   reads, products and sums.
// * bf16 moves half the bytes of f32 for the same instructions per tap, and
//   every product and sum rounds on its own, as the plain versions do.
// What it measured: stencil_stored.cu (3D) and stencil_2d.cu (2D).
#pragma once

#include <type_traits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace mad {
namespace stored {

constexpr int kTileX = 128;  // columns per block
constexpr int kVec = 4;      // consecutive cells per lane
constexpr int kPhase = 34;   // ring values per column phase and row
constexpr int kRow = kVec * kPhase;
constexpr int kMaxTaps = 124;  // 125 planes, the centre apart
constexpr int kPlanCols = 8;   // host plan row: t, dz, dy, dx, offset per cell
constexpr int kTargetBlocks = 2048;

template <typename T>
__host__ __device__ constexpr int tile_y() {
  return sizeof(T) == 8 ? 4 : 8;
}

// The plan as the kernel takes it, by value: tap k reads plane poff[k]
// (elements from plane 0) and, for cell j of its lane, the ring value
// off[k][j] from the lane's centre in the ring slot of plane z + dz[k] - RZ.
struct Plan {
  int64_t poff[kMaxTaps];
  short off[kMaxTaps][kVec];
  signed char dz[kMaxTaps];
  int n;
  int64_t diag;
};

// Ring offset of the neighbour (dy, dx) of cell j (column 4 l + j of the
// tile, stored at phase j, index l + 1): the column q = 4 (l + 1) + j + dx
// of row dy lies at phase q mod 4, index q / 4.
inline int ring_offset(int dy, int dx, int j) {
  const int q = j + dx;
  return dy * kRow + (q & 3) * kPhase + 1 + (q >> 2);
}

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
// loads and stores of a lane's 4 cells
// ---------------------------------------------------------------------------

// One value or vector at p: streaming (evict-first) with kCS, else a plain
// load (x: neighbouring blocks re-read its halo rows from L2).
template <bool kCS, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kCS) {
    return __ldcs(p);
  } else {
    return *p;
  }
}

template <bool kCS>
__device__ __forceinline__ float ld1(const float* p) { return ld<kCS>(p); }
template <bool kCS>
__device__ __forceinline__ double ld1(const double* p) { return ld<kCS>(p); }
template <bool kCS>
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(ld<kCS>(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// v[j] = p[j]: one vector (kV, p aligned to 4 cells), else the cells j with
// ok[j] one by one (the others 0).
template <typename T, bool kV, bool kCS>
__device__ __forceinline__ void load4(const T* p, const bool (&ok)[kVec],
                                      typename Compute<T>::type (&v)[kVec]) {
  if constexpr (!kV) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = ok[j] ? ld1<kCS>(p + j) : 0;
  } else if constexpr (sizeof(T) == 2) {
    const uint2 t = ld<kCS>(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (sizeof(T) == 4) {
    const float4 t = ld<kCS>(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const double2 a = ld<kCS>(reinterpret_cast<const double2*>(p));
    const double2 b = ld<kCS>(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

template <typename T, bool kV>
__device__ __forceinline__ void store4(T* p, const bool (&ok)[kVec],
                                       const typename Compute<T>::type (&v)[kVec]) {
  if constexpr (!kV) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (ok[j]) store(p + j, v[j]);
    }
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
}

template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int rz, int r) {
  return static_cast<size_t>(2 * rz + 2) * (tile_y<T>() + 2 * r) * kRow *
         sizeof(typename Compute<T>::type);
}

// Blocks an SM must hold (the register cap): two for the compiled forms
// (up to 128 registers a thread keep the plane loads of many taps in
// flight), three for the 26-tap form, which measured 41-65% of its bound at
// 128 registers and 84-89% at 80 (PERF.md), and for float64.
template <typename T, int NT>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 8 || NT == 26 ? 3 : 2;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// RZ, R: the z and the y/x radius of the ring (2D: RZ = 0).  NT: the
// compiled tap count, 0 for the generic loop over plan.n.  kV: rows of whole
// 4-cell vectors (nx % 4 == 0, aligned pointers).
template <typename T, int RZ, int R, bool kRes, int NT, bool kV>
__global__ void __launch_bounds__(32 * tile_y<T>(), min_blocks<T, NT>())
    stored_kernel(const T* __restrict__ planes, const T* __restrict__ x,
                  const T* __restrict__ b, T* __restrict__ out, int64_t nz,
                  int64_t ny, int64_t nx, int zrun, const __grid_constant__ Plan plan,
                  int color) {
  using A = typename Compute<T>::type;
  constexpr int TY = tile_y<T>();
  constexpr int ROWS = TY + 2 * R;
  constexpr int S = 2 * RZ + 2;
  constexpr int SLOT = ROWS * kRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* ring = reinterpret_cast<A*>(smem_raw);

  const int l = threadIdx.x;
  const int w = threadIdx.y;
  const int64_t x0 = static_cast<int64_t>(blockIdx.x) * kTileX;
  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * TY;
  const int64_t z0 = static_cast<int64_t>(blockIdx.z) * zrun;
  const int64_t z1 = imin(z0 + zrun, nz);

  // --- staging: warp w stages rows w and w + TY of the tile (the latter for
  // w < 2R), each lane 4 interior columns and, for l < 2R, one halo column
  A sv[2][kVec];
  A sh[2];
  const int64_t gxi = x0 + kVec * l;
  const int64_t gxh = l < R ? x0 - R + l : x0 + kTileX + l - R;
  const bool hok = l < 2 * R && gxh >= 0 && gxh < nx;
  bool iok[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) iok[j] = gxi + j < nx;
  auto stage_load = [&](int64_t zz) {
    const bool zok = zz >= 0 && zz < nz;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = w + rr * TY;
      const int64_t gy = y0 - R + r;
      const bool rok = zok && (rr == 0 || r < ROWS) && gy >= 0 && gy < ny;
      const T* row = x + (rok ? (zz * ny + gy) * nx : 0);
      bool ok[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) ok[j] = rok && iok[j];
      if (kV) {
        if (ok[0]) {
          load4<T, true, false>(row + gxi, ok, sv[rr]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) sv[rr][j] = 0;
        }
      } else {
        load4<T, false, false>(row + gxi, ok, sv[rr]);
      }
      sh[rr] = rok && hok ? load(row + gxh) : A(0);
    }
  };
  auto stage_store = [&](int slot) {
    A* base = ring + slot * SLOT;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = w + rr * TY;
      if (rr == 1 && r >= ROWS) break;
      A* row = base + r * kRow;
#pragma unroll
      for (int j = 0; j < kVec; ++j) row[j * kPhase + l + 1] = sv[rr][j];
      if (l < 2 * R) {
        const int q = l < R ? kVec - R + l : kVec + kTileX + l - R;
        row[(q & 3) * kPhase + (q >> 2)] = sh[rr];
      }
    }
  };

  // --- one plane's cells: contract the taps, finish, store
  const int64_t gy = y0 + w;
  const bool row_ok = gy < ny && gxi < nx;
  const int tbase = (w + R) * kRow + l + 1;
  auto compute = [&](int64_t z, int ib) {
    const int64_t c0 = (z * ny + gy) * nx + gxi;
    const T* pb = planes + c0;
    const A* xc = ring + (ib + RZ < S ? ib + RZ : ib + RZ - S) * SLOT + tbase;
    A xv[kVec], bv[kVec], dv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) xv[j] = xc[j * kPhase];
    load4<T, kV, true>(b + c0, iok, bv);
    load4<T, kV, true>(pb + plan.diag, iok, dv);
    // the lane's contracted cells: all 4, or the 2 of the colour (P = the
    // first of them); each parity its own unrolled body
    auto body = [&](auto parity) {
      constexpr int P = decltype(parity)::value;
      constexpr int NC = kRes ? kVec : kVec / 2;
      A acc[NC] = {};
      auto tap = [&](int k, bool first) {
        int s = ib + plan.dz[k];
        s = s >= S ? s - S : s;
        const A* rp = ring + s * SLOT + tbase - 1;
        A pv[kVec];
        load4<T, kV, true>(pb + plan.poff[k], iok, pv);
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
      A o[kVec];
      if constexpr (kRes) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) o[j] = sub_rn(sub_rn(bv[j], mul_rn(dv[j], xv[j])), acc[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) o[j] = xv[j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int j = P + 2 * c;
          o[j] = div_rn(sub_rn(bv[j], acc[c]), dv[j]);
        }
      }
      store4<T, kV>(out + c0, iok, o);
    };
    if (kRes || ((color + z + gy) & 1) == 0) {
      body(std::integral_constant<int, 0>{});
    } else {
      body(std::integral_constant<int, 1>{});
    }
  };

  // --- the run: the ring holds plane zz in slot (zz - z0 + RZ) mod S
  for (int s = 0; s < 2 * RZ; ++s) {
    stage_load(z0 - RZ + s);
    stage_store(s);
  }
  stage_load(z0 + RZ);
  int ib = 0;  // slot of plane z - RZ
  for (int64_t z = z0; z < z1; ++z) {
    stage_store(ib + 2 * RZ < S ? ib + 2 * RZ : ib + 2 * RZ - S);
    __syncthreads();
    if (z + 1 < z1) stage_load(z + 1 + RZ);
    if (row_ok) compute(z, ib);
    ib = ib + 1 == S ? 0 : ib + 1;
  }
}

// ---------------------------------------------------------------------------
// the launcher
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int RZ, int R, bool kRes, int NT, bool kV>
int launch_form(const T* planes, const T* x, const T* b, T* out, int64_t nz,
                int64_t ny, int64_t nx, const Plan& plan, int color,
                cudaStream_t stream) {
  constexpr int TY = tile_y<T>();
  constexpr size_t smem = ring_bytes<T>(RZ, R);
  auto kern = stored_kernel<T, RZ, R, kRes, NT, kV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t gx = (nx + kTileX - 1) / kTileX;
  const int64_t gy = (ny + TY - 1) / TY;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // runs of at least 4 planes (the ring's warm-up), about kTargetBlocks
  // blocks in all
  int64_t zrun = (nz * gx * gy + kTargetBlocks - 1) / kTargetBlocks;
  zrun = zrun < 4 ? 4 : (zrun > 64 ? 64 : zrun);
  if ((nz + zrun - 1) / zrun > 65535) zrun = (nz + 65534) / 65535;
  zrun = zrun < nz ? zrun : nz;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>((nz + zrun - 1) / zrun));
  kern<<<grid, dim3(32, TY), smem, stream>>>(planes, x, b, out, nz, ny, nx,
                                             static_cast<int>(zrun), plan, color);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RZ, int R, bool kRes, int... kNT>
int launch_taps(const T* planes, const T* x, const T* b, T* out, int64_t nz,
                int64_t ny, int64_t nx, const Plan& plan, int color,
                cudaStream_t stream) {
  const bool vec = nx % kVec == 0 && aligned16(planes) && aligned16(x) &&
                   aligned16(b) && aligned16(out);
  if (vec) {
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
