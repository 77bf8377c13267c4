// The tile march of the 3D and 2D stencil kernels: red-black Gauss-Seidel
// half-sweeps and the residual, generic over the contraction of a lane's
// cells.  Two contractions use it: the stored operator's tap plan (B12 and
// B13's stored form, stencil_stored.cuh) and the compressed DCA operator's
// 18-term contraction (B1/B2 and the shard-local B14, stencil_compressed.cu).
//
//   half-sweep:  out[p] = (z+y+x) % 2 == color ? (b[p] - off[p]) / diag[p] : x[p]
//   residual:    out[p] = (b[p] - diag[p] x[p]) - off[p]
//
// with off[p] the contraction's sum over the neighbours of p, x zero outside
// the grid.  Every product, sum and the division round on their own (no
// fused multiply-add), so a contraction that sums in its plain version's
// order gives that version's bytes; 16-bit storage computes in float and
// rounds once at the store.
//
// Bound on the card: device-memory bandwidth.  Each cell reads its planes,
// b and x and writes one value.
//
// Design, against what held the one-thread-per-cell kernels back (idle
// off-colour lanes, x re-read through L1/L2, scalar loads, bf16 paying f32's
// instruction count, FMA contraction):
// * x is staged once: a block owns 8 rows (float64: 4) x 128 columns and
//   marches down a run of z planes, keeping a ring of 2 RZ + 2 planes of x,
//   each with an R-wide halo, in shared memory (float for bf16).  Each step
//   stores the plane loaded during the last one, syncs once, loads the next
//   into registers and computes a plane.  Cells outside the grid are staged
//   as 0, the plain version's zero padding: no border tests, and a term
//   across the border is coeff * 0 as there.
// * every lane works: a lane owns 4 consecutive cells of a row; a half-sweep
//   contracts its 2 on-colour cells (the row's parity is warp-uniform, and
//   each parity has its own unrolled body) and copies the other 2 from the
//   ring.  Ring rows keep the 4 column phases (column mod 4) apart, so a
//   warp's neighbour reads are 32 consecutive words whatever the offset.
// * the planes and b stream as one 16-byte (f32, f64: two) or 8-byte (bf16)
//   vector per lane, evict-first, so they do not push x's halo rows out of
//   L2; out is written the same way; rows of a width that is not a multiple
//   of 4 take scalar loads.
// * the run length, and so the grid, is the launcher's: about kTargetBlocks
//   blocks in all, so the coarse levels fill the card too.  Element offsets
//   are 64-bit.
#pragma once

#include <type_traits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace mad {
namespace tile {

constexpr int kTileX = 128;  // columns per block
constexpr int kVec = 4;      // consecutive cells per lane
constexpr int kPhase = 34;   // ring values per column phase and row
constexpr int kRow = kVec * kPhase;
constexpr int kTargetBlocks = 2048;
constexpr int64_t kMaxGrid = 65535;  // blocks along y and along z

template <typename T>
__host__ __device__ constexpr int tile_y() {
  return sizeof(T) == 8 ? 4 : 8;
}

// Ring offset of the neighbour (dy, dx) of cell j (column 4 l + j of the
// tile, stored at phase j, index l + 1): the column q = 4 (l + 1) + j + dx
// of row dy lies at phase q mod 4, index q / 4.  Counted from the lane's
// base, index l of phase 0.
__host__ __device__ constexpr int ring_offset(int dy, int dx, int j) {
  return dy * kRow + ((j + dx) & 3) * kPhase + 1 + ((j + dx) >> 2);
}

// Where a lane's first cell lies, for contractions whose coefficients
// depend on it.
struct Where {
  int64_t z, y, x;
  int64_t nz, ny, nx;
};

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

// One lane's 4 values as loaded: one vector (kV), or, for rows that are
// not whole vectors, the values already widened.
template <typename T, bool kV>
struct Raw4 {
  typename Compute<T>::type v[kVec];
};
template <>
struct Raw4<__nv_bfloat16, true> {
  uint2 v;
};
template <>
struct Raw4<float, true> {
  float4 v;
};
template <>
struct Raw4<double, true> {
  double2 v[2];
};

// p[0..3]: one vector (kV, p aligned to 4 cells), else the cells j with
// ok[j] one by one (the others 0).
template <typename T, bool kV, bool kCS>
__device__ __forceinline__ Raw4<T, kV> fetch4(const T* p, const bool (&ok)[kVec]) {
  Raw4<T, kV> r;
  if constexpr (!kV) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) r.v[j] = ok[j] ? ld1<kCS>(p + j) : 0;
  } else if constexpr (sizeof(T) == 2) {
    r.v = ld<kCS>(reinterpret_cast<const uint2*>(p));
  } else if constexpr (sizeof(T) == 4) {
    r.v = ld<kCS>(reinterpret_cast<const float4*>(p));
  } else {
    r.v[0] = ld<kCS>(reinterpret_cast<const double2*>(p));
    r.v[1] = ld<kCS>(reinterpret_cast<const double2*>(p) + 1);
  }
  return r;
}

template <typename T, bool kV>
__device__ __forceinline__ void unpack4(const Raw4<T, kV>& r,
                                        typename Compute<T>::type (&v)[kVec]) {
  if constexpr (!kV) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = r.v[j];
  } else if constexpr (sizeof(T) == 2) {
    v[0] = __uint_as_float(r.v.x << 16);
    v[1] = __uint_as_float(r.v.x & 0xffff0000u);
    v[2] = __uint_as_float(r.v.y << 16);
    v[3] = __uint_as_float(r.v.y & 0xffff0000u);
  } else if constexpr (sizeof(T) == 4) {
    v[0] = r.v.x;
    v[1] = r.v.y;
    v[2] = r.v.z;
    v[3] = r.v.w;
  } else {
    v[0] = r.v[0].x;
    v[1] = r.v[0].y;
    v[2] = r.v[1].x;
    v[3] = r.v[1].y;
  }
}

// r[j] = +0 where !keep[j] (the plain versions' masked coefficient).
template <typename T, bool kV>
__device__ __forceinline__ void mask4(Raw4<T, kV>& r, const bool (&keep)[kVec]) {
  if constexpr (kV && sizeof(T) == 2) {
    r.v.x &= (keep[0] ? 0xffffu : 0u) | (keep[1] ? 0xffff0000u : 0u);
    r.v.y &= (keep[2] ? 0xffffu : 0u) | (keep[3] ? 0xffff0000u : 0u);
  } else if constexpr (kV && sizeof(T) == 4) {
    r.v.x = keep[0] ? r.v.x : 0.0f;
    r.v.y = keep[1] ? r.v.y : 0.0f;
    r.v.z = keep[2] ? r.v.z : 0.0f;
    r.v.w = keep[3] ? r.v.w : 0.0f;
  } else if constexpr (kV) {
    r.v[0].x = keep[0] ? r.v[0].x : 0.0;
    r.v[0].y = keep[1] ? r.v[0].y : 0.0;
    r.v[1].x = keep[2] ? r.v[1].x : 0.0;
    r.v[1].y = keep[3] ? r.v[1].y : 0.0;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) r.v[j] = keep[j] ? r.v[j] : 0;
  }
}

template <typename T, bool kV, bool kCS>
__device__ __forceinline__ void load4(const T* p, const bool (&ok)[kVec],
                                      typename Compute<T>::type (&v)[kVec]) {
  unpack4<T, kV>(fetch4<T, kV, kCS>(p, ok), v);
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

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// RZ, R: the z and the y/x radius of the ring (2D: RZ = 0).  kV: rows of
// whole 4-cell vectors (nx % 4 == 0, aligned pointers).  Op, the
// contraction, is passed by value and provides:
//   Op::min_blocks(kV)                blocks an SM must hold (register cap)
//   op.diag()                         the diagonal plane's element offset
//   op.fetch<kV>(pb, ok, where)       the lane's fragment: what it loads of
//                                     the planes at pb for its cells at
//                                     `where` before the contraction
//   op.contract<kV, kRes, P>(acc, frag, pb, ok, xr)
//                                     acc[c] = off of the lane's cell j =
//                                     kRes ? c : P + 2 c, from its fragment,
//                                     the planes at pb (+ each plane's
//                                     offset) and the ring: xr(s) is the
//                                     lane's base in the slot of plane
//                                     z + s - RZ, and the cell's neighbour
//                                     (dy, dx) lies ring_offset(dy, dx, j)
//                                     from it
template <typename T, int RZ, int R, bool kRes, bool kV, typename Op>
__global__ void __launch_bounds__(32 * tile_y<T>(), Op::min_blocks(kV))
    tile_kernel(const T* __restrict__ planes, const T* __restrict__ x,
                const T* __restrict__ b, T* __restrict__ out, int64_t nz, int64_t ny,
                int64_t nx, int zrun, const __grid_constant__ Op op, int color) {
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

  // --- one plane's cells: load, contract, finish, store
  const int64_t gy = y0 + w;
  const bool row_ok = gy < ny && gxi < nx;
  const int tbase = (w + R) * kRow + l;
  auto compute = [&](int64_t z, int ib) {
    const int64_t c0 = (z * ny + gy) * nx + gxi;
    const T* pb = planes + c0;
    const auto frag = op.template fetch<kV>(pb, iok, Where{z, gy, gxi, nz, ny, nx});
    const A* xc = ring + (ib + RZ < S ? ib + RZ : ib + RZ - S) * SLOT + tbase + 1;
    A xv[kVec], bv[kVec], dv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) xv[j] = xc[j * kPhase];
    load4<T, kV, true>(b + c0, iok, bv);
    load4<T, kV, true>(pb + op.diag(), iok, dv);
    // the lane's base in the ring slot of plane z + s - RZ
    auto xr = [&](int s) -> const A* {
      const int t = ib + s;
      return ring + (t >= S ? t - S : t) * SLOT + tbase;
    };
    // the lane's contracted cells: all 4, or the 2 of the colour (P = the
    // first of them); each parity its own unrolled body
    auto body = [&](auto parity) {
      constexpr int P = decltype(parity)::value;
      constexpr int NC = kRes ? kVec : kVec / 2;
      A acc[NC];
      op.template contract<kV, kRes, P>(acc, frag, pb, iok, xr);
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

// Whether rows of nx cells are whole 4-cell vectors at these pointers.
template <typename T>
bool vector_rows(int64_t nx, const T* planes, const T* x, const T* b, const T* out) {
  return nx % kVec == 0 && aligned16(planes) && aligned16(x) && aligned16(b) &&
         aligned16(out);
}

// Planes per block: runs of at least 4 planes (the ring's warm-up), about
// kTargetBlocks blocks in all, at most kMaxGrid runs.
inline int64_t run_planes(int64_t nz, int64_t ny, int64_t nx, int ty) {
  const int64_t tiles = (nx + kTileX - 1) / kTileX * ((ny + ty - 1) / ty);
  int64_t zrun = (nz * tiles + kTargetBlocks - 1) / kTargetBlocks;
  zrun = zrun < 4 ? 4 : (zrun > 64 ? 64 : zrun);
  if ((nz + zrun - 1) / zrun > kMaxGrid) zrun = (nz + kMaxGrid - 1) / kMaxGrid;
  return zrun < nz ? zrun : nz;
}

// Launch on a grid of 128-column tiles x tile_y rows x runs of zrun planes;
// cudaErrorInvalidConfiguration where that grid exceeds the launch limits.
template <typename T, int RZ, int R, bool kRes, bool kV, typename Op>
int launch_form(const T* planes, const T* x, const T* b, T* out, int64_t nz, int64_t ny,
                int64_t nx, int64_t zrun, const Op& op, int color, cudaStream_t stream) {
  constexpr int TY = tile_y<T>();
  constexpr size_t smem = ring_bytes<T>(RZ, R);
  auto kern = tile_kernel<T, RZ, R, kRes, kV, Op>;
  const int64_t gx = (nx + kTileX - 1) / kTileX;
  const int64_t gy = (ny + TY - 1) / TY;
  if (zrun < 1 || zrun > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int64_t gz = (nz + zrun - 1) / zrun;
  if (gy > kMaxGrid || gz > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  kern<<<grid, dim3(32, TY), smem, stream>>>(planes, x, b, out, nz, ny, nx,
                                             static_cast<int>(zrun), op, color);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
}  // namespace mad
