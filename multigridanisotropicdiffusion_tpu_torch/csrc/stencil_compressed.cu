// Red-black Gauss-Seidel half-sweep and residual on the 3D compressed DCA
// operator, whole-domain (B1, B2) and shard-local (B14), and the whole
// sweep, red then black, in one launch (B17, `mad_stencil_sweep_*`).
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
//
// The fused sweep (B17, rbgs_sweep_kernel below) replaces the pair of
// half-sweep launches of the Pallas `pallas_rbgs_sweep` (the same site, two
// calls).  Two half-sweeps move each cell's 10 planes, b and x twice (104 B
// a cell in f32); the fused sweep reads the planes and b once, plus the
// halo rows and end planes of its tiles, so a 512^3 sweep moves ~1.25x one
// pass.  Measured (H100, 700 W; chip_smoke.py): 2.99 [1.80] ms against 4.56
// [2.33] ms for the two launches, one-pass bound 2.08 [1.04] ms.
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
    const A* ring[3] = {xr(0), xr(1), xr(2)};  // planes z - 1, z, z + 1
    A cf[9][kVec];
#pragma unroll
    for (int p = 0; p < 9; ++p) mad::tile::unpack4<T, kV>(frag.p[p], cf[p]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = kRes ? c : P + 2 * c;
      acc[c] = offdiag([&](int p) { return cf[p][j]; },
                       [&](int dz, int dy, int dx) {
                         return ring[dz + 1][ring_offset(dy, dx, j)];
                       });
    }
  }

  // One cell's sum: cf(p) its coefficient of plane p, X(dz, dy, dx) its
  // neighbour x[z + dz, y + dy, x + dx].  The half-sweeps, the residual and
  // the fused sweep all sum here, in offdiag_apply's order.
  template <typename CF, typename XF>
  static __device__ __forceinline__ A offdiag(const CF& cf, const XF& X) {
    using mad::add_rn;
    using mad::mul_rn;
    using mad::sub_rn;
    auto face = [&](int p, A xp, A xm) { return add_rn(mul_rn(cf(p), xp), mul_rn(cf(p + 1), xm)); };
    auto mixed = [&](int p, A pp, A pm, A mp, A mm) {
      return mul_rn(cf(p), add_rn(sub_rn(sub_rn(pp, pm), mp), mm));
    };
    A off = face(0, X(1, 0, 0), X(-1, 0, 0));
    off = add_rn(off, face(2, X(0, 1, 0), X(0, -1, 0)));
    off = add_rn(off, face(4, X(0, 0, 1), X(0, 0, -1)));
    off = add_rn(off, mixed(6, X(1, 1, 0), X(1, -1, 0), X(-1, 1, 0), X(-1, -1, 0)));
    off = add_rn(off, mixed(7, X(1, 0, 1), X(1, 0, -1), X(-1, 0, 1), X(-1, 0, -1)));
    off = add_rn(off, mixed(8, X(0, 1, 1), X(0, 1, -1), X(0, -1, 1), X(0, -1, -1)));
    return off;
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

// ---------------------------------------------------------------------------
// the fused sweep: red, then black, in one pass over the planes
// ---------------------------------------------------------------------------

// v rounded to the storage type and widened again: what a second launch
// reads of the first one's output
template <typename T>
__device__ __forceinline__ typename mad::Compute<T>::type as_stored(
    typename mad::Compute<T>::type v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

// Warps of a block: TY + 2 red warps (rows -1 .. TY of the tile), TY black
// warps (rows 0 .. TY - 1) and one for the halo columns.
template <typename T>
__host__ __device__ constexpr int sweep_warps() {
  return 2 * mad::tile::tile_y<T>() + 3;
}

// Shared memory of a block, in compute-type values: 4 slots of old x
// (TY + 4 rows, 2 halo columns a side) and 4 of the post-red field (TY + 2
// rows, 1 halo column a side), in the tile march's row layout; 3 planes of
// the black cells' 11 values (2 cells a lane of each row).
template <typename T>
__host__ __device__ constexpr size_t sweep_smem_bytes() {
  constexpr int TY = mad::tile::tile_y<T>();
  return static_cast<size_t>((4 * (TY + 4) + 4 * (TY + 2)) * mad::tile::kRow +
                             3 * 22 * 32 * TY) *
         sizeof(typename mad::Compute<T>::type);
}

// One red-black sweep, out of place (x is only read):
//   red cells   out = (b - off(x)) / diag
//   black cells out = (b - off(x')) / diag, x' the post-red field (red cells
//                     new, rounded to the storage type; black cells old)
// which is the two half-sweep launches' output, bit for bit.
//
// A block owns TY rows x 128 columns (stencil_tile.cuh's tile) and marches
// down its run of planes [z0, z1), one barrier a step.  At step k:
// * red warp r + 1 computes red on plane k, row r = -1 .. TY, from a ring of
//   old x (planes k - 1 .. k + 1, staged as the tile march stages it) and
//   writes the row's post-red values to a ring of 4 planes; it loads the
//   row's 10 planes and b once, as vectors, issued before the barrier, and
//   puts the black cells' 11 values in a ring of 3 planes for the black
//   warp of the row;
// * the halo warp computes the red one of columns -1 and 128 of each row
//   (one lane a row, scalar loads; the neighbouring tiles' cells) and
//   copies old x into the other halo cells;
// * black warp r computes black on plane k - 2, row r = 0 .. TY - 1, from
//   the post-red planes k - 3 .. k - 1 and the kept values alone, and stores
//   the row of plane k - 2.
// Red covers planes z0 - 1 .. z1 (black on z0 and z1 - 1 needs them), so a
// block reads (TY + 2) / TY of its rows and (zrun + 2) / zrun of its planes
// once; every plane and b value of a tile row is loaded once.  Red and black
// have their own warps so that each warp's dependent chain a step is one
// contraction pair, and each has one body per row parity.
template <typename T, bool kV>
__global__ void __launch_bounds__(32 * sweep_warps<T>(), 1)
    rbgs_sweep_kernel(const T* __restrict__ planes, const T* __restrict__ x,
                      const T* __restrict__ b, T* __restrict__ out, int64_t nz, int64_t ny,
                      int64_t nx, int zrun) {
  using A = typename mad::Compute<T>::type;
  using mad::div_rn;
  using mad::sub_rn;
  using mad::tile::kPhase;
  using mad::tile::kRow;
  using mad::tile::kTileX;
  using Raw = mad::tile::Raw4<T, kV>;
  constexpr int TY = mad::tile::tile_y<T>();
  constexpr int OROWS = TY + 4;  // old x: rows -2 .. TY + 1 of the tile
  constexpr int OSLOT = OROWS * kRow;
  constexpr int PSLOT = (TY + 2) * kRow;  // post-red: rows -1 .. TY
  constexpr int KSLOT = 22 * 32 * TY;     // kept values of a plane
  constexpr int HALO = 2 * TY + 2;        // the halo warp
  static_assert(2 * TY + 4 <= 32, "the halo warp's lanes cover the halo columns");
  static_assert(OROWS <= sweep_warps<T>(), "a warp stages one row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* const old = reinterpret_cast<A*>(smem_raw);
  A* const red = old + 4 * OSLOT;
  A* const kept = red + 4 * PSLOT;

  const int l = threadIdx.x;
  const int w = threadIdx.y;
  const int64_t x0 = static_cast<int64_t>(blockIdx.x) * kTileX;
  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * TY;
  const int64_t z0 = static_cast<int64_t>(blockIdx.z) * zrun;
  const int64_t z1 = mad::imin(z0 + zrun, nz);
  const int64_t n = nz * ny * nx;
  const int64_t gxi = x0 + kVec * l;
  bool iok[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) iok[j] = gxi + j < nx;

  // --- staging of old x: warp w < TY + 4 stages row w - 2, each lane 4
  // interior columns and, for l < 4, one of the 2 halo columns a side
  A sv[kVec];
  A sh;
  const int64_t gxh = l < 2 ? x0 - 2 + l : x0 + kTileX + l - 2;
  const bool hok = l < 4 && gxh >= 0 && gxh < nx;
  auto stage_load = [&](int64_t zz) {
    const int64_t sy = y0 - 2 + w;
    const bool rok = w < OROWS && zz >= 0 && zz < nz && sy >= 0 && sy < ny;
    const T* row = x + (rok ? (zz * ny + sy) * nx : 0);
    bool ok[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) ok[j] = rok && iok[j];
    if (kV) {
      if (ok[0]) {
        mad::tile::load4<T, true, false>(row + gxi, ok, sv);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) sv[j] = 0;
      }
    } else {
      mad::tile::load4<T, false, false>(row + gxi, ok, sv);
    }
    sh = rok && hok ? mad::load(row + gxh) : A(0);
  };
  auto stage_store = [&](int slot) {
    if (w >= OROWS) return;
    A* row = old + slot * OSLOT + w * kRow;
#pragma unroll
    for (int j = 0; j < kVec; ++j) row[j * kPhase + l + 1] = sv[j];
    if (l < 4) {
      const int q = l < 2 ? kVec - 2 + l : kVec + kTileX + l - 2;
      row[(q & 3) * kPhase + (q >> 2)] = sh;
    }
  };

  // --- this warp's row: red warps rows -1 .. TY, black warps 0 .. TY - 1;
  // the lane's bases in the rings and its kept values' slot
  const bool is_red = w < TY + 2;
  const bool is_black = !is_red && w < HALO;
  const int row = is_red ? w - 1 : (is_black ? w - TY - 2 : 0);
  const int64_t gy = y0 + row;
  const bool row_ok = gy >= 0 && gy < ny && gxi < nx;
  const int obase = (row + 2) * kRow + l;
  const int pbase = (row + 1) * kRow + l;
  const int kbase = row * 32 + l;  // + (2 p + c) * 32 TY: value p of cell c

  // the halo warp's lane: the red halo cell of row l (l < TY), the other
  // halo cell of row l - TY, or a corner (rows -1 and TY); in column -1 or
  // in column 128, at position q of a ring row (3 or 132)
  const int hr = l < 2 * TY ? l % TY : (l - 2 * TY < 2 ? -1 : TY);
  const int64_t hy = y0 + hr;
  auto hleft = [&](int64_t kk) {
    const bool left_red = ((kk + hy + x0 - 1) & 1) == 0;  // column -1 is red
    return l < TY ? left_red : (l < 2 * TY ? !left_red : ((l - 2 * TY) & 1) == 0);
  };
  auto hlive = [&](int64_t kk) {
    const int64_t hx = hleft(kk) ? x0 - 1 : x0 + kTileX;
    return w == HALO && l < TY && kk >= 0 && kk < nz && hy < ny && hx >= 0 && hx < nx;
  };

  // a red warp's 11 vectors of plane kk (its 10 planes and b) where its row
  // and the plane lie in the grid: plain loads, not evict-first, as the
  // neighbouring tiles read these rows again as their halo rows.  Issued
  // before each step's barrier (a step further ahead, they spill)
  auto fetch = [&](int64_t kk, Raw (&g)[11]) {
    if (!is_red || !row_ok || kk < 0 || kk >= nz) return;
    const int64_t c = (kk * ny + gy) * nx + gxi;
#pragma unroll
    for (int p = 0; p < 10; ++p) g[p] = mad::tile::fetch4<T, kV, false>(planes + c + p * n, iok);
    g[10] = mad::tile::fetch4<T, kV, false>(b + c, iok);
  };

  stage_load(z0 - 2);
  stage_store(0);
  stage_load(z0 - 1);
  stage_store(1);
  stage_load(z0);
  int so = 0;  // old x: slot of plane k - 1
  int sp = 0;  // post-red: slot of plane k
  int sk = 0;  // kept values: slot of plane k
  for (int64_t k = z0 - 1; k <= z1 + 1; ++k) {
    const bool live = k <= z1 && row_ok && k >= 0 && k < nz;
    Raw f[11];  // red: plane k's vectors
    if (k <= z1) fetch(k, f);
    // the halo warp's red cell, in flight across the barrier
    A hv[11];
    if (k <= z1 && hlive(k)) {
      const int64_t h0 = (k * ny + hy) * nx + (hleft(k) ? x0 - 1 : x0 + kTileX);
#pragma unroll
      for (int p = 0; p < 10; ++p) hv[p] = mad::load(planes + h0 + p * n);
      hv[10] = mad::load(b + h0);
    }
    if (k <= z1) stage_store((so + 2) & 3);
    __syncthreads();
    if (k < z1) stage_load(k + 2);

    if (is_red && k <= z1) {
      // red on plane k: the lane's cells P and P + 2
      const A* om = old + so * OSLOT + obase;              // old x, plane k - 1
      const A* o0 = old + ((so + 1) & 3) * OSLOT + obase;  // plane k
      const A* op = old + ((so + 2) & 3) * OSLOT + obase;  // plane k + 1
      A* pk = red + sp * PSLOT + pbase;
      A* kk = kept + sk * KSLOT + kbase;
      auto body = [&](auto parity) {
        constexpr int P = decltype(parity)::value;
        A o[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) o[j] = o0[ring_offset(0, 0, j)];
        if (live) {
          A cf[11][kVec];
#pragma unroll
          for (int p = 0; p < 11; ++p) mad::tile::unpack4<T, kV>(f[p], cf[p]);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = P + 2 * c;
            const A off = Compressed<T, false>::offdiag(
                [&](int p) { return cf[p][j]; },
                [&](int dz, int dy, int dx) {
                  const A* s = dz < 0 ? om : (dz > 0 ? op : o0);
                  return s[ring_offset(dy, dx, j)];
                });
            if (iok[j]) o[j] = as_stored<T>(div_rn(sub_rn(cf[10][j], off), cf[9][j]));
          }
          // the black cells' values, for the black warp of this row
          if (row >= 0 && row < TY) {
#pragma unroll
            for (int p = 0; p < 11; ++p) {
#pragma unroll
              for (int c = 0; c < 2; ++c) kk[(2 * p + c) * 32 * TY] = cf[p][1 - P + 2 * c];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) pk[ring_offset(0, 0, j)] = o[j];
      };
      if (((k + gy) & 1) == 0) {
        body(std::integral_constant<int, 0>{});
      } else {
        body(std::integral_constant<int, 1>{});
      }
    } else if (is_black && k >= z0 + 2 && row_ok) {
      // black on plane kb = k - 2: the lane's cells P and P + 2
      const int64_t kb = k - 2;
      const A* q[3] = {red + ((sp + 1) & 3) * PSLOT + pbase,  // post-red, kb - 1
                       red + ((sp + 2) & 3) * PSLOT + pbase,           // kb
                       red + ((sp + 3) & 3) * PSLOT + pbase};          // kb + 1
      const A* kk = kept + (sk == 0 ? 1 : (sk == 1 ? 2 : 0)) * KSLOT + kbase;  // plane kb
      auto body = [&](auto parity) {
        constexpr int P = decltype(parity)::value;
        A ob[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) ob[j] = q[1][ring_offset(0, 0, j)];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = P + 2 * c;
          const A off = Compressed<T, false>::offdiag(
              [&](int p) { return kk[(2 * p + c) * 32 * TY]; },
              [&](int dz, int dy, int dx) { return q[dz + 1][ring_offset(dy, dx, j)]; });
          ob[j] = div_rn(sub_rn(kk[(20 + c) * 32 * TY], off), kk[(18 + c) * 32 * TY]);
        }
        mad::tile::store4<T, kV>(out + (kb * ny + gy) * nx + gxi, iok, ob);
      };
      if (((kb + gy + 1) & 1) == 0) {
        body(std::integral_constant<int, 0>{});
      } else {
        body(std::integral_constant<int, 1>{});
      }
    } else if (w == HALO && k <= z1 && l < 2 * TY + 4) {
      // plane k's halo cells of the post-red rows
      const int hq = hleft(k) ? kVec - 1 : kVec + kTileX;
      auto at = [&](const A* slot, int dy, int dx) {
        const int qq = hq + dx;
        return slot[(hr + 2 + dy) * kRow + (qq & 3) * kPhase + (qq >> 2)];
      };
      const A* s0 = old + ((so + 1) & 3) * OSLOT;
      A v = at(s0, 0, 0);
      if (hlive(k)) {
        const A* sm = old + so * OSLOT;
        const A* s1 = old + ((so + 2) & 3) * OSLOT;
        const A off = Compressed<T, false>::offdiag(
            [&](int p) { return hv[p]; },
            [&](int dz, int dy, int dx) { return at(dz < 0 ? sm : (dz > 0 ? s1 : s0), dy, dx); });
        v = as_stored<T>(div_rn(sub_rn(hv[10], off), hv[9]));
      }
      red[sp * PSLOT + (hr + 1) * kRow + (hq & 3) * kPhase + (hq >> 2)] = v;
    }
    so = (so + 1) & 3;
    sp = (sp + 1) & 3;
    sk = sk == 2 ? 0 : sk + 1;
  }
}

template <typename T>
int launch_sweep(const void* planes, const void* x, const void* b, void* out, int64_t nz,
                 int64_t ny, int64_t nx, int64_t zrun, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* p = static_cast<const T*>(planes);
  const T* xv = static_cast<const T*>(x);
  const T* bv = static_cast<const T*>(b);
  T* o = static_cast<T*>(out);
  constexpr int TY = mad::tile::tile_y<T>();
  constexpr size_t smem = sweep_smem_bytes<T>();
  auto kern = mad::tile::vector_rows(nx, p, xv, bv, o) ? rbgs_sweep_kernel<T, true>
                                                        : rbgs_sweep_kernel<T, false>;
  if (zrun < 1 || zrun > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int64_t gx = (nx + mad::tile::kTileX - 1) / mad::tile::kTileX;
  const int64_t gy = (ny + TY - 1) / TY;
  const int64_t gz = (nz + zrun - 1) / zrun;
  if (gy > mad::tile::kMaxGrid || gz > mad::tile::kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  kern<<<grid, dim3(32, sweep_warps<T>()), smem, static_cast<cudaStream_t>(stream)>>>(
      p, xv, bv, o, nz, ny, nx, static_cast<int>(zrun));
  return static_cast<int>(cudaGetLastError());
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
  }                                                                                 \
  extern "C" int mad_stencil_sweep_##SUF(                                           \
      const void* planes, const void* x, const void* b, void* out, int64_t nz,      \
      int64_t ny, int64_t nx, int64_t zrun, void* stream) {                         \
    return launch_sweep<T>(planes, x, b, out, nz, ny, nx, zrun, stream);            \
  }

MAD_FOR_EACH_TYPE(MAD_STENCIL_ENTRY)

extern "C" const char* mad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
