// B16: one Galerkin level's stored operator straight from the fine
// operator's planes, A_c = I - map(R (I - A_f) P), in 3D.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (ops/galerkin_direct.py's plane arithmetic, ops/galerkin.py's comb
// probing).  Their eager PyTorch versions launch thousands of operations a
// level and stack the fine planes by offset; this kernel reads the fine
// operator's planes as they are stored and writes nothing but the coarse
// planes.
//
// Spec (ops/cuda_galerkin.py; plain version `galerkin_product_plain`):
//   s_a[i]     = -c_a[i] off the centre, 1 - c_0[i] on it, c_a = sign *
//                plane p (the fine table: plane, negate, centre per a)
//   S[J, o]    = sum_a sum_i Gz[Jz, iz] Gy[Jy, iy] Gx[Jx, ix] s_a[i], G_d the
//                plan's pair-kernel table of (a_d, o_d): R P, folded by
//                component-wise clipping for the collapsed variant
//   A_c        = [o = 0] - S[J, o], on output plane out_map[o]
// Storage float32 or float64, computed in the storage type; fused
// multiply-adds, in the order below (not the eager path's), so the result
// agrees with it to rounding.
//
// Bound on the card: device-memory bandwidth: the fine planes read once,
// the coarse planes written once (level 1 of the 512^3 collapsed chain: 10
// planes of 512^3 in, 27 of 256^3 out, 7.2 GB in float32, 2.1 ms).  The
// arithmetic, sum-factorised, is about 2000 multiply-adds a coarse point
// at level 1 (~1 ms at the float32 rate).
//
// Design.  A block of 8 warps owns 32 coarse x (a lane each) by 7 coarse y
// (a warp each; the 8th joins the x stage only) and marches over a chunk of
// coarse z planes.  A step is one fine z plane and one a_z (on radius-2
// fine operators, a share of an a_z's (a_z, a_y) groups): its distinct fine
// planes, over the tile's 16 fine rows and 72 fine columns (the window's
// first column rounded down to a multiple of 4), are copied into one of two
// stages in shared memory by asynchronous copies (16 bytes a copy where the
// rows allow) while the step before is contracted.  x stage: each warp takes
// two fine rows; each lane reads its coarse x's 4 taps of each plane as
// three pairs (a warp's pairs are consecutive: no bank is read twice) and
// contracts them with its coarse x's table row into (a_y, o_x) sums, kept
// in shared memory.  After the step, y stage: each of 7 warps contracts its
// coarse y's 4 fine rows into (o_y, o_x); z stage: adds them, times the z
// table's weight, to the coarse planes the fine plane feeds (two at most,
// held in registers) and writes a coarse plane when its window ends.
// Blocks along grid z split the march into chunks and, for the exact
// variant, its five output z components into passes (25 outputs in
// registers each).
//
// The x and y tables' interior row is a kernel parameter; a tile that holds
// a border column, or a warp a border row, reads its rows whole from memory
// (so that a coupling that leaves the grid sums exact zeros, as the eager
// path's do).  Two fine operator forms, the ones the collapsed chain runs, have
// their offset tables compiled in: the compressed 19-point operator (level
// 0) and the stored 27-plane operator (every collapsed level), each on
// cell-centred y and x axes, whose interior rows are compiled in too.  There
// the x and y stages are straight-line code: each plane's 4 taps read once,
// the signs folded into the weights, a product per non-zero weight (22 of
// the 36 a 4-tap row holds); a border column's or row's weights are a
// small loop.  Other operators take the same march with the tables read at
// run time (the exact variant, vertex-centred axes).
//
// What it measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): level 1 of the
// 512^3 collapsed chain in 6.2 ms (a third of its bound's pace), the six
// levels in 9.0 ms, where the eager product took ~400 ms.  The loop body's
// size sets the pace more than its work, since the instruction cache close
// to the schedulers holds only part of it: compiling the border code out
// of the interior path halved the time; border weights that a warp's lanes
// loaded 144 bytes apart cost a third more; two blocks to an SM, a quarter.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTx = 32;                // coarse x per block: a lane each
constexpr int kTy = 7;                 // coarse y per block: a warp each (of 8)
constexpr int kWarps = 8;
constexpr int kThreads = kTx * kWarps;
constexpr int kRows = 2 * kTy + 2;     // fine rows a tile's restriction reaches
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kCols = 72;              // fine columns staged per row
constexpr int kAlign = 4;              // the staged window starts on a multiple of 4
constexpr int kTaps = 4;               // restriction taps per coarse index
constexpr int kMaxA = 5;               // fine offset components per axis
constexpr int kMaxO = 5;               // output components per axis
constexpr int kMaxSteps = kMaxA * kMaxA;
constexpr int kMaxSlots = 9;
static_assert(kRows % kWarps == 0, "x stage rows split evenly over the warps");
static_assert(kThreads % kRows == 0, "a row's copies split evenly over its threads");

// The fine operator forms: offset tables read at run time, or compiled in.
constexpr int kGeneric = 0;
constexpr int kCompressed19 = 1;  // ops.galerkin.plane_table of the compressed operator
constexpr int kStored27 = 2;      // 27 planes in stencil_offsets(3, 1, False) order

// Form f's code of fine offset (az, ay, ax) - 1: plane * 4 + bits (2:
// negate, 1: the centre's 1 +), -1 none.  The compressed operator's planes:
// fp_z, fm_z, fp_y, fm_y, fp_x, fm_x, m_zy, m_zx, m_yx, diag; a mixed
// offset s1 e_d + s2 e_d2 is s1 s2 times its plane.
__host__ __device__ constexpr int form_code(int f, int az, int ay, int ax) {
  const int z = az - 1, y = ay - 1, x = ax - 1;
  if (f == kStored27) return ((az * 3 + ay) * 3 + ax) * 4 + 2 + (z == 0 && y == 0 && x == 0);
  const int n = (z != 0) + (y != 0) + (x != 0);
  if (n == 0) return 9 * 4 + 2 + 1;
  if (n == 3) return -1;
  if (n == 1) {
    const int p = z != 0 ? (z > 0 ? 0 : 1) : y != 0 ? (y > 0 ? 2 : 3) : (x > 0 ? 4 : 5);
    return p * 4 + 2;
  }
  const int p = x == 0 ? 6 : y == 0 ? 7 : 8;
  const int s = x == 0 ? z * y : y == 0 ? z * x : y * x;
  return p * 4 + (s > 0 ? 2 : 0);
}

// The slot of offset (az, ay, ax) among a_z's distinct planes, numbered by
// first use in (a_y, a_x) order (the host's packing); form_nslot: their
// count.
__host__ __device__ constexpr int form_slot(int f, int az, int ay, int ax) {
  int seen[kMaxSlots] = {};
  int n = 0;
  for (int y = 0; y < 3; ++y) {
    for (int x = 0; x < 3; ++x) {
      const int c = form_code(f, az, y, x);
      if (c < 0) continue;
      int k = 0;
      while (k < n && seen[k] != (c >> 2)) ++k;
      if (k == n) seen[n++] = c >> 2;
      if (y == ay && x == ax) return k;
    }
  }
  return -1;
}

__host__ __device__ constexpr int form_nslot(int f, int az) {
  int n = 0;
  for (int y = 0; y < 3; ++y) {
    for (int x = 0; x < 3; ++x) n = form_slot(f, az, y, x) + 1 > n ? form_slot(f, az, y, x) + 1 : n;
  }
  return n;
}

// The interior row of a cell-centred axis's collapsed table: weight of tap
// t (fine 2J - 1 + t), fine offset component a - 1 and output o - 1, the
// restriction's 1 3 3 1 / 8 times the prolongation's 3/4 and 1/4 of fine
// row f = 2J - 2 + t + a onto coarse J + o, clipped.
__host__ __device__ constexpr float cell_weight(int t, int a, int o) {
  const float r[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const int f = t - 2 + a;                      // relative to 2J
  const int m = f >= 0 ? f / 2 : -((1 - f) / 2);  // floor(f / 2)
  const int k1 = (f - 2 * m == 0) ? m - 1 : m + 1;  // the 1/4 entry
  float w = 0.0f;
  if ((m < -1 ? -1 : m > 1 ? 1 : m) == o - 1) w += 0.75f;
  if ((k1 < -1 ? -1 : k1 > 1 ? 1 : k1) == o - 1) w += 0.25f;
  return r[t] * w;
}

// The launch's tables, by value.  A step stages the distinct fine planes
// (slots) of some (a_z, a_y) groups of one a_z; per group in the step, its
// a_y and per a_x the code of offset (a_z, a_y, a_x): slot * 4 + bits, -1
// none.
struct Params {
  int32_t slot_plane[kMaxSteps][kMaxSlots];
  signed char nslot[kMaxSteps];
  signed char ngroup[kMaxSteps];
  signed char group_ay[kMaxSteps][kMaxA];
  signed char code[kMaxSteps][kMaxA][kMaxA];
  signed char step_az[kMaxSteps];
  signed char has[kMaxA][kMaxA];        // (a_z, a_y) has fine offsets
  int nsteps;
  short out[kMaxO * kMaxO * kMaxO];     // (o_z, o_y, o_x) -> output plane, -1 none
  // the y and x tables' interior row ([tap][a][o]) and the coarse indices
  // that hold it: y from runs[0] to runs[1], x from runs[2] to runs[3]
  float wy[kTaps * kMaxA * kMaxO];
  float wx[kTaps * kMaxA * kMaxO];
  int runs[4];
};

// An asynchronous copy of kBytes from global to shared memory (zero-filled
// when !valid; src must still be a valid address).
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_group 0;\n" ::); }

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// The slots a step may stage, the two stages and the x stage's sums.
template <typename T, int A, int O>
struct Smem {
  using C = typename mad::Compute<T>::type;
  static constexpr int kSlots = A == 3 ? kMaxSlots : A;
  static constexpr int kSlot = kRows * kCols;
  static constexpr int kStage = kSlots * kSlot;
  static constexpr int kBytes = 2 * kStage * static_cast<int>(sizeof(T)) +
                                kRows * A * O * kTx * static_cast<int>(sizeof(C));
  static_assert(kBytes <= 232448, "shared memory");
};

// A lane's 4 taps of one staged row: from an even column kb, shifted by one
// where odd.
template <typename T>
__device__ __forceinline__ void read_taps(const T* row, int kb, bool odd,
                                          typename mad::Compute<T>::type (&tap)[kTaps]) {
  using C = typename mad::Compute<T>::type;
  using P2 = typename Pair<T>::type;
  const P2 p0 = *reinterpret_cast<const P2*>(row + kb);
  const P2 p1 = *reinterpret_cast<const P2*>(row + kb + 2);
  const P2 p2 = *reinterpret_cast<const P2*>(row + kb + 4);
  const C w[6] = {p0.x, p0.y, p1.x, p1.y, p2.x, p2.y};
#pragma unroll
  for (int t = 0; t < kTaps; ++t) tap[t] = odd ? w[t + 1] : w[t];
}

// The x stage of one fine row and one a_z for a compiled-in form on a cell
// x axis, with the interior row's weights: u[a_y][o] = sum over a_x, t of
// sign * w(t, a_x, o) * tap (a tile that holds a border column: x_full).
template <typename T, int F, int AZ>
__device__ __forceinline__ void x_form(const T* row, int kb, bool odd,
                                       typename mad::Compute<T>::type (&u)[3][3]) {
  using C = typename mad::Compute<T>::type;
  constexpr int kSlot = Smem<T, 3, 3>::kSlot;
  C tap[form_nslot(F, AZ)][kTaps];
#pragma unroll
  for (int s = 0; s < form_nslot(F, AZ); ++s) read_taps<T>(row + s * kSlot, kb, odd, tap[s]);
#pragma unroll
  for (int ay = 0; ay < 3; ++ay) {
#pragma unroll
    for (int o = 0; o < 3; ++o) u[ay][o] = C(0);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int c = form_code(F, AZ, ay, ax);
      if (c < 0) continue;
      const int s = form_slot(F, AZ, ay, ax);
      const C sign = (c & 2) ? C(-1) : C(1);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const float w = cell_weight(t, ax, o);
          if (w != 0.0f) u[ay][o] += (sign * C(w)) * tap[s][t];
          if (c & 1) u[ay][o] += C(w);
        }
      }
    }
  }
}

// The x stage of fine row r and step s in a tile that holds a border
// column: every lane with its own table row, read whole from memory (entry
// i at dx[i * cx]), so that a coupling that leaves the grid sums exact
// zeros; written to the sums u in shared memory (a loop over the offsets,
// so that the code stays small; each offset's weights load together).
template <typename T, int A, int O>
__device__ __forceinline__ void x_full(const T* cur, int r, int s, int kb, bool odd,
                                       const float* __restrict__ dx, int cx, const Params& prm,
                                       typename mad::Compute<T>::type* u, int lane) {
  using C = typename mad::Compute<T>::type;
  constexpr int kSlot = Smem<T, A, O>::kSlot;
#pragma unroll 1
  for (int gi = 0; gi < prm.ngroup[s]; ++gi) {
    const int ay = prm.group_ay[s][gi];
    C part[O];
#pragma unroll
    for (int o = 0; o < O; ++o) part[o] = C(0);
#pragma unroll 1
    for (int ax = 0; ax < A; ++ax) {
      const int c = prm.code[s][gi][ax];
      if (c < 0) continue;
      C tap[kTaps];
      read_taps<T>(cur + (c >> 2) * kSlot + r * kCols, kb, odd, tap);
      const C sign = (c & 2) ? C(-1) : C(1);
      C w[kTaps][O];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
#pragma unroll
        for (int o = 0; o < O; ++o) {
          w[t][o] = static_cast<C>(__ldg(dx + static_cast<int64_t>((t * A + ax) * O + o) * cx));
        }
      }
#pragma unroll
      for (int o = 0; o < O; ++o) {
        C sum = C(0), wsum = C(0);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          sum += w[t][o] * tap[t];
          wsum += w[t][o];
        }
        part[o] += sign * sum;
        if (c & 1) part[o] += wsum;
      }
    }
#pragma unroll
    for (int o = 0; o < O; ++o) u[((r * A + ay) * O + o) * kTx + lane] = part[o];
  }
}

// The x stage of one fine row and one (a_z, a_y) group with the tables
// read at run time: part[o] = sum over a_x, t of s_a * w(t, a_x, o), w the
// interior row or, in a tile that holds a border column, the lane's own.
template <typename T, int A, int O>
__device__ __forceinline__ void x_group(const T* row0, const signed char (&code)[kMaxA],
                                        int kb, bool odd, bool border,
                                        const float* __restrict__ dx, int cx, const Params& prm,
                                        typename mad::Compute<T>::type (&part)[O]) {
  using C = typename mad::Compute<T>::type;
  constexpr int kSlot = Smem<T, A, O>::kSlot;
#pragma unroll
  for (int o = 0; o < O; ++o) part[o] = C(0);
#pragma unroll
  for (int ax = 0; ax < A; ++ax) {
    const int c = code[ax];
    if (c < 0) continue;
    C tap[kTaps];
    read_taps<T>(row0 + (c >> 2) * kSlot, kb, odd, tap);
    const C sign = (c & 2) ? C(-1) : C(1);
#pragma unroll
    for (int o = 0; o < O; ++o) {
      C sum = C(0), wsum = C(0);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const int i = (t * A + ax) * O + o;
        const C w = static_cast<C>(border ? __ldg(dx + static_cast<int64_t>(i) * cx) : prm.wx[i]);
        sum += w * tap[t];
        wsum += w;
      }
      part[o] += sign * sum;
      if (c & 1) part[o] += wsum;
    }
  }
}

// A: fine offset components per axis, O: output components per axis, NOZ:
// output z components per pass, V: values per staged copy, F: the fine
// operator's form (compiled-in forms: A = O = 3, cell-centred y and x; in
// float32 two blocks share an SM, in 128 registers a thread).
template <typename T, int A, int O, int NOZ, int V, int F>
__global__ void __launch_bounds__(kThreads, F != kGeneric && sizeof(T) == 4 ? 2 : 1)
    galerkin_product_kernel(const T* __restrict__ planes, T* __restrict__ out, int nz,
                            int ny, int nx, int cz, int cy, int cx,
                            const int* __restrict__ starts,
                            const float* __restrict__ weights, int zchunk,
                            const __grid_constant__ Params prm) {
  using C = typename mad::Compute<T>::type;
  constexpr int kW = kTaps * A * O;          // one coarse index's table
  constexpr int kQ = kCols / V;              // copies per staged row
  constexpr int kSlot = Smem<T, A, O>::kSlot;
  constexpr int kStage = Smem<T, A, O>::kStage;
  constexpr int kOut = NOZ * O * O;
  constexpr int kPass = O / NOZ;
  static_assert(F == kGeneric || (A == 3 && O == 3), "compiled-in forms are radius 1");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  C* u = reinterpret_cast<C*>(smem + sizeof(T) * 2 * kStage);  // [row][a_y][o_x][lane]

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kTx + lane;
  const int pass = blockIdx.z % kPass;
  const int z0 = (blockIdx.z / kPass) * zchunk;
  const int z1 = min(z0 + zchunk, cz);
  const int* zs = starts;
  const int* ys = zs + cz;
  const int* xs = ys + cy;
  const int* zl = xs + cx;
  const float* wz = weights;
  const float* wy = wz + static_cast<int64_t>(cz) * kW;
  const float* wx = wy + static_cast<int64_t>(cy) * kW;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int jx = x0 + lane, jy = y0 + warp;
  const int jxc = min(jx, cx - 1), jyc = min(jy, cy - 1);
  const int xbase = xs[x0] & ~(kAlign - 1);
  const int ybase = ys[y0];
  const int kx = xs[jxc] - xbase;  // this lane's first tap in a staged row
  const int kb = kx & ~1;          // read as three pairs from here
  const bool odd = kx & 1;
  const int ky = ys[jyc] - ybase;  // this warp's first fine row in the tile
  // where the tile holds a border column or the warp a border row, its
  // rows come whole from memory, else the interior row
  const bool xborder = x0 < prm.runs[2] || x0 + kTx > prm.runs[3];
  const bool yborder = jyc < prm.runs[0] || jyc >= prm.runs[1];
  const float* dx = wx + jxc;  // [entry * cx]: consecutive lanes, consecutive values
  const float* dy = wy + static_cast<int64_t>(jyc) * kW;
  const int64_t plane_n = static_cast<int64_t>(nz) * ny * nx;

  const int ns = prm.nsteps;
  const int iz0 = zs[z0];
  const int iz1 = zs[z1 - 1] + zl[z1 - 1];

  // stage the slots of step s of fine plane iz into stage b: thread t
  // copies row t / 16 of each slot, every 16th copy of the row from t % 16
  constexpr int kPerRow = kThreads / kRows;
  const int crow = tid / kPerRow, cq = tid % kPerRow;
  const bool crow_ok = ybase + crow < ny;
  const int64_t crow_off = static_cast<int64_t>(ybase + crow) * nx + xbase;
  auto fetch = [&](int iz, int s, int b) {
    T* dst = ring + b * kStage + crow * kCols;
    const int64_t off = static_cast<int64_t>(iz) * ny * nx + crow_off;
    const int nslot = prm.nslot[s];
#pragma unroll
    for (int slot = 0; slot < Smem<T, A, O>::kSlots; ++slot) {
      if (slot >= nslot) break;
      const T* src = planes + prm.slot_plane[s][slot] * plane_n + off;
#pragma unroll
      for (int q = cq; q < kQ; q += kPerRow) {
        const bool valid = crow_ok && xbase + q * V < nx;
        copy_async<V * static_cast<int>(sizeof(T))>(dst + slot * kSlot + q * V,
                                                    valid ? src + q * V : planes, valid);
      }
    }
  };

  C acc0[kOut], acc1[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc0[i] = acc1[i] = C(0);
  int jz = z0;
  int end = zs[jz] + zl[jz] - 1;  // the last fine plane of coarse plane jz
  const int64_t cn = static_cast<int64_t>(cz) * cy * cx;
  const bool live = warp < kTy && jx < cx && jy < cy;

  // one step's y stage (the fine rows' (a_y, o_x) sums in u) and z stage
  auto yz = [&](int iz, int az, auto has) {
    if (warp >= kTy) return;
    C v[O * O];
#pragma unroll
    for (int i = 0; i < O * O; ++i) v[i] = C(0);
    if (yborder) {
      // a border row's own weights, read whole (a loop over a_y, so that
      // the code stays small; each a_y's weights load together)
#pragma unroll 1
      for (int a = 0; a < A; ++a) {
        if (!prm.has[az][a]) continue;
        C h[kTaps][O];
#pragma unroll
        for (int ty = 0; ty < kTaps; ++ty) {
#pragma unroll
          for (int oy = 0; oy < O; ++oy) h[ty][oy] = static_cast<C>(__ldg(dy + (ty * A + a) * O + oy));
        }
#pragma unroll
        for (int ty = 0; ty < kTaps; ++ty) {
          // rows past the tile carry no weight (a vertex axis's last row)
          const int r = min(ky + ty, kRows - 1);
          C uu[O];
#pragma unroll
          for (int ox = 0; ox < O; ++ox) uu[ox] = u[((r * A + a) * O + ox) * kTx + lane];
#pragma unroll
          for (int oy = 0; oy < O; ++oy) {
#pragma unroll
            for (int ox = 0; ox < O; ++ox) v[oy * O + ox] += h[ty][oy] * uu[ox];
          }
        }
      }
    } else {
#pragma unroll
      for (int ty = 0; ty < kTaps; ++ty) {
        const int r = min(ky + ty, kRows - 1);
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if (!has(az, a)) continue;
          C uu[O];
#pragma unroll
          for (int ox = 0; ox < O; ++ox) uu[ox] = u[((r * A + a) * O + ox) * kTx + lane];
#pragma unroll
          for (int oy = 0; oy < O; ++oy) {
            if constexpr (F != kGeneric) {
              const float w = cell_weight(ty, a, oy);
              if (w != 0.0f) {
#pragma unroll
                for (int ox = 0; ox < O; ++ox) v[oy * O + ox] += C(w) * uu[ox];
              }
            } else {
              const C h = static_cast<C>(prm.wy[(ty * A + a) * O + oy]);
#pragma unroll
              for (int ox = 0; ox < O; ++ox) v[oy * O + ox] += h * uu[ox];
            }
          }
        }
      }
    }
    // z stage: into the coarse planes jz and jz + 1 where iz is a tap
    const int t0 = iz - zs[jz];
    if (t0 >= 0 && t0 < kTaps) {
      const float* h = wz + static_cast<int64_t>(jz) * kW + (t0 * A + az) * O + pass * NOZ;
#pragma unroll
      for (int oz = 0; oz < NOZ; ++oz) {
        const C hz = static_cast<C>(__ldg(h + oz));
#pragma unroll
        for (int i = 0; i < O * O; ++i) acc0[oz * O * O + i] += hz * v[i];
      }
    }
    const int t1 = jz + 1 < z1 ? iz - zs[jz + 1] : -1;
    if (t1 >= 0 && t1 < kTaps) {
      const float* h = wz + static_cast<int64_t>(jz + 1) * kW + (t1 * A + az) * O + pass * NOZ;
#pragma unroll
      for (int oz = 0; oz < NOZ; ++oz) {
        const C hz = static_cast<C>(__ldg(h + oz));
#pragma unroll
        for (int i = 0; i < O * O; ++i) acc1[oz * O * O + i] += hz * v[i];
      }
    }
  };

  int buf = 0;
  if (iz0 < iz1) fetch(iz0, 0, 0);
  commit_copies();
  for (int iz = iz0; iz < iz1; ++iz) {
    for (int s = 0; s < ns; ++s, buf ^= 1) {
      wait_copies();    // this step's copies have landed
      __syncthreads();  // everyone's; the other stage and u are free
      const int next = s + 1 < ns ? s + 1 : 0;
      if (next > 0 || iz + 1 < iz1) fetch(next > 0 ? iz : iz + 1, next, buf ^ 1);
      commit_copies();
      const T* cur = ring + buf * kStage;
      if constexpr (F != kGeneric) {
        // one step per a_z, in order: s is a_z
        auto form_step = [&](auto az_const) {
          constexpr int AZ = decltype(az_const)::value;
#pragma unroll 1
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            const int r = warp + rr * kWarps;
            if (xborder) {
              x_full<T, A, O>(cur, r, AZ, kb, odd, dx, cx, prm, u, lane);
              continue;
            }
            C uf[3][3];
            x_form<T, F, AZ>(cur + r * kCols, kb, odd, uf);
#pragma unroll
            for (int ay = 0; ay < 3; ++ay) {
#pragma unroll
              for (int o = 0; o < 3; ++o) u[((r * 3 + ay) * 3 + o) * kTx + lane] = uf[ay][o];
            }
          }
          __syncthreads();
          yz(iz, AZ, [](int az, int a) { return form_slot(F, az, a, 0) >= 0 ||
                                                form_slot(F, az, a, 1) >= 0 ||
                                                form_slot(F, az, a, 2) >= 0; });
        };
        if (s == 0) form_step(std::integral_constant<int, 0>{});
        if (s == 1) form_step(std::integral_constant<int, 1>{});
        if (s == 2) form_step(std::integral_constant<int, 2>{});
      } else {
        const int az = prm.step_az[s];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const int r = warp + rr * kWarps;
          for (int gi = 0; gi < prm.ngroup[s]; ++gi) {
            const int ay = prm.group_ay[s][gi];
            C part[O];
            x_group<T, A, O>(cur + r * kCols, prm.code[s][gi], kb, odd, xborder, dx, cx, prm,
                             part);
#pragma unroll
            for (int o = 0; o < O; ++o) u[((r * A + ay) * O + o) * kTx + lane] = part[o];
          }
        }
        if (s + 1 < ns && prm.step_az[s + 1] == az) continue;  // a_z's groups go on
        __syncthreads();
        yz(iz, az, [&](int z, int a) { return prm.has[z][a] != 0; });
      }
    }
    if (iz == end) {
      // coarse plane jz's window ends: write it, and move on to jz + 1
      if (live) {
        const int64_t at = (static_cast<int64_t>(jz) * cy + jy) * cx + jx;
#pragma unroll
        for (int oz = 0; oz < NOZ; ++oz) {
#pragma unroll
          for (int oy = 0; oy < O; ++oy) {
#pragma unroll
            for (int ox = 0; ox < O; ++ox) {
              // the compiled-in forms' outputs are the 27 planes in order
              const int p = F != kGeneric ? (oz * O + oy) * O + ox
                                          : prm.out[((pass * NOZ + oz) * O + oy) * O + ox];
              if (p < 0) continue;
              C val = -acc0[(oz * O + oy) * O + ox];
              if (pass * NOZ + oz == O / 2 && oy == O / 2 && ox == O / 2) val = C(1) + val;
              mad::store(out + p * cn + at, val);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        acc0[i] = acc1[i];
        acc1[i] = C(0);
      }
      ++jz;
      if (jz < z1) end = zs[jz] + zl[jz] - 1;
    }
  }
  wait_copies();
}

// The launch's Params from the host's fine table (A^3 int32 codes: plane *
// 4 + bits, -1 none), output map (O^3 int32), interior rows ((2, taps, A,
// O) float32, y then x) and runs (4 int32).  Each a_z's groups go into
// steps of at most `slots` distinct planes.  False if a code names a plane
// out of range, a group alone has more planes than a step takes, no group
// has a plane, or the map is not one-to-one onto the n_out output planes.
bool make_params(const int32_t* fine, int a, const int32_t* omap, int o,
                 const float* interior, const int32_t* runs, int slots, int64_t n_planes,
                 int64_t n_out, Params* p) {
  *p = Params{};
  const int w = kTaps * a * o;
  for (int i = 0; i < w; ++i) {
    p->wy[i] = interior[i];
    p->wx[i] = interior[w + i];
  }
  for (int i = 0; i < 4; ++i) p->runs[i] = runs[i];
  int ns = 0;
  for (int az = 0; az < a; ++az) {
    const int first = ns;  // the a_z's first step
    for (int ay = 0; ay < a; ++ay) {
      int32_t planes[kMaxA];
      int n = 0;
      for (int ax = 0; ax < a; ++ax) {
        const int32_t c = fine[(az * a + ay) * a + ax];
        if (c < 0) continue;
        if ((c >> 2) >= n_planes) return false;
        bool seen = false;
        for (int i = 0; i < n; ++i) seen = seen || planes[i] == (c >> 2);
        if (!seen) planes[n++] = c >> 2;
      }
      p->has[az][ay] = n > 0;
      if (n == 0) continue;
      if (n > slots) return false;
      // the group joins the a_z's current step if the step's planes and its
      // own fit together, else it opens the next step
      int s = ns - 1;
      int extra = 0;
      if (s >= first) {
        for (int i = 0; i < n; ++i) {
          bool seen = false;
          for (int k = 0; k < p->nslot[s]; ++k) seen = seen || p->slot_plane[s][k] == planes[i];
          extra += !seen;
        }
      }
      if (s < first || p->nslot[s] + extra > slots) {
        s = ns++;
        p->step_az[s] = static_cast<signed char>(az);
      }
      const int gi = p->ngroup[s]++;
      p->group_ay[s][gi] = static_cast<signed char>(ay);
      for (int ax = 0; ax < a; ++ax) {
        const int32_t c = fine[(az * a + ay) * a + ax];
        p->code[s][gi][ax] = -1;
        if (c < 0) continue;
        int k = 0;
        while (k < p->nslot[s] && p->slot_plane[s][k] != (c >> 2)) ++k;
        if (k == p->nslot[s]) p->slot_plane[s][p->nslot[s]++] = c >> 2;
        p->code[s][gi][ax] = static_cast<signed char>(k * 4 + (c & 3));
      }
    }
  }
  p->nsteps = ns;
  if (ns == 0) return false;
  bool seen[kMaxO * kMaxO * kMaxO] = {};
  int mapped = 0;
  for (int i = 0; i < o * o * o; ++i) {
    const int32_t v = omap[i];
    if (v >= n_out || (v >= 0 && seen[v])) return false;
    if (v >= 0) {
      seen[v] = true;
      ++mapped;
    }
    p->out[i] = static_cast<short>(v < 0 ? -1 : v);
  }
  return mapped == n_out;
}

// The compiled-in form the launch's tables are, or kGeneric: the fine
// table is the form's, every a_z one step, the y and x interior rows the
// cell-centred ones and the output the 27 planes in order.
int form_of(const int32_t* fine, int a, int o, const float* interior, const Params& prm) {
  if (a != 3 || o != 3 || prm.nsteps != 3) return kGeneric;
  for (int i = 0; i < 36; ++i) {
    const float w = cell_weight(i / 9, i / 3 % 3, i % 3);
    if (interior[i] != w || interior[36 + i] != w) return kGeneric;
  }
  for (int i = 0; i < 27; ++i) {
    if (prm.out[i] != i) return kGeneric;
  }
  for (int f : {kCompressed19, kStored27}) {
    bool same = true;
    for (int i = 0; i < 27 && same; ++i) same = fine[i] == form_code(f, i / 9, i / 3 % 3, i % 3);
    for (int az = 0; az < 3 && same; ++az) same = prm.step_az[az] == az;
    if (same) return f;
  }
  return kGeneric;
}

template <typename T, int A, int O, int V, int F>
int launch_v(const T* planes, T* out, int64_t nz, int64_t ny, int64_t nx, int64_t cz,
             int64_t cy, int64_t cx, const int* starts, const float* weights, int64_t zchunk,
             const Params& prm, cudaStream_t stream) {
  constexpr int NOZ = O == 3 ? 3 : 1;
  constexpr int kPass = O / NOZ;
  constexpr int smem = Smem<T, A, O>::kBytes;
  auto* k = galerkin_product_kernel<T, A, O, NOZ, V, F>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = (cz + zchunk - 1) / zchunk;
  if (chunks * kPass > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(mad::blocks_for(cx, kTx), mad::blocks_for(cy, kTy),
                  static_cast<unsigned>(chunks * kPass));
  k<<<grid, dim3(kTx, kWarps), smem, stream>>>(
      planes, out, static_cast<int>(nz), static_cast<int>(ny), static_cast<int>(nx),
      static_cast<int>(cz), static_cast<int>(cy), static_cast<int>(cx), starts, weights,
      static_cast<int>(zchunk), prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int A, int O>
int launch_ao(const void* planes, void* out, int64_t n_planes, int64_t nz, int64_t ny,
              int64_t nx, int64_t cz, int64_t cy, int64_t cx, const int32_t* fine,
              const int32_t* omap, int64_t n_out, const float* interior,
              const int32_t* runs, const void* starts, const void* weights, int64_t zchunk,
              cudaStream_t stream) {
  Params prm;
  if (!make_params(fine, A, omap, O, interior, runs, Smem<T, A, O>::kSlots, n_planes, n_out,
                   &prm)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* p = static_cast<const T*>(planes);
  T* q = static_cast<T*>(out);
  const int* s = static_cast<const int*>(starts);
  const float* w = static_cast<const float*>(weights);
  // 16-byte copies where every row starts on a 16-byte boundary (float32;
  // float64 runs in the card tests alone)
  constexpr int V = sizeof(T) == 4 ? 4 : 1;
  const bool vec = nx % V == 0;
  if constexpr (A == 3 && O == 3) {
    const int f = form_of(fine, A, O, interior, prm);
    if (f == kCompressed19) {
      return vec ? launch_v<T, A, O, V, kCompressed19>(p, q, nz, ny, nx, cz, cy, cx, s, w,
                                                      zchunk, prm, stream)
                 : launch_v<T, A, O, 1, kCompressed19>(p, q, nz, ny, nx, cz, cy, cx, s, w,
                                                      zchunk, prm, stream);
    }
    if (f == kStored27) {
      return vec ? launch_v<T, A, O, V, kStored27>(p, q, nz, ny, nx, cz, cy, cx, s, w, zchunk,
                                                  prm, stream)
                 : launch_v<T, A, O, 1, kStored27>(p, q, nz, ny, nx, cz, cy, cx, s, w, zchunk,
                                                  prm, stream);
    }
  }
  return vec ? launch_v<T, A, O, V, kGeneric>(p, q, nz, ny, nx, cz, cy, cx, s, w, zchunk, prm,
                                             stream)
             : launch_v<T, A, O, 1, kGeneric>(p, q, nz, ny, nx, cz, cy, cx, s, w, zchunk, prm,
                                             stream);
}

template <typename T>
int launch(const void* planes, void* out, int64_t n_planes, int64_t nz, int64_t ny,
           int64_t nx, int64_t cz, int64_t cy, int64_t cx, const void* host_fine,
           int64_t a, const void* host_out, int64_t o, int64_t n_out, const void* starts,
           const void* weights, const void* host_interior, const void* host_runs,
           int64_t zchunk, void* stream) {
  const int64_t dims[] = {nz, ny, nx, cz, cy, cx};
  for (int64_t d : dims) {
    if (d < 1 || d > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((a != 3 && a != 5) || (o != 3 && o != 5) || zchunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* f = static_cast<const int32_t*>(host_fine);
  const auto* m = static_cast<const int32_t*>(host_out);
  const auto* in = static_cast<const float*>(host_interior);
  const auto* r = static_cast<const int32_t*>(host_runs);
  const auto st = static_cast<cudaStream_t>(stream);
  if (a == 3 && o == 3) {
    return launch_ao<T, 3, 3>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in,
                              r, starts, weights, zchunk, st);
  }
  if (a == 3) {
    return launch_ao<T, 3, 5>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in,
                              r, starts, weights, zchunk, st);
  }
  if (o == 3) {
    return launch_ao<T, 5, 3>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in,
                              r, starts, weights, zchunk, st);
  }
  return launch_ao<T, 5, 5>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in, r,
                            starts, weights, zchunk, st);
}

}  // namespace

// Storage float32 (the solves' dtype) and float64 (the card tests): other
// dtypes take the eager path.
#define MAD_GALERKIN_ENTRY(SUF, T)                                                \
  extern "C" int mad_galerkin_product_##SUF(                                      \
      const void* planes, void* out, int64_t n_planes, int64_t nz, int64_t ny,    \
      int64_t nx, int64_t cz, int64_t cy, int64_t cx, const void* host_fine,      \
      int64_t a, const void* host_out, int64_t o, int64_t n_out,                  \
      const void* starts, const void* weights, const void* host_interior,         \
      const void* host_runs, int64_t zchunk, void* stream) {                      \
    return launch<T>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, host_fine, a, \
                     host_out, o, n_out, starts, weights, host_interior,          \
                     host_runs, zchunk, stream);                                  \
  }

MAD_GALERKIN_ENTRY(f32, float)
MAD_GALERKIN_ENTRY(f64, double)
