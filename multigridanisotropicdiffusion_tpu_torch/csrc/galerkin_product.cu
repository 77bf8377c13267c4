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
// Blocks along grid z split the march into chunks and, for the generic
// form on five output z components, those into passes (25 outputs in
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
// run time (the generic form: vertex-centred axes, pruned levels, radius-2
// operators that are not the exact chain's).
//
// The exact chain's three products (exact19: the compressed operator ->
// the 5^3 box less its corners, 117 planes; exact117: those -> 125;
// exact125: 125 -> 125) on cell-centred axes take their own march
// (galerkin_product_kernel_exact, below): its 125 sums of a coarse point
// do not fit one thread's registers, so a block of 20 warps splits them
// (a warp per coarse y, o_y group and o_x), the x stage runs once per fine
// row and (a_z, a_y) into shared memory for all of them, and the fine
// planes are read once a level, where the generic form read them once per
// output z component.  The radius-2 interior row is compiled in
// (exact_weight), as are the three fine tables and the output map: a
// product per non-zero weight (24 of 60 at A = 3, 40 of 100 at A = 5).
// Its bound is the same bytes (level 1 of the 512^3 exact chain: 10
// planes of 512^3 in, 117 of 256^3 out, 13.2 GB, 3.95 ms); its
// arithmetic, about 2k (level 1) and 7k (level 2) multiply-adds a coarse
// point, stays under them.  Measured (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): level 1 in 13.1 ms and level 2 in 8.4 ms, 30% and 32% of their
// bytes' pace (the generic form: 125.9 and 110.7 ms), the six levels in
// 20.9 ms.  What sets the pace is each step's latency, two barriers apart:
// at level 1 a block's ~129 fine-plane steps take ~3.2 us each, the x stage
// and the y and z stages ~30% each, the 117 planes' stores ~20%.  Holding
// 25 sums a thread (10 warps) took 168-255 registers and spilled: 20-27 ms
// at level 1; 15 sums a thread (20 warps) spill nothing in float32.
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

// The forms (ops.cuda_galerkin.FORMS): offset tables read at run time, or
// compiled in.  The host's plan names the form; the entry point checks the
// tables against it.
constexpr int kGeneric = 0;
constexpr int kCompressed19 = 1;  // ops.galerkin.plane_table of the compressed operator
constexpr int kStored27 = 2;      // 27 planes in stencil_offsets(3, 1, False) order
constexpr int kExact19 = 3;       // the compressed operator -> the 5^3 box less its corners
constexpr int kExact117 = 4;      // 117 stored planes (that box, in order) -> 125
constexpr int kExact125 = 5;      // 125 stored planes (stencil_offsets(3, 2, False)) -> 125

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

// The exact forms (exact19, exact117, exact125): one march a level, every
// output component of a coarse point in it.  A block of 20 warps owns 32
// coarse x (a lane each) by 2 coarse y and marches over a chunk of coarse z
// planes; warp w holds coarse y w / 10, o_y group w / 5 % 2 (o_y 0, 2, 4 or
// 1, 3) and output x component o_x = w % 5: its group's 5 o_z x 3 (or 2)
// o_y sums of each of the two coarse planes a fine plane feeds, in
// registers.  Every axis is cell-centred and every row of an axis table is
// read in its window 2 J - 1 .. 2 J + 2 (the host re-indexes the border
// rows to it: ops.cuda_galerkin.window_table), so the march is regular:
// fine plane iz feeds coarse planes iz / 2 (odd iz: taps 2 and 0) or
// iz / 2 - 1 and iz / 2 (even: taps 3 and 1), and the staged tile is the
// fine rows 2 y0 - 1 .. 2 y0 + 4 by the columns from 2 x0 - 4 (zero past the
// grid).  A step stages the fine planes of one a_z (exact19: the ten
// compressed planes, all three a_z), is contracted along x once per fine row
// and (a_z, a_y) into (o_x) sums in shared memory, then each warp contracts
// its coarse y's four rows into its o_y and adds them, times the z weight,
// to its two coarse planes.
constexpr int kETy = 2;                // coarse y per block
constexpr int kEO = 5;                 // output components per axis
constexpr int kEWarps = kETy * kEO * 2;  // a warp per (coarse y, o_y group, o_x)
constexpr int kEThreads = kTx * kEWarps;
constexpr int kERows = 2 * kETy + 2;   // fine rows 2 y0 - 1 .. 2 y0 + 2 kETy
constexpr int kEOy = 3;                // a warp's o_y: 0, 2, 4 (group 0) or 1, 3 (group 1)
constexpr int kEOut = kEO * kEOy;      // a thread's sums per coarse plane: (o_z, its o_y)

// Group g's o_y: each (tap, a) of an interior row weighs two neighbouring
// outputs, one of each group, so the groups share the y stage's products
// evenly.
__host__ __device__ constexpr int group_n(int g) { return g == 0 ? 3 : 2; }
__host__ __device__ constexpr int group_oy(int g, int k) { return 2 * k + g; }

// The exact chain's interior row on a cell-centred axis: weight of tap t
// (fine 2J - 1 + t), fine offset component a - ra and output o - 2, the
// restriction's 1 3 3 1 / 8 times the prolongation's 3/4 and 1/4 of fine
// row f = 2J - 1 + t + a - ra onto coarse J + o - 2 (cell_weight unclipped).
__host__ __device__ constexpr float exact_weight(int ra, int t, int a, int o) {
  const float r[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const int f = t - 1 + a - ra;                   // relative to 2J
  const int m = f >= 0 ? f / 2 : -((1 - f) / 2);  // floor(f / 2)
  const int k1 = (f - 2 * m == 0) ? m - 1 : m + 1;  // the 1/4 entry
  float w = 0.0f;
  if (m == o - 2) w += 0.75f;
  if (k1 == o - 2) w += 0.25f;
  return r[t] * w;
}

__host__ __device__ constexpr int exact_a(int f) { return f == kExact19 ? 3 : 5; }

// Offset (z, y, x) of the 5^3 box, components 0 .. 4, is one of its corners.
__host__ __device__ constexpr bool box_corner(int z, int y, int x) {
  return (z == 0 || z == 4) && (y == 0 || y == 4) && (x == 0 || x == 4);
}

// Its index among the box's offsets in order (stencil_offsets(3, 2, False)),
// the corners left out under `skip` (-1 for a corner).
__host__ __device__ constexpr int box_index(bool skip, int z, int y, int x) {
  const int i = (z * 5 + y) * 5 + x;
  if (!skip) return i;
  if (box_corner(z, y, x)) return -1;
  int before = 0;
  for (int c = 0; c < 8; ++c) before += ((c & 4 ? 100 : 0) + (c & 2 ? 20 : 0) + (c & 1 ? 4 : 0)) < i;
  return i - before;
}

// Form f's code of fine offset (az, ay, ax), components 0 .. A - 1, as the
// host's fine table holds it (plane * 4 + bits), and its output plane of
// (oz, oy, ox).
__host__ __device__ constexpr int exact_code(int f, int az, int ay, int ax) {
  if (f == kExact19) return form_code(kCompressed19, az, ay, ax);
  const int p = box_index(f == kExact117, az, ay, ax);
  return p < 0 ? -1 : p * 4 + 2 + (az == 2 && ay == 2 && ax == 2);
}

__host__ __device__ constexpr int exact_out(int f, int oz, int oy, int ox) {
  return box_index(f == kExact19, oz, oy, ox);
}

// The planes step a_z stages, consecutive from exact_first: exact19 all ten
// (one step a fine plane); the stored forms a_z's own.
__host__ __device__ constexpr int exact_first(int f, int az) {
  return f == kExact19 ? 0 : f == kExact125 ? az * 25 : az * 25 - (az > 0 ? 4 : 0);
}

__host__ __device__ constexpr int exact_nplanes(int f, int az) {
  return f == kExact19 ? 10 : (f == kExact117 && (az == 0 || az == 4)) ? 21 : 25;
}

// The launch's parameters: the y, x and z interior runs (coarse indices lo,
// hi: their rows are the compiled-in interior row), the output map and, for
// exact19, the fine codes (exact_code, (a_z, a_y, a_x)).
struct ExactParams {
  int runs[6];
  short out[kEO * kEO * kEO];
  signed char code[27];
};

// The two stages, the x stage's sums ([row][group][o_x][lane], a group an
// (a_z, a_y) of the step) and a border tile's x rows ([entry][lane]).
template <typename T, int F>
struct ESmem {
  using C = typename mad::Compute<T>::type;
  static constexpr int kSlots = F == kExact19 ? 10 : 25;
  static constexpr int kGroups = F == kExact19 ? 9 : 5;
  static constexpr int kSlot = kERows * kCols;
  static constexpr int kStage = kSlots * kSlot;
  static constexpr int kU = kERows * kGroups * kEO * kTx;
  static constexpr int kXw = kTaps * exact_a(F) * kEO * kTx;
  static constexpr int kBytes = 2 * kStage * static_cast<int>(sizeof(T)) +
                                kU * static_cast<int>(sizeof(C)) + kXw * 4;
  static_assert(kBytes <= 232448, "shared memory");
};

// A lane's taps of one staged row: fine 2 J - 1 .. 2 J + 2 at columns kb + 1
// .. kb + 4 (kb even; the middle two as a pair).
template <typename T>
__device__ __forceinline__ void window_taps(const T* row, int kb,
                                            typename mad::Compute<T>::type (&tap)[kTaps]) {
  using P2 = typename Pair<T>::type;
  const P2 mid = *reinterpret_cast<const P2*>(row + kb + 2);
  tap[0] = row[kb + 1];
  tap[1] = mid.x;
  tap[2] = mid.y;
  tap[3] = row[kb + 4];
}

// The x weight of entry (t, a, o): the interior row's, compiled in, or (B, a
// tile that holds a border column) the lane's own row, staged in shared
// memory (xw: the lane's column of [entry][lane]).
template <bool B, int A>
__device__ __forceinline__ float x_weight(const float* xw, int t, int a, int o) {
  if constexpr (B) return xw[((t * A + a) * kEO + o) * kTx];
  return exact_weight(A / 2, t, a, o);
}

// The x stage of staged row r and group (a_z, a_y) of the stored forms:
// u[o_x] = sum over a_x, t of w(t, a_x, o_x) * s, s = -c off the centre and
// 1 - c on it, a product per non-zero weight of the interior row.
template <typename T, int F, bool B>
__device__ __forceinline__ void x_item5(const T* stage, int r, int az, int ay, int kb,
                                        const float* xw, typename mad::Compute<T>::type* u,
                                        int lane) {
  using C = typename mad::Compute<T>::type;
  constexpr int kSlot = ESmem<T, F>::kSlot;
  // exact117's first and last a_z lack the four corners: their rows a_y = 0
  // and 4 hold a_x = 1 .. 3 alone
  const bool zc = F == kExact117 && (az == 0 || az == 4);
  const bool rc = zc && (ay == 0 || ay == 4);
  const int s0 = ay * 5 - (zc ? (ay == 0 ? 1 : ay == 4 ? 3 : 2) : 0);
  const bool centre = az == 2 && ay == 2;
  const T* row = stage + r * kCols;
  C acc[kEO];
#pragma unroll
  for (int o = 0; o < kEO; ++o) acc[o] = C(0);
#pragma unroll
  for (int ax = 0; ax < 5; ++ax) {
    if ((ax == 0 || ax == 4) && rc) continue;
    C tap[kTaps];
    window_taps<T>(row + (s0 + ax) * kSlot, kb, tap);
    if (ax == 2 && centre) {
#pragma unroll
      for (int t = 0; t < kTaps; ++t) tap[t] -= C(1);
    }
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
#pragma unroll
      for (int o = 0; o < kEO; ++o) {
        if (exact_weight(2, t, ax, o) != 0.0f) acc[o] -= C(x_weight<B, 5>(xw, t, ax, o)) * tap[t];
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kEO; ++o) u[((r * 5 + ay) * kEO + o) * kTx + lane] = acc[o];
}

// The same for group g = (a_z, a_y) of exact19, the compressed planes with
// their signs: each a_x's code (code: the group's three) read at run time,
// the weights compiled in.
template <typename T, bool B>
__device__ __forceinline__ void x_item3(const T* stage, int r, int g, int kb, const float* xw,
                                        const signed char* code,
                                        typename mad::Compute<T>::type* u, int lane) {
  using C = typename mad::Compute<T>::type;
  constexpr int kSlot = ESmem<T, kExact19>::kSlot;
  const T* row = stage + r * kCols;
  C acc[kEO];
#pragma unroll
  for (int o = 0; o < kEO; ++o) acc[o] = C(0);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int c = code[ax];
    if (c < 0) continue;
    C tap[kTaps];
    window_taps<T>(row + (c >> 2) * kSlot, kb, tap);
    // s = -c off the centre, 1 - c on it; +c where the term's sign is negative
    const C one = (c & 1) ? C(1) : C(0);
    const C sign = (c & 2) ? C(-1) : C(1);
#pragma unroll
    for (int t = 0; t < kTaps; ++t) tap[t] = (tap[t] - one) * sign;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
#pragma unroll
      for (int o = 0; o < kEO; ++o) {
        if (exact_weight(1, t, ax, o) != 0.0f) acc[o] += C(x_weight<B, 3>(xw, t, ax, o)) * tap[t];
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kEO; ++o) u[((r * 9 + g) * kEO + o) * kTx + lane] = acc[o];
}

// A warp's y stage for one a_z: v[k] = sum over a_y, t of w(t, a_y, o_y) *
// the x stage's sum of its coarse y's row t, group a_y, its o_x (ug: row 0,
// the a_z's first group), o_y its group GR's k-th; w the interior row or
// (B) the warp's own.
template <typename T, int A, int G, int GR, bool B>
__device__ __forceinline__ void y_stage(const typename mad::Compute<T>::type* ug,
                                        const float* __restrict__ dy,
                                        typename mad::Compute<T>::type (&v)[kEOy]) {
  using C = typename mad::Compute<T>::type;
#pragma unroll
  for (int k = 0; k < kEOy; ++k) v[k] = C(0);
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const C x = ug[(t * G + a) * kEO * kTx];
#pragma unroll
      for (int k = 0; k < group_n(GR); ++k) {
        const int o = group_oy(GR, k);
        const float w = exact_weight(A / 2, t, a, o);
        if (w == 0.0f) continue;
        v[k] += (B ? C(__ldg(dy + (t * A + a) * kEO + o)) : C(w)) * x;
      }
    }
  }
}

// The z stage of a_z AZ on interior coarse planes, compiled in: fine plane
// iz (P: odd) is tap 2 (odd; else 3) of the first plane it feeds, tap 0
// (else 1) of the second.
template <int A, int AZ, int P, int GR, typename C>
__device__ __forceinline__ void z_form(const C (&v)[kEOy], C (&acc0)[kEOut],
                                       C (&acc1)[kEOut]) {
  constexpr int t0 = P ? 2 : 3;
#pragma unroll
  for (int oz = 0; oz < kEO; ++oz) {
    const float w0 = exact_weight(A / 2, t0, AZ, oz);
    const float w1 = exact_weight(A / 2, t0 - 2, AZ, oz);
#pragma unroll
    for (int k = 0; k < group_n(GR); ++k) {
      if (w0 != 0.0f) acc0[oz * kEOy + k] += C(w0) * v[k];
      if (w1 != 0.0f) acc1[oz * kEOy + k] += C(w1) * v[k];
    }
  }
}

// The same where either plane is a border plane (or past the grid): the
// planes' rows read from memory.
template <int A, int GR, typename C>
__device__ __forceinline__ void z_read(const float* __restrict__ wz, int cz, int cur, int az,
                                       bool odd, const C (&v)[kEOy], C (&acc0)[kEOut],
                                       C (&acc1)[kEOut]) {
  constexpr int kW = kTaps * A * kEO;
  const int t0 = odd ? 2 : 3;
  if (cur >= 0) {
    const float* h = wz + static_cast<int64_t>(cur) * kW + (t0 * A + az) * kEO;
#pragma unroll
    for (int oz = 0; oz < kEO; ++oz) {
      const C hz = C(__ldg(h + oz));
#pragma unroll
      for (int k = 0; k < group_n(GR); ++k) acc0[oz * kEOy + k] += hz * v[k];
    }
  }
  if (cur + 1 < cz) {
    const float* h = wz + static_cast<int64_t>(cur + 1) * kW + ((t0 - 2) * A + az) * kEO;
#pragma unroll
    for (int oz = 0; oz < kEO; ++oz) {
      const C hz = C(__ldg(h + oz));
#pragma unroll
      for (int k = 0; k < group_n(GR); ++k) acc1[oz * kEOy + k] += hz * v[k];
    }
  }
}

// F: kExact19, kExact117 or kExact125; V: values per staged copy.
template <typename T, int F, int V>
__global__ void __launch_bounds__(kEThreads, 1)
    galerkin_product_kernel_exact(const T* __restrict__ planes, T* __restrict__ out, int nz,
                                  int ny, int nx, int cz, int cy, int cx,
                                  const float* __restrict__ weights, int zchunk,
                                  const __grid_constant__ ExactParams prm) {
  using C = typename mad::Compute<T>::type;
  using S = ESmem<T, F>;
  constexpr int A = exact_a(F);
  constexpr int kW = kTaps * A * kEO;          // one coarse index's table
  constexpr int kQ = kCols / V;                // copies per staged row
  constexpr int kPer = kERows * kQ;            // copies per staged plane
  constexpr int kCopyGroups = kEThreads / kPer > 1 ? kEThreads / kPer : 1;
  constexpr int kSteps = F == kExact19 ? 1 : A;  // steps per fine plane

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  C* u = reinterpret_cast<C*>(smem + sizeof(T) * 2 * S::kStage);
  float* xw = reinterpret_cast<float*>(smem + sizeof(T) * 2 * S::kStage + sizeof(C) * S::kU);

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kTx + lane;
  const int yl = warp / (2 * kEO), grp = warp / kEO % 2, ox = warp % kEO;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = min(z0 + zchunk, cz);
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kETy;
  const int jx = x0 + lane, jy = y0 + yl;
  const int jxc = min(jx, cx - 1), jyc = min(jy, cy - 1);
  const int xbase = 2 * x0 - kAlign;  // the staged columns: fine 2 x0 - 4 on
  const int ybase = 2 * y0 - 1;       // the staged rows: fine 2 y0 - 1 on
  const int kb = 2 * lane + 2;        // this lane's taps: columns kb + 1 .. kb + 4
  const float* wz = weights;
  const float* wy = wz + static_cast<int64_t>(cz) * kW;
  const float* wx = wy + static_cast<int64_t>(cy) * kW;
  // a tile that holds a border column, or a warp a border row, reads its
  // rows from memory, else the interior row
  const bool xborder = x0 < prm.runs[2] || x0 + kTx > prm.runs[3];
  const bool yborder = jyc < prm.runs[0] || jyc >= prm.runs[1];
  const float* dy = wy + static_cast<int64_t>(jyc) * kW;
  if (xborder) {
    // the tile's x rows, [entry][lane], read before the first step's barrier
    for (int e = warp; e < kW; e += kEWarps) {
      xw[e * kTx + lane] = __ldg(wx + static_cast<int64_t>(e) * cx + jxc);
    }
  }
  const float* xwl = xw + lane;
  const int64_t plane_n = static_cast<int64_t>(nz) * ny * nx;

  // stage the planes of step az of fine plane iz into stage b: thread t
  // copies (row, copy) t % kPer of every kCopyGroups-th plane from t / kPer
  auto fetch = [&](int iz, int az, int b) {
    T* dst0 = ring + b * S::kStage;
    const T* src0 = planes + exact_first(F, az) * plane_n + static_cast<int64_t>(iz) * ny * nx;
    const int n = exact_nplanes(F, az);
    for (int i = tid; i < kCopyGroups * kPer; i += kEThreads) {
      const int g = i / kPer, rq = i - g * kPer;
      const int row = rq / kQ, q = rq - row * kQ;
      const int fy = ybase + row, fx = xbase + q * V;
      const bool ok = fy >= 0 && fy < ny && fx >= 0 && fx + V <= nx;
      T* dst = dst0 + g * S::kSlot + row * kCols + q * V;
      const T* src = src0 + g * plane_n + (ok ? static_cast<int64_t>(fy) * nx + fx : 0);
      for (int s = g; s < n; s += kCopyGroups) {
        copy_async<V * static_cast<int>(sizeof(T))>(dst, ok ? src : planes, ok);
        dst += kCopyGroups * S::kSlot;
        src += kCopyGroups * plane_n;
      }
    }
  };

  // the x stage of one step: every (fine row, group) once, the warps in turn
  auto x_stage = [&](const T* stage, int az, auto border) {
    constexpr bool B = decltype(border)::value;
    if constexpr (F == kExact19) {
#pragma unroll 1
      for (int i = warp; i < kERows * 9; i += kEWarps) {
        const int g = i / kERows;
        x_item3<T, B>(stage, i - g * kERows, g, kb, xwl, prm.code + 3 * g, u, lane);
      }
    } else {
#pragma unroll 1
      for (int i = warp; i < kERows * 5; i += kEWarps) {
        const int r = i / 5;
        x_item5<T, F, B>(stage, r, az, i - 5 * r, kb, xwl, u, lane);
      }
    }
  };

  C acc0[kEOut], acc1[kEOut];
#pragma unroll
  for (int i = 0; i < kEOut; ++i) acc0[i] = acc1[i] = C(0);
  const bool live = jx < cx && jy < cy;
  const int64_t cn = static_cast<int64_t>(cz) * cy * cx;

  // coarse plane jz's window has ended: write this thread's (o_y, o_x) of it
  auto write = [&](int jz, auto grc) {
    constexpr int GR = decltype(grc)::value;
    if (!live) return;
    const int64_t at = (static_cast<int64_t>(jz) * cy + jy) * cx + jx;
#pragma unroll
    for (int oz = 0; oz < kEO; ++oz) {
#pragma unroll
      for (int k = 0; k < group_n(GR); ++k) {
        const int oy = group_oy(GR, k);
        const int p = prm.out[(oz * kEO + oy) * kEO + ox];
        if (p < 0) continue;
        C val = -acc0[oz * kEOy + k];
        if (oz == 2 && oy == 2 && ox == 2) val = C(1) + val;
        mad::store(out + p * cn + at, val);
      }
    }
  };

  // a warp's y stage of the step's groups g0 ..: its coarse y's rows, its o_x
  auto ystage = [&](int g0, C (&v)[kEOy], auto grc) {
    constexpr int G = S::kGroups, GR = decltype(grc)::value;
    const C* ug = u + ((2 * yl * G + g0) * kEO + ox) * kTx + lane;
    if (yborder) {
      y_stage<T, A, G, GR, true>(ug, dy, v);
    } else {
      y_stage<T, A, G, GR, false>(ug, dy, v);
    }
  };
  // the z stage of a_z AZ: on interior planes compiled in, else read
  auto zstage = [&](auto azc, const C (&v)[kEOy], bool odd, bool zin, int cur, auto grc) {
    constexpr int AZ = decltype(azc)::value, GR = decltype(grc)::value;
    if (!zin) {
      z_read<A, GR>(wz, cz, cur, AZ, odd, v, acc0, acc1);
    } else if (odd) {
      z_form<A, AZ, 1, GR>(v, acc0, acc1);
    } else {
      z_form<A, AZ, 0, GR>(v, acc0, acc1);
    }
  };
  // the y and z stages of a step, for o_y group GR
  auto yz = [&](int az, bool odd, bool zin, int cur, auto grc) {
    C v[kEOy];
    using I0 = std::integral_constant<int, 0>;
    using I1 = std::integral_constant<int, 1>;
    using I2 = std::integral_constant<int, 2>;
    if constexpr (F == kExact19) {
      // the three a_z of the fine plane
#pragma unroll 1
      for (int z = 0; z < 3; ++z) {
        ystage(3 * z, v, grc);
        if (z == 0) {
          zstage(I0{}, v, odd, zin, cur, grc);
        } else if (z == 1) {
          zstage(I1{}, v, odd, zin, cur, grc);
        } else {
          zstage(I2{}, v, odd, zin, cur, grc);
        }
      }
    } else {
      ystage(0, v, grc);
      switch (az) {
        case 0: zstage(I0{}, v, odd, zin, cur, grc); break;
        case 1: zstage(I1{}, v, odd, zin, cur, grc); break;
        case 2: zstage(I2{}, v, odd, zin, cur, grc); break;
        case 3: zstage(std::integral_constant<int, 3>{}, v, odd, zin, cur, grc); break;
        default: zstage(std::integral_constant<int, 4>{}, v, odd, zin, cur, grc); break;
      }
    }
  };

  const int izs = max(2 * z0 - 1, 0), ize = min(2 * z1, nz - 1);
  int buf = 0;
  fetch(izs, 0, 0);
  commit_copies();
  for (int iz = izs; iz <= ize; ++iz) {
    const bool odd = iz & 1;
    const int cur = odd ? iz >> 1 : (iz >> 1) - 1;  // iz feeds coarse planes cur, cur + 1
    const bool zin = cur >= prm.runs[4] && cur + 1 < prm.runs[5];
#pragma unroll 1
    for (int az = 0; az < kSteps; ++az, buf ^= 1) {
      wait_copies();    // this step's copies have landed
      __syncthreads();  // everyone's; the other stage and u are free
      if (az + 1 < kSteps) {
        fetch(iz, az + 1, buf ^ 1);
      } else if (iz < ize) {
        fetch(iz + 1, 0, buf ^ 1);
      }
      commit_copies();
      const T* stage = ring + buf * S::kStage;
      if (xborder) {
        x_stage(stage, az, std::true_type{});
      } else {
        x_stage(stage, az, std::false_type{});
      }
      __syncthreads();
      if (grp == 0) {
        yz(az, odd, zin, cur, std::integral_constant<int, 0>{});
      } else {
        yz(az, odd, zin, cur, std::integral_constant<int, 1>{});
      }
    }
    if (!odd) {
      // coarse plane cur's window ends at iz
      if (cur >= z0) {
        if (grp == 0) {
          write(cur, std::integral_constant<int, 0>{});
        } else {
          write(cur, std::integral_constant<int, 1>{});
        }
      }
#pragma unroll
      for (int i = 0; i < kEOut; ++i) {
        acc0[i] = acc1[i];
        acc1[i] = C(0);
      }
    }
  }
  // the last coarse plane's window ends on the plane past the grid
  if (ize & 1) {
    if (grp == 0) {
      write(ize >> 1, std::integral_constant<int, 0>{});
    } else {
      write(ize >> 1, std::integral_constant<int, 1>{});
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

// Whether the tables are collapsed form f's: the fine table is the form's,
// every a_z one step, the y and x interior rows the cell-centred ones and
// the output the 27 planes in order.
bool collapsed_holds(int f, const int32_t* fine, const float* interior, const Params& prm) {
  if (prm.nsteps != 3) return false;
  for (int i = 0; i < 36; ++i) {
    const float w = cell_weight(i / 9, i / 3 % 3, i % 3);
    if (interior[i] != w || interior[36 + i] != w) return false;
  }
  for (int i = 0; i < 27; ++i) {
    if (prm.out[i] != i || fine[i] != form_code(f, i / 9, i / 3 % 3, i % 3)) return false;
  }
  for (int az = 0; az < 3; ++az) {
    if (prm.step_az[az] != az) return false;
  }
  return true;
}

// Exact form f's parameters, false unless the tables are the form's: its
// fine table and output map, the planes in and out, and each axis's
// interior row, where its run holds any, the compiled-in one (interior:
// (3, taps, A, O) float32, y, x, z; runs: 6 int32, y, x, z).
bool exact_params(int f, const int32_t* fine, int a, const int32_t* omap, int o,
                  int64_t n_planes, int64_t n_out, const float* interior, const int32_t* runs,
                  ExactParams* p) {
  const int na = exact_a(f);
  if (a != na || o != kEO || n_planes != (f == kExact19 ? 10 : f == kExact117 ? 117 : 125) ||
      n_out != (f == kExact19 ? 117 : 125)) {
    return false;
  }
  for (int i = 0; i < na * na * na; ++i) {
    if (fine[i] != exact_code(f, i / (na * na), i / na % na, i % na)) return false;
    if (f == kExact19) p->code[i] = static_cast<signed char>(fine[i]);
  }
  for (int i = 0; i < kEO * kEO * kEO; ++i) {
    const int v = exact_out(f, i / 25, i / 5 % 5, i % 5);
    if (omap[i] != v) return false;
    p->out[i] = static_cast<short>(v);
  }
  const int w = kTaps * na * kEO;
  for (int k = 0; k < 3; ++k) {
    p->runs[2 * k] = runs[2 * k];
    p->runs[2 * k + 1] = runs[2 * k + 1];
    if (runs[2 * k] >= runs[2 * k + 1]) continue;
    for (int i = 0; i < w; ++i) {
      if (interior[k * w + i] != exact_weight(na / 2, i / (na * kEO), i / kEO % na, i % kEO)) {
        return false;
      }
    }
  }
  return true;
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
              int form, cudaStream_t stream) {
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
    const int f = form;
    if ((f == kCompressed19 || f == kStored27) && !collapsed_holds(f, fine, interior, prm)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
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
  if (form != kGeneric) return static_cast<int>(cudaErrorInvalidValue);
  return vec ? launch_v<T, A, O, V, kGeneric>(p, q, nz, ny, nx, cz, cy, cx, s, w, zchunk, prm,
                                             stream)
             : launch_v<T, A, O, 1, kGeneric>(p, q, nz, ny, nx, cz, cy, cx, s, w, zchunk, prm,
                                             stream);
}

template <typename T, int F, int V>
int launch_e(const T* planes, T* out, int64_t nz, int64_t ny, int64_t nx, int64_t cz,
             int64_t cy, int64_t cx, const float* weights, int64_t zchunk,
             const ExactParams& prm, cudaStream_t stream) {
  constexpr int smem = ESmem<T, F>::kBytes;
  auto* k = galerkin_product_kernel_exact<T, F, V>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = (cz + zchunk - 1) / zchunk;
  if (chunks > 65535 || mad::blocks_for(cy, kETy) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(mad::blocks_for(cx, kTx), mad::blocks_for(cy, kETy),
                  static_cast<unsigned>(chunks));
  k<<<grid, dim3(kTx, kEWarps), smem, stream>>>(
      planes, out, static_cast<int>(nz), static_cast<int>(ny), static_cast<int>(nx),
      static_cast<int>(cz), static_cast<int>(cy), static_cast<int>(cx), weights,
      static_cast<int>(zchunk), prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int F>
int launch_exact(const void* planes, void* out, int64_t n_planes, int64_t nz, int64_t ny,
                 int64_t nx, int64_t cz, int64_t cy, int64_t cx, const int32_t* fine,
                 int64_t a, const int32_t* omap, int64_t o, int64_t n_out,
                 const float* interior, const int32_t* runs, const void* weights,
                 int64_t zchunk, cudaStream_t stream) {
  ExactParams prm;
  if (nz != 2 * cz || ny != 2 * cy || nx != 2 * cx ||
      !exact_params(F, fine, static_cast<int>(a), omap, static_cast<int>(o), n_planes, n_out,
                    interior, runs, &prm)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* p = static_cast<const T*>(planes);
  T* q = static_cast<T*>(out);
  const float* w = static_cast<const float*>(weights);
  // 16-byte copies where every row starts on a 16-byte boundary
  constexpr int V = 16 / sizeof(T);
  return nx % V == 0 ? launch_e<T, F, V>(p, q, nz, ny, nx, cz, cy, cx, w, zchunk, prm, stream)
                     : launch_e<T, F, 1>(p, q, nz, ny, nx, cz, cy, cx, w, zchunk, prm, stream);
}

template <typename T>
int launch(const void* planes, void* out, int64_t n_planes, int64_t nz, int64_t ny,
           int64_t nx, int64_t cz, int64_t cy, int64_t cx, const void* host_fine,
           int64_t a, const void* host_out, int64_t o, int64_t n_out, const void* starts,
           const void* weights, const void* host_interior, const void* host_runs,
           int64_t zchunk, int64_t form, void* stream) {
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
  switch (form) {
    case kExact19:
      return launch_exact<T, kExact19>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, a, m, o,
                                       n_out, in, r, weights, zchunk, st);
    case kExact117:
      return launch_exact<T, kExact117>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, a, m,
                                        o, n_out, in, r, weights, zchunk, st);
    case kExact125:
      return launch_exact<T, kExact125>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, a, m,
                                        o, n_out, in, r, weights, zchunk, st);
    case kGeneric:
    case kCompressed19:
    case kStored27:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fm = static_cast<int>(form);
  if (a == 3 && o == 3) {
    return launch_ao<T, 3, 3>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in,
                              r, starts, weights, zchunk, fm, st);
  }
  if (a == 3) {
    return launch_ao<T, 3, 5>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in,
                              r, starts, weights, zchunk, fm, st);
  }
  if (o == 3) {
    return launch_ao<T, 5, 3>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in,
                              r, starts, weights, zchunk, fm, st);
  }
  return launch_ao<T, 5, 5>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, f, m, n_out, in, r,
                            starts, weights, zchunk, fm, st);
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
      const void* host_runs, int64_t zchunk, int64_t form, void* stream) {        \
    return launch<T>(planes, out, n_planes, nz, ny, nx, cz, cy, cx, host_fine, a, \
                     host_out, o, n_out, starts, weights, host_interior,          \
                     host_runs, zchunk, form, stream);                            \
  }

MAD_GALERKIN_ENTRY(f32, float)
MAD_GALERKIN_ENTRY(f64, double)
