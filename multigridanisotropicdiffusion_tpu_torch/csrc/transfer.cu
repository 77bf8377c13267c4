// 3D full-weighting restriction and linear prolongation, every centring.
//
// Replace the Pallas kernels `_restrict_kernel` (built by `_build_restrict`)
// and `_prolong_kernel` (built by `_build_prolong`) in
// multigridanisotropicdiffusion_tpu/ops/pallas_transfer.py.  The TPU kernels
// take only all-cell fields with X % 256 == 0 and leave every other level to
// XLA; these take every centring per axis and every shape.
//
// Both transfers are tensor products of 1-D operators with border rows.  The
// host builds, per axis, a table from the dense 1-D matrices
// (ops/transfer.py: restrict_taps / prolong_taps): for each output index the
// first input index and its weights, 4 per coarse index for restriction
// ([1] / [1/4 1/2 1/4] vertex, [1/2 3/8 1/8] / [1/8 3/8 3/8 1/8] cell) and 2
// per fine index for prolongation ((1), (1/2, 1/2) vertex; (1), (3/4, 1/4)
// cell).  A tap past the end of its row has weight 0 and a clamped index, so
// no read leaves the array.
//
//   restrict:  out[b,k,j,i] = sum wz[k,a] wy[j,c] wx[i,e] in[b, sz[k]+a, sy[j]+c, sx[i]+e]
//   prolong:   out[b,k,j,i] = the same sums over 2 taps per axis, x first,
//              then y, then z (P e), or x[b,k,j,i] + P e (the add form)
//
// A leading batch axis lets the six tensor planes be restricted in one
// launch.  Bound on the card: device-memory bandwidth (restriction reads 8
// fine values per coarse value written, prolongation writes 8 fine values
// per coarse value read).  The restriction issues ~190 SASS instructions
// per output (utils/sass_count.py) and waits on each plane's loads between
// its two barriers, which holds it at ~2/3 of that bound in float and ~1/3
// in bf16 on an H100.
//
// Restriction: a block of 1024 threads owns a tile of 14 x 64 coarse
// outputs, one per thread (512 threads and 8 rows in double), and marches
// down a run of kRZ coarse planes.  The fine tile those outputs read (at
// most 30 x 130 values, the y and x halo included) is found from the tables
// once per block and held in shared memory aligned down to a run.  Per
// coarse plane k, with fine planes s..s+3 (s = sz[k]):
//   z: each thread owns a run of 4 values of the fine tile (16 bytes of
//      f32, 8 of bf16; up to 3 runs of 2 f64; one value where a fine row
//      is not whole runs) and combines the four planes; where
//      sz[k] == sz[k-1] + 2 it reuses
//      the partial sum wz[k,0] u[s] + wz[k,1] u[s+1] formed from the
//      previous plane's two new planes, so only two fine planes are read
//      per coarse plane, each fine value about once (32-bit offsets inside
//      a batch plane; the next plane's loads are issued before this plane's
//      y and x run); the sums go to shared memory;
//   y, x: each thread combines, for each of its output's four columns, the
//      four rows, then the four columns, and stores (warps along x: 128
//      contiguous bytes in float).
// Every offset, weight and clamp of a thread is computed once per block.  A
// block whose fine tile does not fit (irregular tables: the block form's pad
// rows of weight 0 start at 0) computes each output on its own from device
// memory, in the same order.  Every product and sum rounds on its own (no
// fused multiply-add), z first, then y, then x, each in ascending tap
// order, in the compute type, rounded once at the store: restrict_plain's
// order (ops/transfer.py), and apply_taps_plain's with axes (0, 1, 2).  The
// tables' zero-weight taps are summed too (as apply_taps_plain sums them);
// on finite inputs they add a zero, which changes no nonzero sum.
//
// Prolongation: one thread owns 16 bytes of one fine row (4 float, 8 bf16 or
// 2 double outputs) and marches down a run of kPZ fine planes (16; 64 in
// bf16).  Its column
// starts and weights, and its row's, are read from the tables once; for each
// coarse plane it meets it forms the x-then-y interpolation of its outputs
// once and keeps the last two such planes in registers, so each fine plane
// costs two multiplies and an add per output and one 16-byte store (one
// 16-byte load of x in the add form).  Coarse values are read about once
// per fine row pair from L1.  The tables are read as they are, so the block
// form (per-axis tables shifted into a halo-extended block, pad rows of
// weight 0, parallel/transfer.py) runs this kernel too: a plane start that
// does not follow the previous one by one recomputes both planes.  Every
// product and sum rounds on its own (no fused multiply-add), in the plain
// version's order, so P e is that of ops/transfer.py's prolong_plain; the
// add form rounds P e to the storage type, then adds in the compute type and
// rounds once, so it is bit for bit x + (P e).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
// fine planes per prolongation block: bf16 rows hold twice the outputs per
// thread, and its blocks run longer before their stores saturate
template <typename T>
constexpr int kPZ = sizeof(T) == 2 ? 64 : 16;

// 16 bytes of storage type T to and from registers of the compute type;
// the store rounds each value once.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float (&v)[n]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* p, const float (&v)[n]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<double> {
  static constexpr int n = 2;
  __device__ static void load(const double* p, double (&v)[n]) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(double* p, const double (&v)[n]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;  // element 2w in the low half of word w
  __device__ static void load(const __nv_bfloat16* p, float (&v)[n]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[n]) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[2 * q]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[2 * q + 1])))
              << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The restriction's tile: TY x TX coarse outputs per block of NT threads;
// its fine tile of at most FY rows of FX values is held aligned down to V
// values (one load of a run of V values, or V = 1): NV loads per row, FXA
// values per row in shared memory; MP loads and one output per thread.
constexpr int kRZ = 8;  // coarse planes per restriction block
template <typename T, int V>
struct RTile {
  static constexpr int NT = sizeof(T) == 8 ? 512 : 1024;
  // 14 rows: the fine tile is 30 x 34 runs of 4 values, at most one per
  // thread
  static constexpr int TY = sizeof(T) == 8 ? 8 : 14;
  static constexpr int TX = 64;
  static constexpr int FY = 2 * TY + 2;
  static constexpr int FX = 2 * TX + 2;
  static constexpr int NV = (FX + 2 * (V - 1)) / V;
  static constexpr int FXA = NV * V;
  static constexpr int MP = (FY * NV + NT - 1) / NT;
  static_assert(TY * TX <= NT, "at most one output per thread");
};

// w0 a + w1 b + w2 c + w3 d, each product and sum rounded on its own, in
// ascending tap order.
template <typename A>
__device__ __forceinline__ A taps4(const A* w, A a, A b, A c, A d) {
  A t = mad::add_rn(mad::mul_rn(w[0], a), mad::mul_rn(w[1], b));
  t = mad::add_rn(t, mad::mul_rn(w[2], c));
  return mad::add_rn(t, mad::mul_rn(w[3], d));
}

// The restriction's run of fine values per load: 4 (16 bytes of float, 8
// of bf16) or 2 double (16 bytes).
template <typename T>
constexpr int kRun = sizeof(T) == 8 ? 2 : 4;

// V values of storage type T at p (aligned to V values where V > 1).
template <typename T, int V>
__device__ __forceinline__ void load_run(const T* p, typename mad::Compute<T>::type (&u)[V]) {
  if constexpr (V == 1) {
    u[0] = mad::load(p);
  } else if constexpr (sizeof(T) == 2) {
    static_assert(V == 4, "4 bf16 per load");
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    u[0] = __uint_as_float(t.x << 16);
    u[1] = __uint_as_float(t.x & 0xffff0000u);
    u[2] = __uint_as_float(t.y << 16);
    u[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
    Vec16<T>::load(p, u);
  }
}

// V > 1: every fine row is whole runs of V values (ix % V == 0, input
// aligned to V values).
template <typename T, int V>
__global__ void __launch_bounds__((RTile<T, V>::NT))
    restrict_kernel(const T* __restrict__ in, T* __restrict__ out, int iz, int iy,
                    int ix, int oz, int oy, int ox, int zruns,
                    const int32_t* __restrict__ sz,
                    const int32_t* __restrict__ sy,
                    const int32_t* __restrict__ sx,
                    const typename mad::Compute<T>::type* __restrict__ wz,
                    const typename mad::Compute<T>::type* __restrict__ wy,
                    const typename mad::Compute<T>::type* __restrict__ wx) {
  using A = typename mad::Compute<T>::type;
  using R = RTile<T, V>;
  __shared__ A tz[R::FY * R::FXA];
  __shared__ int s_sy[R::TY], s_sx[R::TX];
  __shared__ A s_wy[R::TY][4], s_wx[R::TX][4];
  __shared__ int s_lo[3], s_hi[3];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * R::TX;
  const int j0 = blockIdx.y * R::TY;
  const int batch = blockIdx.z / zruns;
  const int k0 = (blockIdx.z % zruns) * kRZ;
  const int k1 = min(k0 + kRZ, oz);
  const int nyt = min(R::TY, oy - j0);
  const int nxt = min(R::TX, ox - i0);

  // the block's tables, and the fine rows and columns they read
  int lo = INT_MAX, hi = -1;
  if (tid < R::TX) {
    const int i = i0 + min(tid, nxt - 1);
    const int s = sx[i];
    s_sx[tid] = s;
#pragma unroll
    for (int e = 0; e < 4; ++e) s_wx[tid][e] = wx[4 * i + e];
    if (tid < nxt) {
      lo = s;
      hi = min(s + 3, ix - 1);
    }
  } else if (tid >= 64 && tid < 64 + R::TY) {
    const int jj = tid - 64;
    const int j = j0 + min(jj, nyt - 1);
    const int s = sy[j];
    s_sy[jj] = s;
#pragma unroll
    for (int c = 0; c < 4; ++c) s_wy[jj][c] = wy[4 * j + c];
    if (jj < nyt) {
      lo = s;
      hi = min(s + 3, iy - 1);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (tid % 32 == 0 && tid < 96) {
    s_lo[tid / 32] = lo;
    s_hi[tid / 32] = hi;
  }
  __syncthreads();
  const int xa = min(s_lo[0], s_lo[1]) / V * V;  // the tile's first column
  const int xhi = max(s_hi[0], s_hi[1]);
  const int ylo = s_lo[2], yhi = s_hi[2];
  const int fy = yhi - ylo + 1, fx = xhi - xa + 1;
  const int64_t fplane = static_cast<int64_t>(iy) * ix;
  const T* src = in + static_cast<int64_t>(batch) * iz * fplane;
  T* dst = out + static_cast<int64_t>(batch) * oz * oy * ox;

  if (fy > R::FY || fx > R::FXA) {
    // irregular tables: each output from device memory, same order
    for (int k = k0; k < k1; ++k) {
      const A* w = wz + 4 * k;
      for (int o = tid; o < R::TY * R::TX; o += R::NT) {
        const int jj = o / R::TX, ii = o % R::TX;
        if (jj >= nyt || ii >= nxt) continue;
        A tyv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = min(s_sx[ii] + e, ix - 1);
          A tzv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const T* col = src + static_cast<int64_t>(min(s_sy[jj] + c, iy - 1)) * ix + x;
            A u[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) u[a] = mad::load(col + min(sz[k] + a, iz - 1) * fplane);
            tzv[c] = taps4(w, u[0], u[1], u[2], u[3]);
          }
          tyv[e] = taps4(s_wy[jj], tzv[0], tzv[1], tzv[2], tzv[3]);
        }
        mad::store(dst + (static_cast<int64_t>(k) * oy + j0 + jj) * ox + i0 + ii,
                   taps4(s_wx[ii], tyv[0], tyv[1], tyv[2], tyv[3]));
      }
    }
    return;
  }

  // this thread's runs of V fine tile values: offsets inside a fine plane
  // (0 for a slot past the tile, whose loads are discarded), which slots
  // are in, and where each run sits in the shared tile
  int off[R::MP], at[R::MP];
  unsigned in_tile = 0;
#pragma unroll
  for (int m = 0; m < R::MP; ++m) {
    const int p = tid + m * R::NT;
    const int r = p / R::NV, c = p % R::NV * V;
    const bool ok = r < fy && c < fx;
    off[m] = ok ? (ylo + r) * ix + xa + c : 0;
    at[m] = r * R::FXA + c;
    in_tile |= static_cast<unsigned>(ok) << m;
  }
  // this thread's output (jj, ii): its rows and columns of the fine tile
  // (clamped as the tables clamp them) and its weights
  const int jj = min(tid / R::TX, R::TY - 1), ii = tid % R::TX;
  const bool out_ok = tid < R::TY * R::TX && jj < nyt && ii < nxt;
  int rows[4], cols[4];
  A wyv[4], wxv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    rows[c] = (min(s_sy[jj] + c, iy - 1) - ylo) * R::FXA;
    cols[c] = min(s_sx[ii] + c, ix - 1) - xa;
    wyv[c] = s_wy[jj][c];
    wxv[c] = s_wx[ii][c];
  }
  const int64_t obase = static_cast<int64_t>(j0 + jj) * ox + i0 + ii;
  // every load of a plane is issued before any is used
  auto load_plane = [&](int z, A(&u)[R::MP][V]) {
    const T* pz = src + min(z, iz - 1) * fplane;
#pragma unroll
    for (int m = 0; m < R::MP; ++m) load_run<T, V>(pz + off[m], u[m]);
  };
  A part[R::MP][V];  // wz[k,0] u[s] + wz[k,1] u[s+1] for the next plane
  A u2[R::MP][V], u3[R::MP][V];  // fine planes s + 2 and s + 3
  bool have = false;  // part holds this plane's partial sums
  bool ahead = false;  // u2, u3 hold this plane's new fine planes
  for (int k = k0; k < k1; ++k) {
    const int s = sz[k];
    const A w[4] = {wz[4 * k], wz[4 * k + 1], wz[4 * k + 2], wz[4 * k + 3]};
    const bool next = k + 1 < k1 && sz[k + 1] == s + 2;
    const A v0 = next ? wz[4 * k + 4] : A(0);
    const A v1 = next ? wz[4 * k + 5] : A(0);
    if (!have) {
      load_plane(s, u2);
      load_plane(s + 1, u3);
#pragma unroll
      for (int m = 0; m < R::MP; ++m) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          part[m][q] = mad::add_rn(mad::mul_rn(w[0], u2[m][q]), mad::mul_rn(w[1], u3[m][q]));
        }
      }
    }
    if (!ahead) {
      load_plane(s + 2, u2);
      load_plane(s + 3, u3);
    }
#pragma unroll
    for (int m = 0; m < R::MP; ++m) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (in_tile >> m & 1u) {
          const A t = mad::add_rn(part[m][q], mad::mul_rn(w[2], u2[m][q]));
          tz[at[m] + q] = mad::add_rn(t, mad::mul_rn(w[3], u3[m][q]));
        }
        part[m][q] = mad::add_rn(mad::mul_rn(v0, u2[m][q]), mad::mul_rn(v1, u3[m][q]));
      }
    }
    // the next plane's two new fine planes load while y and x run
    have = ahead = next;
    if (next) {
      load_plane(s + 4, u2);
      load_plane(s + 5, u3);
    }
    __syncthreads();

    // this thread's output: y over the four rows of each of its four
    // columns, then x
    if (out_ok) {
      A tyv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tyv[e] = taps4(wyv, tz[rows[0] + cols[e]], tz[rows[1] + cols[e]],
                       tz[rows[2] + cols[e]], tz[rows[3] + cols[e]]);
      }
      mad::store(dst + obase + static_cast<int64_t>(k) * oy * ox,
                 taps4(wxv, tyv[0], tyv[1], tyv[2], tyv[3]));
    }
    __syncthreads();
  }
}

// Two taps, each product and the sum rounded on its own.
template <typename A>
__device__ __forceinline__ A lerp2(A w0, A a, A w1, A b) {
  return mad::add_rn(mad::mul_rn(w0, a), mad::mul_rn(w1, b));
}

// The value as the storage type rounds it, back in the compute type.
template <typename T>
__device__ __forceinline__ typename mad::Compute<T>::type rounded(
    typename mad::Compute<T>::type v) {
  T t;
  mad::store(&t, v);
  return mad::load(&t);
}

// kAdd: out = x + P e; kVec: every row is whole 16-byte vectors (fx % V == 0,
// pointers aligned), else each output is stored on its own with a bound test.
template <typename T, bool kAdd, bool kVec>
__global__ void __launch_bounds__(kBX * kBY)
    prolong_kernel(const T* __restrict__ in, const T* __restrict__ xin,
                   T* __restrict__ out, int cz, int cy, int cx, int fz, int fy,
                   int fx, int zblocks, const int32_t* __restrict__ sz,
                   const int32_t* __restrict__ sy,
                   const int32_t* __restrict__ sx,
                   const typename mad::Compute<T>::type* __restrict__ wz,
                   const typename mad::Compute<T>::type* __restrict__ wy,
                   const typename mad::Compute<T>::type* __restrict__ wx) {
  using A = typename mad::Compute<T>::type;
  constexpr int V = Vec16<T>::n;
  const int i0 = (blockIdx.x * kBX + threadIdx.x) * V;
  const int j = blockIdx.y * kBY + threadIdx.y;
  if (i0 >= fx || j >= fy) return;
  const int batch = blockIdx.z / zblocks;
  const int k0 = (blockIdx.z % zblocks) * kPZ<T>;
  const int k1 = min(k0 + kPZ<T>, fz);
  const int64_t cplane = static_cast<int64_t>(cy) * cx;
  const T* src = in + batch * (cz * cplane);

  int c0[V], c1[V];
  A w0[V], w1[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int i = min(i0 + q, fx - 1);
    c0[q] = sx[i];
    c1[q] = min(c0[q] + 1, cx - 1);
    w0[q] = wx[2 * i];
    w1[q] = wx[2 * i + 1];
  }
  const int64_t r0 = static_cast<int64_t>(sy[j]) * cx;
  const int64_t r1 = static_cast<int64_t>(min(sy[j] + 1, cy - 1)) * cx;
  const A wy0 = wy[2 * j];
  const A wy1 = wy[2 * j + 1];

  // the x-then-y interpolation of this thread's outputs on coarse plane z
  auto plane = [&](int z, A(&p)[V]) {
    const T* a = src + z * cplane + r0;
    const T* b = src + z * cplane + r1;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const A ax = lerp2(w0[q], mad::load(a + c0[q]), w1[q], mad::load(a + c1[q]));
      const A bx = lerp2(w0[q], mad::load(b + c0[q]), w1[q], mad::load(b + c1[q]));
      p[q] = lerp2(wy0, ax, wy1, bx);
    }
  };

  A lo[V], hi[V];
  int cur = -2;  // coarse plane held in lo
  for (int k = k0; k < k1; ++k) {
    const int s = sz[k];
    if (s != cur) {
      if (s == cur + 1) {
#pragma unroll
        for (int q = 0; q < V; ++q) lo[q] = hi[q];
      } else {
        plane(s, lo);
      }
      plane(min(s + 1, cz - 1), hi);
      cur = s;
    }
    const A wz0 = wz[2 * k];
    const A wz1 = wz[2 * k + 1];
    const int64_t row = ((static_cast<int64_t>(batch) * fz + k) * fy + j) * fx;
    A v[V];
    if constexpr (kAdd) {
      if constexpr (kVec) {
        Vec16<T>::load(xin + row + i0, v);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          if (i0 + q < fx) v[q] = mad::load(xin + row + i0 + q);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const A pe = lerp2(wz0, lo[q], wz1, hi[q]);
      if constexpr (kAdd) {
        v[q] = mad::add_rn(v[q], rounded<T>(pe));
      } else {
        v[q] = pe;
      }
    }
    if constexpr (kVec) {
      Vec16<T>::store(out + row + i0, v);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (i0 + q < fx) mad::store(out + row + i0 + q, v[q]);
      }
    }
  }
}

template <typename T>
int launch_restrict(const void* in, void* out, int64_t batch, int64_t iz,
                    int64_t iy, int64_t ix, int64_t oz, int64_t oy, int64_t ox,
                    const void* sz, const void* sy, const void* sx,
                    const void* wz, const void* wy, const void* wx,
                    void* stream) {
  using A = typename mad::Compute<T>::type;
  constexpr int V = kRun<T>;
  const bool vec = ix % V == 0 && reinterpret_cast<uintptr_t>(in) % (V * sizeof(T)) == 0;
  const int64_t zruns = (oz + kRZ - 1) / kRZ;
  const dim3 grid(mad::blocks_for(ox, RTile<T, V>::TX), mad::blocks_for(oy, RTile<T, V>::TY),
                  static_cast<unsigned>(batch * zruns));
  auto kernel = vec ? restrict_kernel<T, V> : restrict_kernel<T, 1>;
  kernel<<<grid, RTile<T, V>::NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<int>(iz),
      static_cast<int>(iy), static_cast<int>(ix), static_cast<int>(oz),
      static_cast<int>(oy), static_cast<int>(ox), static_cast<int>(zruns),
      static_cast<const int32_t*>(sz), static_cast<const int32_t*>(sy),
      static_cast<const int32_t*>(sx), static_cast<const A*>(wz),
      static_cast<const A*>(wy), static_cast<const A*>(wx));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAdd>
int launch_prolong(const void* in, const void* x, void* out, int64_t batch,
                   int64_t cz, int64_t cy, int64_t cx, int64_t fz, int64_t fy,
                   int64_t fx, const void* sz, const void* sy, const void* sx,
                   const void* wz, const void* wy, const void* wx, void* stream) {
  using A = typename mad::Compute<T>::type;
  constexpr int V = Vec16<T>::n;
  const int64_t zblocks = (fz + kPZ<T> - 1) / kPZ<T>;
  const bool vec = fx % V == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (!kAdd || reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(fx, kBX * V), mad::blocks_for(fy, kBY),
                  static_cast<unsigned>(batch * zblocks));
  auto kernel = vec ? prolong_kernel<T, kAdd, true> : prolong_kernel<T, kAdd, false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<int>(cz), static_cast<int>(cy), static_cast<int>(cx),
      static_cast<int>(fz), static_cast<int>(fy), static_cast<int>(fx),
      static_cast<int>(zblocks), static_cast<const int32_t*>(sz),
      static_cast<const int32_t*>(sy), static_cast<const int32_t*>(sx),
      static_cast<const A*>(wz), static_cast<const A*>(wy),
      static_cast<const A*>(wx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MAD_TRANSFER_ENTRY(SUF, T)                                            \
  extern "C" int mad_restrict3d_##SUF(                                        \
      const void* in, void* out, int64_t batch, int64_t fz, int64_t fy,       \
      int64_t fx, int64_t cz, int64_t cy, int64_t cx, const void* sz,         \
      const void* sy, const void* sx, const void* wz, const void* wy,         \
      const void* wx, void* stream) {                                         \
    return launch_restrict<T>(in, out, batch, fz, fy, fx, cz, cy, cx, sz, sy, \
                              sx, wz, wy, wx, stream);                        \
  }                                                                           \
  extern "C" int mad_prolong3d_##SUF(                                         \
      const void* in, void* out, int64_t batch, int64_t cz, int64_t cy,       \
      int64_t cx, int64_t fz, int64_t fy, int64_t fx, const void* sz,         \
      const void* sy, const void* sx, const void* wz, const void* wy,         \
      const void* wx, void* stream) {                                         \
    return launch_prolong<T, false>(in, nullptr, out, batch, cz, cy, cx, fz,  \
                                    fy, fx, sz, sy, sx, wz, wy, wx, stream);  \
  }                                                                           \
  extern "C" int mad_prolong_add3d_##SUF(                                     \
      const void* in, const void* x, void* out, int64_t batch, int64_t cz,    \
      int64_t cy, int64_t cx, int64_t fz, int64_t fy, int64_t fx,             \
      const void* sz, const void* sy, const void* sx, const void* wz,         \
      const void* wy, const void* wx, void* stream) {                         \
    return launch_prolong<T, true>(in, x, out, batch, cz, cy, cx, fz, fy, fx, \
                                   sz, sy, sx, wz, wy, wx, stream);           \
  }

MAD_FOR_EACH_TYPE(MAD_TRANSFER_ENTRY)
