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
// per coarse value read).
//
// Restriction: one thread per output cell, threads along x, grid over
// (x-blocks, y-blocks, batch * z), 64-bit element offsets; the repeated tap
// reads of neighbouring threads hit L1/L2.
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
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
// fine planes per prolongation block: bf16 rows hold twice the outputs per
// thread, and its blocks run longer before their stores saturate
template <typename T>
constexpr int kPZ = sizeof(T) == 2 ? 64 : 16;

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
    restrict_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t iz,
                    int64_t iy, int64_t ix, int64_t oz, int64_t oy, int64_t ox,
                    const int32_t* __restrict__ sz,
                    const int32_t* __restrict__ sy,
                    const int32_t* __restrict__ sx,
                    const typename mad::Compute<T>::type* __restrict__ wz,
                    const typename mad::Compute<T>::type* __restrict__ wy,
                    const typename mad::Compute<T>::type* __restrict__ wx) {
  using A = typename mad::Compute<T>::type;
  constexpr int kTaps = 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBY + threadIdx.y;
  if (i >= ox || j >= oy) return;
  const int64_t batch = blockIdx.z / oz;
  const int64_t k = blockIdx.z % oz;
  const T* src = in + batch * (iz * iy * ix);

  A acc = 0;
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
    const int64_t z = mad::imin(sz[k] + a, iz - 1);
    A acc_y = 0;
#pragma unroll
    for (int c = 0; c < kTaps; ++c) {
      const int64_t y = mad::imin(sy[j] + c, iy - 1);
      const T* row = src + (z * iy + y) * ix;
      A acc_x = 0;
#pragma unroll
      for (int e = 0; e < kTaps; ++e) {
        const int64_t x = mad::imin(sx[i] + e, ix - 1);
        acc_x += wx[i * kTaps + e] * mad::load(row + x);
      }
      acc_y += wy[j * kTaps + c] * acc_x;
    }
    acc += wz[k * kTaps + a] * acc_y;
  }
  mad::store(out + batch * (oz * oy * ox) + (k * oy + j) * ox + i, acc);
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
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(ox, kBX), mad::blocks_for(oy, kBY),
                  static_cast<unsigned>(batch * oz));
  restrict_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), iz, iy, ix, oz, oy, ox,
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
