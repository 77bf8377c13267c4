// The VED vesselness pipeline's per-voxel kernels: the fused finite-
// difference Hessian + eigenvalues + vesselness + running best-select (B8),
// the final diffusion-tensor assembly (B9), the standalone finite-
// difference Hessian of hessian(mode='smooth_fd') (B11), and the
// eigenvalues + vesselness + running best-select of a given Hessian stack
// (B15, the gaussian_derivative pipeline's per-scale step).
//
// Replace the Pallas kernels `_fdv_kernel` (built by `_build_fdv`) and
// `_assembly_kernel` (built by `_build_assembly`) in
// multigridanisotropicdiffusion_tpu/ops/pallas_vesselness.py, and `_fd_kernel`
// (built by `_build_fd`) in multigridanisotropicdiffusion_tpu/ops/
// pallas_conv.py.  B8 and B11 share one FD stencil (`fd_stencil`), as the
// Pallas kernels share `_fd_plane_blocks`.  B15 replaces no Pallas kernel:
// the JAX package leaves the gaussian_derivative pipeline's eigensolves to
// XLA, which fuses them, where PyTorch would run them as ~90 eager
// elementwise passes over whole planes per scale; it is B8 without its FD
// stencil, and B8 and B15 share one copy of the per-voxel eigenvalues and
// response (`sorted_eigenvalues`, `response`) and of the plane stores.  The formulas
// are those of models/ved.py (`vesselness_measure`, `_make_assemble_fn`) and
// ops/eigen3.py (`eigh3`), written out here; the TPU's polynomial arccos is
// replaced by acos.
//
// B8, per output voxel (k, j, i) of a valid-z smoothed field us (Z+2, Y, X):
//   h   = the six scaled central second differences of us (19 points; z has
//         a 1-plane halo, y and x replicate the edge), in the compute type;
//   w   = the analytic eigenvalues of the UNROUNDED h (only the stored
//         planes are rounded to the storage type, as the TPU kernel does);
//   l   = w sorted by |value| (3-swap network); resp = vesselness(l);
//   first scale:  best <- (resp, round(h));
//   later scales: where resp > best_resp, best <- (resp, round(h)).
// The select is pointwise, so the later scales update the best planes IN
// PLACE: no two threads touch one voxel, and a voxel whose response does not
// win is neither read (its Hessian) nor written.
// B11, per output voxel: h as in B8, each plane rounded to the storage type
//   into a (6, Z, Y, X) stack.
// B15, per voxel of a (6, Z, Y, X) Hessian stack h in the storage type:
//   resp = vesselness(sort_by_abs(eigenvalues(h widened to the compute
//          type))), as models/ved.py's generic per-scale body computes it;
//   first scale:  best_resp <- resp (the caller adopts h itself as the best
//                 Hessian: nothing is copied);
//   later scales: where resp > best_resp, best <- (resp, h), in place.
// B9, per voxel: q3 = the eigenvector of the largest eigenvalue of h,
//   v = max(resp, 0)^(1/sensitivity), T = d1 I + (d3 - d1) q3 q3^T with
//   d1 = 1 + (eps - 1) v, d3 - d1 = (omega - eps) v; the identity where v <= 0.
//
// Every arithmetic operation rounds on its own (the Rn type below: no
// contraction into fused multiply-adds) and runs in the order of the plain
// PyTorch versions (ops/eigen3.py, models/ved.py), which round once per op.
// The two then agree to the last bit wherever acos, cos, exp and pow agree,
// so they make the same select decisions.  Clamps and maxima propagate NaN
// as torch.clamp / torch.maximum do (CUDA's fminf / fmaxf would return the
// other operand): a near-isotropic Hessian with a tiny nonzero p gives
// r = 0 * inf = NaN, and both versions must then give the same response.
//
// B8's design: a block of 32 x 8 threads owns a (y, x) tile and marches
// down a run of kVZ output planes, one voxel per thread per plane.  Each
// plane of us is staged once into shared memory with its 1-voxel y/x ring
// (edge replication is a clamp at staging time), four planes in a ring so
// that the next plane's loads are in flight while one plane is computed;
// the thread's own column of planes k - 1, k, k + 1 stays in registers and
// the rest of the 19-point stencil is read from shared memory.  The first
// scale and the select are two instantiations.  A voxel that is not bright
// (l2 >= 0 or l3 >= 0, or NaN) has response 0 without the four exp and the
// four divisions of the vesselness.  1 / x is the correctly rounded
// reciprocal, which IEEE 754 makes the same bits as the division 1 / x.
//
// Bound on the card, 512^3 float32.  B8 reads 514 planes of us; the first
// scale writes 7 planes (4.3 GB, 1.28 ms at 3.35 TB/s); a later scale
// reads the best response and writes the 7 values of the voxels it wins
// (~11% on the phantom: 1.48 GB, 0.44 ms).  Its plain formulas need ~197
// float operations per voxel and ~110 more for the vesselness of a bright
// voxel (~23%), each math-library call counted as it compiles on its own
// (utils/sass_count.py --math): 0.44 ms at 67 TFLOP/s, as long as the
// select's bytes.  The kernel issues ~570 instructions per voxel in its
// plane loop, separately rounded, the vesselness whenever one voxel of the
// warp is bright, so B8 is issue-bound, and the select's winners write 7
// scattered values each, partial 32-byte sectors of every plane.  B11
// reads 514 planes and writes 6 volumes (3.76 GB, 1.12 ms; 24
// operations per voxel).  B9 reads 7 planes and writes 6 (6.98 GB, 2.08 ms;
// ~265 operations per voxel).  B9 and B11: one thread per voxel, threads
// along x (coalesced plane access); B11's 19 reads of us per voxel hit
// L1/L2, since neighbouring threads share them.
//
// B15's bound, 512^3 float32, per scale: the first scale reads 6 planes and
// writes the response (3.76 GB, 1.12 ms at 3.35 TB/s); a later scale also
// reads the best response and writes the 7 values of the voxels it wins
// (~11% on the phantom: ~4.2 GB, ~1.25 ms); B8's operations without its FD
// stencil and with products for its three divisions, ~0.38 ms at 67
// TFLOP/s.  Its design: no stencil, so no shared memory and no plane march;
// the volume is flat, and each thread takes 4 voxels a block's width apart,
// so that every load and every store of a warp covers 32 consecutive voxels
// of a plane: whole 32-byte sectors, the winners' stores of a select scale
// included (runs of 4 consecutive voxels a thread, read as 16-byte vectors,
// would scatter those stores over partial sectors).  As in B8, a voxel that
// is not bright skips the vesselness, and a voxel that does not win is
// neither read (its Hessian) nor written.
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kVZ = 16;  // output planes per B8 block

// A value of the compute type whose operations round one by one.
template <typename A>
struct Rn {
  A v;
  Rn() = default;
  __host__ __device__ constexpr Rn(A x) : v(x) {}
};

// The math library's float and double functions (torch calls the same ones).
__device__ __forceinline__ float m_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double m_sqrt(double a) { return ::sqrt(a); }
__device__ __forceinline__ float m_rsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double m_rsqrt(double a) { return ::rsqrt(a); }
__device__ __forceinline__ float m_acos(float a) { return acosf(a); }
__device__ __forceinline__ double m_acos(double a) { return ::acos(a); }
__device__ __forceinline__ float m_cos(float a) { return cosf(a); }
__device__ __forceinline__ double m_cos(double a) { return ::cos(a); }
__device__ __forceinline__ float m_exp(float a) { return expf(a); }
__device__ __forceinline__ double m_exp(double a) { return ::exp(a); }
__device__ __forceinline__ float m_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double m_pow(double a, double b) { return ::pow(a, b); }
__device__ __forceinline__ float m_rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double m_rcp(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float m_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double m_abs(double a) { return ::fabs(a); }

template <typename A>
__device__ __forceinline__ Rn<A> operator+(Rn<A> a, Rn<A> b) { return mad::add_rn(a.v, b.v); }
template <typename A>
__device__ __forceinline__ Rn<A> operator-(Rn<A> a, Rn<A> b) { return mad::sub_rn(a.v, b.v); }
template <typename A>
__device__ __forceinline__ Rn<A> operator*(Rn<A> a, Rn<A> b) { return mad::mul_rn(a.v, b.v); }
template <typename A>
__device__ __forceinline__ Rn<A> operator/(Rn<A> a, Rn<A> b) { return mad::div_rn(a.v, b.v); }
template <typename A>
__device__ __forceinline__ Rn<A> operator-(Rn<A> a) { return -a.v; }
template <typename A>
__device__ __forceinline__ bool operator<(Rn<A> a, Rn<A> b) { return a.v < b.v; }
template <typename A>
__device__ __forceinline__ bool operator>(Rn<A> a, Rn<A> b) { return a.v > b.v; }
template <typename A>
__device__ __forceinline__ bool operator<=(Rn<A> a, Rn<A> b) { return a.v <= b.v; }
template <typename A>
__device__ __forceinline__ bool operator>=(Rn<A> a, Rn<A> b) { return a.v >= b.v; }

template <typename A>
__device__ __forceinline__ Rn<A> where(bool c, Rn<A> a, Rn<A> b) { return c ? a : b; }
template <typename A>
__device__ __forceinline__ Rn<A> abs(Rn<A> a) { return m_abs(a.v); }
// 1 / a, correctly rounded: the same value as the division 1 / a
template <typename A>
__device__ __forceinline__ Rn<A> recip(Rn<A> a) { return m_rcp(a.v); }
template <typename A>
__device__ __forceinline__ Rn<A> sqrt(Rn<A> a) { return m_sqrt(a.v); }
template <typename A>
__device__ __forceinline__ Rn<A> rsqrt(Rn<A> a) { return m_rsqrt(a.v); }
template <typename A>
__device__ __forceinline__ Rn<A> acos(Rn<A> a) { return m_acos(a.v); }
template <typename A>
__device__ __forceinline__ Rn<A> cos(Rn<A> a) { return m_cos(a.v); }
template <typename A>
__device__ __forceinline__ Rn<A> exp(Rn<A> a) { return m_exp(a.v); }
template <typename A>
__device__ __forceinline__ Rn<A> pow(Rn<A> a, Rn<A> b) { return m_pow(a.v, b.v); }
// torch.maximum: NaN in either operand gives NaN
template <typename A>
__device__ __forceinline__ Rn<A> maxnan(Rn<A> a, Rn<A> b) {
  return (a.v != a.v || a.v > b.v) ? a : b;
}
// torch.clamp(x, lo, hi): NaN stays NaN
template <typename A>
__device__ __forceinline__ Rn<A> clampnan(Rn<A> x, Rn<A> lo, Rn<A> hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename A>
struct Vec3 {
  Rn<A> x, y, z;
};
template <typename A>
__device__ __forceinline__ Vec3<A> cross(Vec3<A> u, Vec3<A> v) {
  return {u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z, u.x * v.y - u.y * v.x};
}
template <typename A>
__device__ __forceinline__ Rn<A> dot(Vec3<A> u, Vec3<A> v) {
  return u.x * v.x + u.y * v.y + u.z * v.z;
}
template <typename A>
__device__ __forceinline__ Vec3<A> scaled(Vec3<A> u, Rn<A> s) {
  return {u.x * s, u.y * s, u.z * s};
}
template <typename A>
__device__ __forceinline__ Vec3<A> pick(bool c, Vec3<A> u, Vec3<A> v) {
  return c ? u : v;
}

// Symmetric matrix in symfield order (a00, a01, a02, a11, a12, a22).
template <typename A>
struct Sym {
  Rn<A> a00, a01, a02, a11, a12, a22;
};

// ops/eigen3.py `_scaled_eigenvalues`: the entries of A / max|A|, the
// scaled eigenvalues (lo, mid, hi) and the scale.
template <typename A>
struct Scaled {
  Sym<A> a;
  Rn<A> lo, mid, hi, scale;
};

template <typename A>
__device__ __forceinline__ Scaled<A> scaled_eigenvalues(Sym<A> m) {
  const Rn<A> zero = A(0), one = A(1);
  const Rn<A> scale = maxnan(
      maxnan(maxnan(abs(m.a00), abs(m.a11)), abs(m.a22)),
      maxnan(maxnan(abs(m.a01), abs(m.a02)), abs(m.a12)));
  const Rn<A> scale_safe = where(scale > zero, scale, one);
  const Rn<A> inv_scale = recip(scale_safe);
  Sym<A> a{m.a00 * inv_scale, m.a01 * inv_scale, m.a02 * inv_scale,
           m.a11 * inv_scale, m.a12 * inv_scale, m.a22 * inv_scale};

  const Rn<A> q = (a.a00 + a.a11 + a.a22) * Rn<A>(A(1.0 / 3.0));
  const Rn<A> p1 = a.a01 * a.a01 + a.a02 * a.a02 + a.a12 * a.a12;
  const Rn<A> b00 = a.a00 - q, b11 = a.a11 - q, b22 = a.a22 - q;
  const Rn<A> p2 = b00 * b00 + b11 * b11 + b22 * b22 + Rn<A>(A(2)) * p1;
  const Rn<A> p = sqrt(maxnan(p2 * Rn<A>(A(1.0 / 6.0)), zero));
  const Rn<A> p_safe = where(p > zero, p, one);

  const Rn<A> detb = b00 * (b11 * b22 - a.a12 * a.a12) -
                     a.a01 * (a.a01 * b22 - a.a12 * a.a02) +
                     a.a02 * (a.a01 * a.a12 - b11 * a.a02);
  const Rn<A> inv_p = recip(p_safe);
  const Rn<A> inv_p3 = inv_p * inv_p * inv_p;
  const Rn<A> r = clampnan(detb * inv_p3 * Rn<A>(A(0.5)), -one, one);
  const Rn<A> phi = acos(r) * Rn<A>(A(1.0 / 3.0));

  const Rn<A> c = cos(phi);
  const Rn<A> s = sqrt(maxnan(one - c * c, zero));
  const Rn<A> two_p = Rn<A>(A(2)) * p;
  const Rn<A> hi = q + two_p * c;
  const Rn<A> lo = q + two_p * (Rn<A>(A(-0.5)) * c -
                                Rn<A>(A(0.8660254037844386)) * s);
  const Rn<A> mid = Rn<A>(A(3)) * q - hi - lo;
  return {a, lo, mid, hi, scale_safe};
}

// The three divisors of the vesselness, 2 alpha^2, 2 beta^2 and 2 gamma^2
// (B8 divides by them).
template <typename A>
struct Divisors {
  A d[3];
};
// Their reciprocals, each rounded in the compute type (B15 multiplies by
// them): PyTorch on the card divides a tensor by a Python number as a
// product with the number's reciprocal (on the CPU it divides), and B15 is
// held bit for bit to that eager path.
template <typename A>
struct Reciprocals {
  A r[3];
};

template <typename A>
__device__ __forceinline__ Rn<A> over(Rn<A> x, const Divisors<A>& dv, int i) {
  return x / Rn<A>(dv.d[i]);
}
template <typename A>
__device__ __forceinline__ Rn<A> over(Rn<A> x, const Reciprocals<A>& rc, int i) {
  return x * Rn<A>(rc.r[i]);
}

// models/ved.py `vesselness_measure` on |value|-ascending eigenvalues of a
// bright voxel (l2 < 0 and l3 < 0); any other voxel's response is 0.  D:
// Divisors or Reciprocals.
template <typename A, typename D>
__device__ __forceinline__ Rn<A> vesselness_bright(Rn<A> l1, Rn<A> l2, Rn<A> l3,
                                                    const D& dv) {
  const Rn<A> one = A(1);
  const Rn<A> c = A(1e-5);
  const Rn<A> inv2 = recip(l2);
  const Rn<A> inv3 = recip(l3);
  const Rn<A> ra = l2 * inv3;
  const Rn<A> ra2 = ra * ra;
  const Rn<A> rb2 = (l1 * l1) * abs(inv2 * inv3);
  const Rn<A> s2 = l1 * l1 + l2 * l2 + l3 * l3;
  const Rn<A> smooth = exp(-(Rn<A>(A(2)) * c * c) * abs(inv2) * (inv3 * inv3));
  const Rn<A> ea = exp(over(-ra2, dv, 0));
  const Rn<A> eb = exp(over(-rb2, dv, 1));
  const Rn<A> eg = exp(over(-s2, dv, 2));
  return smooth * (one - ea) * eb * (one - eg);
}

template <typename A>
__device__ __forceinline__ void swap_abs(Rn<A>& a, Rn<A>& b) {
  if (abs(a) > abs(b)) {
    const Rn<A> t = a;
    a = b;
    b = t;
  }
}

// ops/eigen3.py `sort_by_abs3(eigvalsh3(h))` at one voxel of h, and whether
// the voxel is bright (l2 < 0 and l3 < 0; NaN is not).
template <typename A>
struct Sorted {
  Rn<A> l0, l1, l2;
  bool bright;
};

template <typename A>
__device__ __forceinline__ Sorted<A> sorted_eigenvalues(const Sym<A>& hv) {
  const Scaled<A> e = scaled_eigenvalues(hv);
  Rn<A> l0 = e.lo * e.scale, l1 = e.mid * e.scale, l2 = e.hi * e.scale;
  swap_abs(l0, l1);
  swap_abs(l1, l2);
  swap_abs(l0, l1);
  return {l0, l1, l2, l1.v < A(0) && l2.v < A(0)};
}

// models/ved.py `vesselness_measure` of sorted eigenvalues: a voxel that is
// not bright has response 0 without the four exp and the four divisions.
template <typename A, typename D>
__device__ __forceinline__ A response(const Sorted<A>& l, const D& dv) {
  return l.bright ? vesselness_bright(l.l0, l.l1, l.l2, dv).v : A(0);
}

// The six scaled central second differences (symfield order) of a valid-z
// smoothed field, from S(dz, dy, dx), the field at the output voxel's
// point offset by dz, dy, dx in {-1, 0, 1} (z from the 1-plane halo, y and x
// neighbours clamped at the global borders: edge replication), in the
// compute type, unrounded.
template <typename A, typename F>
__device__ __forceinline__ Sym<A> fd_stencil(F S, const Sym<A>& facs) {
  const Rn<A> two = A(2);
  const Rn<A> c = S(0, 0, 0);
  Sym<A> hv;
  hv.a00 = (S(1, 0, 0) - two * c + S(-1, 0, 0)) * facs.a00;
  hv.a01 = (S(1, 1, 0) - S(1, -1, 0) - S(-1, 1, 0) + S(-1, -1, 0)) * facs.a01;
  hv.a02 = (S(1, 0, 1) - S(1, 0, -1) - S(-1, 0, 1) + S(-1, 0, -1)) * facs.a02;
  hv.a11 = (S(0, 1, 0) - two * c + S(0, -1, 0)) * facs.a11;
  hv.a12 = (S(0, 1, 1) - S(0, 1, -1) - S(0, -1, 1) + S(0, -1, -1)) * facs.a12;
  hv.a22 = (S(0, 0, 1) - two * c + S(0, 0, -1)) * facs.a22;
  return hv;
}

// fd_stencil at output voxel (k, j, i) of us (Z + 2, Y, X), read from
// device memory.
template <typename T>
__device__ __forceinline__ Sym<typename mad::Compute<T>::type> fd_hessian_at(
    const T* __restrict__ us, int64_t k, int64_t j, int64_t i, int64_t ny,
    int64_t nx, const Sym<typename mad::Compute<T>::type>& facs) {
  using A = typename mad::Compute<T>::type;
  const int64_t plane = ny * nx;
  const int64_t yp = j + 1 < ny ? nx : 0;
  const int64_t ym = j > 0 ? -nx : 0;
  const int64_t xp = i + 1 < nx ? 1 : 0;
  const int64_t xm = i > 0 ? -1 : 0;
  const T* c0 = us + (k + 1) * plane + j * nx + i;  // the 1-plane z halo
  auto S = [&](int dz, int dy, int dx) -> Rn<A> {
    return mad::load(c0 + dz * plane + (dy > 0 ? yp : dy < 0 ? ym : 0) +
                     (dx > 0 ? xp : dx < 0 ? xm : 0));
  };
  return fd_stencil<A>(S, facs);
}

// The six planes of h at flat voxel o of an n-voxel volume, rounded to T.
template <typename T, typename A>
__device__ __forceinline__ void store_planes(T* __restrict__ h, int64_t n,
                                             int64_t o, const Sym<A>& hv) {
  mad::store(h + o, hv.a00.v);
  mad::store(h + n + o, hv.a01.v);
  mad::store(h + 2 * n + o, hv.a02.v);
  mad::store(h + 3 * n + o, hv.a11.v);
  mad::store(h + 4 * n + o, hv.a12.v);
  mad::store(h + 5 * n + o, hv.a22.v);
}

template <typename T, bool kFirst>
__global__ void __launch_bounds__(kBX * kBY)
    fd_vesselness_kernel(const T* __restrict__ us,
                         typename mad::Compute<T>::type* __restrict__ resp,
                         T* __restrict__ h, int nz, int ny, int nx,
                         Sym<typename mad::Compute<T>::type> facs,
                         Divisors<typename mad::Compute<T>::type> dv) {
  using A = typename mad::Compute<T>::type;
  constexpr int TW = kBX + 2, TH = kBY + 2, TP = TW * TH;
  __shared__ A tile[4][TP];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kBX + lane;
  const int i = blockIdx.x * kBX + lane;
  const int j = blockIdx.y * kBY + w;
  const int k0 = blockIdx.z * kVZ;
  const int k1 = min(k0 + kVZ, nz);
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t n = nz * plane;
  const bool valid = i < nx && j < ny;

  // this thread's points of a tile plane (with its clamped ring): at most 2
  int soff[2], sidx[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = tid + m * kBX * kBY;
    const int gy = min(max(static_cast<int>(blockIdx.y) * kBY - 1 + p / TW, 0), ny - 1);
    const int gx = min(max(static_cast<int>(blockIdx.x) * kBX - 1 + p % TW, 0), nx - 1);
    sidx[m] = p < TP ? p : -1;
    soff[m] = gy * nx + gx;
  }
  A staged[2];
  auto fetch = [&](int z) {
    const T* src = us + z * plane;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (sidx[m] >= 0) staged[m] = mad::load(src + soff[m]);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (sidx[m] >= 0) tile[buf][sidx[m]] = staged[m];
    }
  };
  for (int b = 0; b < 3; ++b) {
    fetch(k0 + b);
    put(b);
  }
  __syncthreads();
  const int me = (w + 1) * TW + lane + 1;  // this thread's point in a tile plane
  A cm = tile[0][me], c0 = tile[1][me];

  for (int k = k0; k < k1; ++k) {
    const int b = (k - k0) & 3;
    const bool more = k + 1 < k1;
    if (more) fetch(k + 3);  // in flight while this plane is computed
    const A* tm = tile[b];
    const A* t0 = tile[(b + 1) & 3];
    const A* tp = tile[(b + 2) & 3];
    const A cp = tp[me];
    auto S = [&](int dz, int dy, int dx) -> Rn<A> {
      if (dy == 0 && dx == 0) return dz < 0 ? cm : (dz > 0 ? cp : c0);
      const A* t = dz < 0 ? tm : (dz > 0 ? tp : t0);
      return t[me + dy * TW + dx];
    };
    const Sym<A> hv = fd_stencil<A>(S, facs);
    cm = c0;
    c0 = cp;

    const Sorted<A> l = sorted_eigenvalues(hv);
    const int64_t o = k * plane + static_cast<int64_t>(j) * nx + i;
    if (valid) {
      const A v = response(l, dv);
      if (kFirst || v > resp[o]) {
        resp[o] = v;
        store_planes(h, n, o, hv);
      }
    }

    if (more) put((b + 3) & 3);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
    fd_hessian_kernel(const T* __restrict__ us, T* __restrict__ h, int64_t nz,
                      int64_t ny, int64_t nx,
                      Sym<typename mad::Compute<T>::type> facs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBY + threadIdx.y;
  const int64_t k = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const int64_t plane = ny * nx;
  store_planes(h, nz * plane, k * plane + j * nx + i,
               fd_hessian_at(us, k, j, i, ny, nx, facs));
}

// B15's voxels per thread, a block's width apart: a warp reads and writes
// 32 consecutive voxels of a plane.
constexpr int kVox = 4;

// B15: a block takes kVox runs of kBX * kBY voxels of the flat n-voxel
// volume; each thread loads its kVox voxels of every plane (and their best
// response) before it computes any.
template <typename T, bool kFirst>
__global__ void __launch_bounds__(kBX * kBY)
    hessian_vesselness_kernel(const T* __restrict__ h,
                              typename mad::Compute<T>::type* __restrict__ resp,
                              T* __restrict__ best_h, int64_t n,
                              Reciprocals<typename mad::Compute<T>::type> rc) {
  using A = typename mad::Compute<T>::type;
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * (kBX * kBY * kVox) + threadIdx.x;
  A x[6][kVox], best[kVox];
#pragma unroll
  for (int q = 0; q < kVox; ++q) {
    const int64_t o = o0 + q * (kBX * kBY);
    const bool in = o < n;
#pragma unroll
    for (int p = 0; p < 6; ++p) x[p][q] = in ? mad::load(h + p * n + o) : A(0);
    if (!kFirst) best[q] = in ? resp[o] : A(0);
  }
#pragma unroll
  for (int q = 0; q < kVox; ++q) {
    const int64_t o = o0 + q * (kBX * kBY);
    if (o >= n) break;
    const Sym<A> hv{x[0][q], x[1][q], x[2][q], x[3][q], x[4][q], x[5][q]};
    const A r = response(sorted_eigenvalues(hv), rc);
    if (kFirst || r > best[q]) {  // NaN never wins
      resp[o] = r;
      if (!kFirst) store_planes(best_h, n, o, hv);  // the stored values, unchanged
    }
  }
}

// ops/eigen3.py `_candidate`
template <typename A>
__device__ __forceinline__ Vec3<A> candidate(const Sym<A>& a, Rn<A> lam,
                                             bool& ok) {
  const Vec3<A> r0{a.a00 - lam, a.a01, a.a02};
  const Vec3<A> r1{a.a01, a.a11 - lam, a.a12};
  const Vec3<A> r2{a.a02, a.a12, a.a22 - lam};
  const Vec3<A> c0 = cross(r0, r1), c1 = cross(r0, r2), c2 = cross(r1, r2);
  const Rn<A> n0 = dot(c0, c0), n1 = dot(c1, c1), n2 = dot(c2, c2);
  Vec3<A> best = pick(n0 >= n1, c0, c1);
  Rn<A> nbest = maxnan(n0, n1);
  best = pick(nbest >= n2, best, c2);
  nbest = maxnan(nbest, n2);
  const Rn<A> rn = maxnan(maxnan(dot(r0, r0), dot(r1, r1)), dot(r2, r2));
  // (64 eps)^2: 2^-34 in float, 2^-92 in double
  const Rn<A> noise = sizeof(A) == 4 ? A(0x1p-34) : A(0x1p-92);
  ok = nbest > noise * rn * rn;
  return scaled(best, rsqrt(where(ok, nbest, Rn<A>(A(1)))));
}

// ops/eigen3.py `_stable_perp`
template <typename A>
__device__ __forceinline__ Vec3<A> stable_perp(Vec3<A> p) {
  const Rn<A> ax = abs(p.x), ay = abs(p.y), az = abs(p.z);
  const bool use_x = ax <= ay && ax <= az;
  const bool use_y = !use_x && ay <= az;
  const bool use_z = !use_x && !use_y;
  const Vec3<A> basis{A(use_x ? 1 : 0), A(use_y ? 1 : 0), A(use_z ? 1 : 0)};
  const Vec3<A> alt = cross(p, basis);
  return scaled(alt, rsqrt(dot(alt, alt)));
}

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
    tensor_assembly_kernel(const typename mad::Compute<T>::type* __restrict__ resp,
                           const T* __restrict__ h,
                           typename mad::Compute<T>::type* __restrict__ out,
                           int64_t n, double inv_sens, double eps_m1,
                           double omega_m_eps) {
  using A = typename mad::Compute<T>::type;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * (kBX * kBY) + threadIdx.x;
  if (o >= n) return;
  const Sym<A> m{mad::load(h + o),         mad::load(h + n + o),
                 mad::load(h + 2 * n + o), mad::load(h + 3 * n + o),
                 mad::load(h + 4 * n + o), mad::load(h + 5 * n + o)};
  const Scaled<A> e = scaled_eigenvalues(m);
  const Rn<A> zero = A(0), one = A(1);
  bool ok_hi, ok_lo;
  const Vec3<A> v_hi = candidate(e.a, e.hi, ok_hi);
  const Vec3<A> v_lo = candidate(e.a, e.lo, ok_lo);
  const Vec3<A> primary = pick(ok_lo, v_lo, Vec3<A>{one, zero, zero});
  const Vec3<A> q3 = pick(ok_hi, v_hi, stable_perp(primary));

  const Rn<A> v = pow(maxnan(Rn<A>(resp[o]), zero), Rn<A>(A(inv_sens)));
  const Rn<A> d1 = one + Rn<A>(A(eps_m1)) * v;
  const Rn<A> diff = Rn<A>(A(omega_m_eps)) * v;
  const bool active = v > zero;
  const Rn<A> q[3] = {q3.x, q3.y, q3.z};
  int p = 0;
  for (int a = 0; a < 3; ++a) {
    for (int b = a; b < 3; ++b, ++p) {
      Rn<A> t = diff * q[a] * q[b];
      if (a == b) t = t + d1;
      out[p * n + o] = active ? t.v : (a == b ? A(1) : A(0));
    }
  }
}

template <typename T>
int launch_fd_vesselness(const void* us, void* resp, void* h, int64_t nz,
                         int64_t ny, int64_t nx, const double* f,
                         double two_a2, double two_b2, double two_g2, int first,
                         void* stream) {
  using A = typename mad::Compute<T>::type;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Sym<A> facs{A(f[0]), A(f[1]), A(f[2]), A(f[3]), A(f[4]), A(f[5])};
  const Divisors<A> dv{{A(two_a2), A(two_b2), A(two_g2)}};
  const dim3 block(kBX, kBY);
  const dim3 grid(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY),
                  mad::blocks_for(nz, kVZ));
  auto kernel = first ? fd_vesselness_kernel<T, true> : fd_vesselness_kernel<T, false>;
  kernel<<<grid, block, 0, s>>>(static_cast<const T*>(us), static_cast<A*>(resp),
                                static_cast<T*>(h), static_cast<int>(nz),
                                static_cast<int>(ny), static_cast<int>(nx), facs, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fd_hessian(const void* us, void* h, int64_t nz, int64_t ny,
                      int64_t nx, const double* f, void* stream) {
  using A = typename mad::Compute<T>::type;
  const Sym<A> facs{A(f[0]), A(f[1]), A(f[2]), A(f[3]), A(f[4]), A(f[5])};
  const dim3 grid(mad::blocks_for(nx, kBX), mad::blocks_for(ny, kBY),
                  static_cast<unsigned>(nz));
  fd_hessian_kernel<T><<<grid, dim3(kBX, kBY), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(us), static_cast<T*>(h), nz, ny, nx, facs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hessian_vesselness(const void* h, void* resp, void* best_h, int64_t n,
                              double two_a2, double two_b2, double two_g2, int first,
                              void* stream) {
  using A = typename mad::Compute<T>::type;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the divisors rounded to A, then their reciprocals rounded in A, as
  // PyTorch's eager division by a Python number computes them on the host
  const Reciprocals<A> rc{{A(1) / A(two_a2), A(1) / A(two_b2), A(1) / A(two_g2)}};
  auto kernel = first ? hessian_vesselness_kernel<T, true>
                      : hessian_vesselness_kernel<T, false>;
  kernel<<<mad::blocks_for(n, kBX * kBY * kVox), kBX * kBY, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<A*>(resp), static_cast<T*>(best_h), n, rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tensor_assembly(const void* resp, const void* h, void* out,
                           int64_t n, double inv_sens, double eps_m1,
                           double omega_m_eps, void* stream) {
  using A = typename mad::Compute<T>::type;
  tensor_assembly_kernel<T><<<mad::blocks_for(n, kBX * kBY), kBX * kBY, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const A*>(resp), static_cast<const T*>(h),
      static_cast<A*>(out), n, inv_sens, eps_m1, omega_m_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MAD_VESSELNESS_ENTRY(SUF, T)                                          \
  extern "C" int mad_fd_vesselness_##SUF(                                     \
      const void* us, void* resp, void* h, int64_t nz, int64_t ny,            \
      int64_t nx, double f00, double f01, double f02, double f11, double f12, \
      double f22, double two_a2, double two_b2, double two_g2, int first,     \
      void* stream) {                                                         \
    const double f[6] = {f00, f01, f02, f11, f12, f22};                       \
    return launch_fd_vesselness<T>(us, resp, h, nz, ny, nx, f, two_a2,        \
                                   two_b2, two_g2, first, stream);            \
  }                                                                           \
  extern "C" int mad_fd_hessian_##SUF(                                        \
      const void* us, void* h, int64_t nz, int64_t ny, int64_t nx,            \
      double f00, double f01, double f02, double f11, double f12, double f22, \
      void* stream) {                                                         \
    const double f[6] = {f00, f01, f02, f11, f12, f22};                       \
    return launch_fd_hessian<T>(us, h, nz, ny, nx, f, stream);                \
  }                                                                           \
  extern "C" int mad_hessian_vesselness_##SUF(                                \
      const void* h, void* resp, void* best_h, int64_t n, double two_a2,      \
      double two_b2, double two_g2, int first, void* stream) {                \
    return launch_hessian_vesselness<T>(h, resp, best_h, n, two_a2, two_b2,   \
                                        two_g2, first, stream);               \
  }                                                                           \
  extern "C" int mad_tensor_assembly_##SUF(                                   \
      const void* resp, const void* h, void* out, int64_t n, double inv_sens, \
      double eps_m1, double omega_m_eps, void* stream) {                      \
    return launch_tensor_assembly<T>(resp, h, out, n, inv_sens, eps_m1,       \
                                     omega_m_eps, stream);                    \
  }

MAD_FOR_EACH_TYPE(MAD_VESSELNESS_ENTRY)
