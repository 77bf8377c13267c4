// Gaussian smoothing and Gaussian-derivative passes of the VED pipeline: the
// 1-D correlation along z (B6), the fused y-then-x correlation (B7), and the
// single-axis correlations along y and x (B10).
//
// Replace the Pallas kernels `_conv_z_kernel` (built by `_build_conv_z`),
// `_conv_yx_kernel` (`_build_conv_yx`), `_conv_y_kernel` (`_build_conv_y`)
// and `_conv_x_kernel` (`_build_conv_x`) in
// multigridanisotropicdiffusion_tpu/ops/pallas_conv.py.  The TPU kernels
// phrase the y and x passes as banded matrix products on the MXU, pad z to
// whole tiles and take only x % 128 == 0, y % 8 == 0 shapes; these kernels
// sum the taps directly and take any shape.
//
//   conv_z:   out[k,j,i] = sum_t w[t] u[z(k,t), j, i]
//             z(k,t) = k + t (valid mode: the input carries r-plane halos)
//                    = clamp(k + t - r, 0, Z - 1) (edge replication)
//   conv_yx:  mid[k,j,i] = sum_t wy[t] u[k, clamp(j + t - ry), i]   (not rounded)
//             out[k,j,i] = sum_t wx[t] mid[k, j, clamp(i + t - rx)]
//   conv_y:   out[k,j,i] = sum_t wy[t] u[k, clamp(j + t - ry), i]   (rounded)
//   conv_x:   out[k,j,i] = sum_t wx[t] u[k, j, clamp(i + t - rx)]   (rounded)
//
// Taps run in ascending t and zero taps are skipped (the z-slab pipeline pads
// short kernels with zeros), as in ops/hessian.py's `_conv_axis`; each sum
// starts at its first product (so an output whose every product is -0 is
// -0), runs in the compute type (float for bf16 storage) and rounds once at
// the store.  conv_y and conv_x are the single-axis passes of the
// gaussian_derivative Hessian, which rounds to the storage type after every
// pass, so they cannot be served by conv_yx's y pass (which stays unrounded).
// Each product and sum rounds on its own (no fused multiply-add), as
// in the plain versions, so the smoothed fields agree bit for bit: the
// vesselness select downstream compares responses of different scales, and
// a last-bit difference at a near-tie would pick another scale's Hessian.
// At most 129 taps (kernel_radius caps r at 64).
//
// The host plans every pass (ops/cuda_conv.py: axis_plan, yx_plan): the
// taps become the ascending list of the non-zero ones, each with its offset
// from the centre, and the zero taps at both ends are stripped (the z-slab
// pipeline pads every scale's kernel to the largest radius); a valid-mode z
// pass then starts its windows that many planes further in.  Where what is
// left is dense and of radius 2, 4, 5 or 8 (the VED's five scales at unit
// spacing: their g, g1 and g2 taps are all non-zero), the radius is compiled
// in: the window unrolls fully, each weight is an operand from the kernel's
// parameters, and there is no zero test.  Any other taps (up to r = 64,
// interior zeros) take the generic form, which loops over the list.
//
// Bound on the card: device-memory bandwidth, with instruction issue close
// behind, since every tap is a separately rounded multiply and add (2 (2r +
// 1) float instructions per output and pass: 34 at r = 8, ~0.14 ms per 512^3
// pass at the card's float rate).  At 512^3 f32 with sigma = 2 (r = 8),
// conv_z reads 530 planes and writes 514 (1.10 GB, 0.33 ms at 3.35 TB/s);
// conv_yx reads and writes 514 planes (1.08 GB, 0.32 ms) and issues 68
// float instructions per output (~0.27 ms); conv_y and conv_x each read and
// write 512 planes (1.07 GB, 0.32 ms).
//
// conv_z and conv_y are one column-run kernel over the stride of the
// convolved axis (a plane, or a row).  A thread owns a run of kRun = 16
// consecutive outputs along that axis at 16 bytes of compute-type columns
// (4 float, 4 bf16 or 2 double, lanes along x), and slides over the run's
// kRun + 2r inputs, one vector load each (16 bytes; 8 in bf16), multiplying
// each into every output of the run that it reaches: one load serves up to
// 2r + 1 taps, and each input is read (kRun + 2r) / kRun times (2 at r = 8,
// 1.25 at r = 2), the re-reads from L2, since the runs of one column are
// neighbouring blocks.  Positions are 32-bit indices, clamped, which is the
// edge replication (and keeps the last run of a valid pass inside the
// input); each load adds one position times the stride to its line's base.  The outputs go out as streaming
// vector stores.  Rows whose length is not whole vectors, or that are not
// aligned to them, take the same kernel with scalar loads and stores.
//
// conv_yx: one block of 288 threads owns a tile of 32 rows x 128 columns on
// kYXPlanes consecutive z planes.  The y pass runs down the columns (halo
// columns included): a thread owns a run of 16 consecutive rows of one
// column and slides over the 16 + 2 ry input rows read straight from global
// memory (lanes along x, coalesced; no clamping on tiles away from the y
// borders), each value multiplied into every output of the run it reaches,
// so one load serves up to 2 ry + 1 taps; the sums go unrounded into a
// shared (32 x (128 + 2 rx)) intermediate.  The x pass has one lane per row
// (a row stride that is odd, so no bank conflicts) and 16 consecutive
// outputs per thread, on 8 warps, sliding over the shared row the same way;
// its results go to a shared output tile, written and read as 16-byte
// vectors, that the block stores as 16-byte rows with streaming stores.
// For the compiled radii both axes have the same radius.
//
// conv_x is conv_yx's kernel with its y pass replaced by a copy: the tile's
// rows, x halo included, are staged in the shared intermediate as they are,
// and the x pass, the output tile and the stores are B7's.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 129;

// The taps of one axis: dense (t = 0 .. 2r) for a compiled radius, else the
// non-zero taps in ascending order, each with its offset t - r.
template <typename A>
struct TapList {
  A w[kMaxTaps];
  short off[kMaxTaps];
  int n;
  int r;
};

template <typename A>
bool tap_list(const void* w, const void* off, int64_t n, int64_t r, TapList<A>* t) {
  if (n < 1 || n > kMaxTaps || r < 0 || r > (kMaxTaps - 1) / 2) return false;
  *t = TapList<A>{};
  std::memcpy(t->w, w, static_cast<size_t>(n) * sizeof(A));
  const int32_t* o = static_cast<const int32_t*>(off);
  for (int64_t k = 0; k < n; ++k) {
    if (o[k] < -r || o[k] > r) return false;
    t->off[k] = static_cast<short>(o[k]);
  }
  t->n = static_cast<int>(n);
  t->r = static_cast<int>(r);
  return true;
}

// A compiled radius needs the dense taps of that radius (the launchers
// refuse radii that are not compiled).
bool radius_fits(int64_t radius, int64_t n, int64_t r) {
  return radius == 0 || (r == radius && n == 2 * radius + 1);
}

// acc = w v, or acc + w v: a sum starts at its first product.
template <typename A>
__device__ __forceinline__ void tap(A& acc, bool first, A w, A v) {
  const A prod = mad::mul_rn(w, v);
  acc = first ? prod : mad::add_rn(acc, prod);
}

// ---------------------------------------------------------------------------
// conv_z, conv_y: the column-run kernel
// ---------------------------------------------------------------------------

constexpr int kRun = 16;      // outputs per thread along the convolved axis
constexpr int kRunWarps = 4;  // warps per block, one line of the other axis each

// Compute-type values per thread along x: 16 bytes of them.
template <typename T>
constexpr int kColsOf = 16 / sizeof(typename mad::Compute<T>::type);

// kColsOf<T> consecutive values at p.  kVec: one load (p aligned to it);
// else the n that lie in the row, one by one, the rest zero.
template <typename T, bool kVec>
__device__ __forceinline__ void load_cols(const T* p, int n,
                                          typename mad::Compute<T>::type (&v)[kColsOf<T>]) {
  using A = typename mad::Compute<T>::type;
  if constexpr (!kVec) {
#pragma unroll
    for (int q = 0; q < kColsOf<T>; ++q) v[q] = q < n ? mad::load(p + q) : A(0);
  } else if constexpr (sizeof(T) == 2) {  // 4 bf16, element 2w in the low half of word w
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// The values at p, each rounded once to T; a streaming store, so the outputs
// do not push the inputs' halo rows out of L2.
template <typename T, bool kVec>
__device__ __forceinline__ void store_cols(T* p, int n,
                                           const typename mad::Compute<T>::type (&v)[kColsOf<T>]) {
  if constexpr (!kVec) {
#pragma unroll
    for (int q = 0; q < kColsOf<T>; ++q) {
      if (q < n) mad::store(p + q, v[q]);
    }
  } else if constexpr (sizeof(T) == 2) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3])));
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
}

// Outputs k of line m (a y row for conv_z, a z plane for conv_y) sum taps
// over input positions clamp(k + base + t, 0, n_in - 1), t = 0 .. 2r: base
// is the stripped taps' shift in valid mode, -r in edge mode.  Positions
// are `stride` values apart, lines `line_stride`.  kR > 0: the dense taps
// of that radius; kR == 0: the generic form over the tap list.
template <typename T, int kR, bool kVec>
__global__ void __launch_bounds__(32 * kRunWarps)
    conv_run_kernel(const T* __restrict__ in, T* __restrict__ out, int n_in, int n_out,
                    int base, int64_t stride, int lines, int64_t line_stride, int nx,
                    TapList<typename mad::Compute<T>::type> taps) {
  using A = typename mad::Compute<T>::type;
  constexpr int V = kColsOf<T>;
  const int k0 = blockIdx.x * kRun;
  const int x = (blockIdx.y * 32 + threadIdx.x) * V;
  const int m = blockIdx.z * kRunWarps + threadIdx.y;
  if (x >= nx || m >= lines) return;
  const int cols = nx - x;  // V of them, or fewer at the ragged end of a row
  const T* src = in + m * line_stride + x;
  const int w0 = k0 + base;  // input position of the run's first window entry
  auto at = [&](int p) {
    return src + static_cast<int64_t>(min(max(w0 + p, 0), n_in - 1)) * stride;
  };
  A acc[kRun][V];
  if constexpr (kR > 0) {
    // window position p feeds tap t = p - o of output k0 + o, so each output
    // sums its taps in ascending order
#pragma unroll
    for (int p = 0; p < kRun + 2 * kR; ++p) {
      A v[V];
      load_cols<T, kVec>(at(p), cols, v);
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        const int t = p - o;
        if (t >= 0 && t <= 2 * kR) {
#pragma unroll
          for (int q = 0; q < V; ++q) tap(acc[o][q], t == 0, taps.w[t], v[q]);
        }
      }
    }
  } else {
    for (int i = 0; i < taps.n; ++i) {
      const int d = taps.off[i] + taps.r;
      const A w = taps.w[i];
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        A v[V];
        load_cols<T, kVec>(at(o + d), cols, v);
#pragma unroll
        for (int q = 0; q < V; ++q) tap(acc[o][q], i == 0, w, v[q]);
      }
    }
  }
  T* dst = out + m * line_stride + x;
#pragma unroll
  for (int o = 0; o < kRun; ++o) {
    if (k0 + o < n_out) {
      store_cols<T, kVec>(dst + static_cast<int64_t>(k0 + o) * stride, cols, acc[o]);
    }
  }
}

template <typename T, int kR, bool kVec>
int launch_conv_run_r(const T* in, T* out, int n_in, int n_out, int base, int64_t stride,
                      int lines, int64_t line_stride, int nx,
                      const TapList<typename mad::Compute<T>::type>& taps,
                      cudaStream_t stream) {
  const dim3 grid(mad::blocks_for(n_out, kRun), mad::blocks_for(nx, 32 * kColsOf<T>),
                  mad::blocks_for(lines, kRunWarps));
  conv_run_kernel<T, kR, kVec><<<grid, dim3(32, kRunWarps), 0, stream>>>(
      in, out, n_in, n_out, base, stride, lines, line_stride, nx, taps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_conv_run_v(int64_t radius, const T* in, T* out, int n_in, int n_out, int base,
                      int64_t stride, int lines, int64_t line_stride, int nx,
                      const TapList<typename mad::Compute<T>::type>& taps,
                      cudaStream_t s) {
  switch (radius) {
    case 0:
      return launch_conv_run_r<T, 0, kVec>(in, out, n_in, n_out, base, stride, lines,
                                           line_stride, nx, taps, s);
    case 2:
      return launch_conv_run_r<T, 2, kVec>(in, out, n_in, n_out, base, stride, lines,
                                           line_stride, nx, taps, s);
    case 4:
      return launch_conv_run_r<T, 4, kVec>(in, out, n_in, n_out, base, stride, lines,
                                           line_stride, nx, taps, s);
    case 5:
      return launch_conv_run_r<T, 5, kVec>(in, out, n_in, n_out, base, stride, lines,
                                           line_stride, nx, taps, s);
    case 8:
      return launch_conv_run_r<T, 8, kVec>(in, out, n_in, n_out, base, stride, lines,
                                           line_stride, nx, taps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One pass of the column-run kernel; radius: the compiled radius or 0.
template <typename T>
int launch_conv_run(const void* in, void* out, int64_t n_in, int64_t n_out, int64_t base,
                    int64_t stride, int64_t lines, int64_t line_stride, int64_t nx,
                    int64_t radius, const void* w, const void* off, int64_t n, int64_t r,
                    void* stream) {
  using A = typename mad::Compute<T>::type;
  TapList<A> taps;
  if (!tap_list(w, off, n, r, &taps) || !radius_fits(radius, n, r) || n_in < 1 ||
      n_out < 1 || nx < 1 || lines < 1 || n_in > INT32_MAX || n_out > INT32_MAX ||
      base < -r || base > n_in || nx > 65535 * 32 * int64_t(kColsOf<T>) ||
      lines > 65535 * kRunWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t vec_bytes = kColsOf<T> * sizeof(T);
  const bool vec = nx % kColsOf<T> == 0 && reinterpret_cast<uintptr_t>(in) % vec_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % vec_bytes == 0;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const int ni = static_cast<int>(n_in), no = static_cast<int>(n_out);
  const int b = static_cast<int>(base), nl = static_cast<int>(lines), nc = static_cast<int>(nx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return launch_conv_run_v<T, true>(radius, src, dst, ni, no, b, stride, nl, line_stride, nc,
                                      taps, s);
  }
  return launch_conv_run_v<T, false>(radius, src, dst, ni, no, b, stride, nl, line_stride, nc,
                                     taps, s);
}

// ---------------------------------------------------------------------------
// conv_yx, conv_x
// ---------------------------------------------------------------------------

constexpr int kTY = 32;        // tile rows: one x-pass lane each
constexpr int kTX = 128;       // tile columns
constexpr int kRunY = 16;      // y outputs per thread in the y pass
constexpr int kRunX = 16;      // x outputs per thread in the x pass
constexpr int kXWarps = kTX / kRunX;  // x-pass warps, one run each
// One more warp than the x pass needs: at r = 8 the y pass has exactly
// 2 (kTX + 16) = 288 runs, so it takes one round.
constexpr int kYXThreads = 32 * (kXWarps + 1);
constexpr int kYXPlanes = 4;   // z planes per block
constexpr int kOutStride = kTX + 4;  // 16-byte rows, odd in 16-byte units

// 16 bytes of compute-type values, from registers to shared memory.
__device__ __forceinline__ void put16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// 16 bytes of storage type T from compute-type values in shared memory,
// each rounded once; a streaming store, so the output does not push the
// inputs' halo rows out of L2.
template <typename T>
__device__ __forceinline__ void store16(T* p, const typename mad::Compute<T>::type* v) {
  if constexpr (sizeof(T) == 2) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                      bf16_pair(v[6], v[7])));
  } else {
    static_assert(sizeof(T) == sizeof(*v), "no rounding: T is its compute type");
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(v));
  }
}

// kR > 0: the dense taps of radius kR on both axes; kR == 0: the generic
// form over the tap lists.  kY false (conv_x): no y pass, the rows are
// staged as they are and `ty` is not read.
template <typename T, int kR, bool kY>
__global__ void __launch_bounds__(kYXThreads)
    conv_yx_kernel(const T* __restrict__ in, T* __restrict__ out, int nz,
                   int ny, int nx, TapList<typename mad::Compute<T>::type> ty,
                   TapList<typename mad::Compute<T>::type> tx, int mid_stride,
                   int vec) {
  using A = typename mad::Compute<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* otile = reinterpret_cast<A*>(smem_raw);  // kTY x kOutStride
  A* mid = otile + kTY * kOutStride;            // kTY x mid_stride
  const int rx = kR > 0 ? kR : tx.r;
  const int ncols = kTX + 2 * rx;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int y0 = blockIdx.y * kTY;
  const int x0 = blockIdx.x * kTX;
  const int64_t plane_size = static_cast<int64_t>(ny) * nx;
  const int z1 = min(static_cast<int>(blockIdx.z) * kYXPlanes + kYXPlanes, nz);
  // the tile's input rows all lie inside the plane: no clamping along y
  const bool interior = kR > 0 && y0 - kR >= 0 && y0 + kTY + kR <= ny;

  for (int z = blockIdx.z * kYXPlanes; z < z1; ++z) {
    const T* src = in + z * plane_size;
    // y pass: a run of kRunY rows of one column per task
    for (int task = tid; task < ncols * (kTY / kRunY); task += kYXThreads) {
      const int col = task % ncols;
      const int row0 = task / ncols * kRunY;
      const T* column = src + min(max(x0 - rx + col, 0), nx - 1);
      const int yb = y0 + row0;
      A acc[kRunY];
      if constexpr (!kY) {
#pragma unroll
        for (int o = 0; o < kRunY; ++o) {
          acc[o] = mad::load(column + static_cast<int64_t>(min(yb + o, ny - 1)) * nx);
        }
      } else if constexpr (kR > 0) {
        const T* row = column + static_cast<int64_t>(yb - kR) * nx;
#pragma unroll
        for (int p = 0; p < kRunY + 2 * kR; ++p) {
          A v;
          if (interior) {
            v = mad::load(row);
            row += nx;
          } else {
            const int y = min(max(yb + p - kR, 0), ny - 1);
            v = mad::load(column + static_cast<int64_t>(y) * nx);
          }
#pragma unroll
          for (int o = 0; o < kRunY; ++o) {
            const int t = p - o;
            if (t >= 0 && t <= 2 * kR) tap(acc[o], t == 0, ty.w[t], v);
          }
        }
      } else {
        for (int k = 0; k < ty.n; ++k) {
          const int d = ty.off[k];
          const A w = ty.w[k];
#pragma unroll
          for (int o = 0; o < kRunY; ++o) {
            const int y = min(max(yb + o + d, 0), ny - 1);
            tap(acc[o], k == 0, w, mad::load(column + static_cast<int64_t>(y) * nx));
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kRunY; ++o) mid[(row0 + o) * mid_stride + col] = acc[o];
    }
    __syncthreads();

    // x pass: lane = row, kRunX consecutive outputs per thread
    if (warp < kXWarps) {
      const int xs = warp * kRunX;
      const A* m = mid + lane * mid_stride + xs;  // mid column xs + t feeds tap t
      A acc[kRunX];
      if constexpr (kR > 0) {
#pragma unroll
        for (int p = 0; p < kRunX + 2 * kR; ++p) {
          const A v = m[p];
#pragma unroll
          for (int o = 0; o < kRunX; ++o) {
            const int t = p - o;
            if (t >= 0 && t <= 2 * kR) tap(acc[o], t == 0, tx.w[t], v);
          }
        }
      } else {
        for (int k = 0; k < tx.n; ++k) {
          const int d = tx.off[k] + rx;
          const A w = tx.w[k];
#pragma unroll
          for (int o = 0; o < kRunX; ++o) tap(acc[o], k == 0, w, m[o + d]);
        }
      }
      A* orow = otile + lane * kOutStride + xs;
#pragma unroll
      for (int o = 0; o < kRunX; o += 16 / sizeof(A)) put16(orow + o, acc + o);
    }
    __syncthreads();

    // store the tile, 16 bytes of storage per thread where the row allows
    T* dst = out + z * plane_size;
    constexpr int V = 16 / sizeof(T);
    for (int idx = tid * V; idx < kTY * kTX; idx += kYXThreads * V) {
      const int row = idx / kTX;
      const int c = idx % kTX;
      const int y = y0 + row;
      const int x = x0 + c;
      if (y >= ny) continue;
      const A* o = otile + row * kOutStride + c;
      T* d = dst + static_cast<int64_t>(y) * nx + x;
      if (vec && x + V <= nx) {
        store16<T>(d, o);
      } else {
        for (int q = 0; q < V && x + q < nx; ++q) mad::store(d + q, o[q]);
      }
    }
  }
}

template <typename T, int kR, bool kY>
int launch_conv_yx_r(const T* in, T* out, int64_t nz, int64_t ny, int64_t nx,
                     const TapList<typename mad::Compute<T>::type>& ty,
                     const TapList<typename mad::Compute<T>::type>& tx,
                     cudaStream_t stream) {
  using A = typename mad::Compute<T>::type;
  const int rx = kR > 0 ? kR : tx.r;
  const int mid_stride = (kTX + 2 * rx) | 1;  // odd: the x pass's lanes hit 32 banks
  const size_t bytes = static_cast<size_t>(kTY) * (kOutStride + mid_stride) * sizeof(A);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_yx_kernel<T, kR, kY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = nx % (16 / sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(mad::blocks_for(nx, kTX), mad::blocks_for(ny, kTY),
                  mad::blocks_for(nz, kYXPlanes));
  conv_yx_kernel<T, kR, kY><<<grid, kYXThreads, bytes, stream>>>(
      in, out, static_cast<int>(nz), static_cast<int>(ny), static_cast<int>(nx),
      ty, tx, mid_stride, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kY>
int launch_conv_yx_k(int64_t radius, const void* in, void* out, int64_t nz, int64_t ny,
                     int64_t nx, const TapList<typename mad::Compute<T>::type>& ty,
                     const TapList<typename mad::Compute<T>::type>& tx, void* stream) {
  if (nz * ny * nx == 0 || ny * nx > (int64_t(1) << 31) || nz > 65535 * kYXPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return launch_conv_yx_r<T, 0, kY>(src, dst, nz, ny, nx, ty, tx, s);
    case 2: return launch_conv_yx_r<T, 2, kY>(src, dst, nz, ny, nx, ty, tx, s);
    case 4: return launch_conv_yx_r<T, 4, kY>(src, dst, nz, ny, nx, ty, tx, s);
    case 5: return launch_conv_yx_r<T, 5, kY>(src, dst, nz, ny, nx, ty, tx, s);
    case 8: return launch_conv_yx_r<T, 8, kY>(src, dst, nz, ny, nx, ty, tx, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// radius: the compiled radius (2, 4, 5 or 8: dense taps of that radius on
// both axes) or 0 (the generic form over the tap lists).
template <typename T>
int launch_conv_yx(const void* in, void* out, int64_t nz, int64_t ny,
                   int64_t nx, int64_t radius, const void* wy, const void* offy,
                   int64_t nty, int64_t ry, const void* wx, const void* offx,
                   int64_t ntx, int64_t rx, void* stream) {
  using A = typename mad::Compute<T>::type;
  TapList<A> ty, tx;
  if (!tap_list(wy, offy, nty, ry, &ty) || !tap_list(wx, offx, ntx, rx, &tx) ||
      !radius_fits(radius, nty, ry) || !radius_fits(radius, ntx, rx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_conv_yx_k<T, true>(radius, in, out, nz, ny, nx, ty, tx, stream);
}

// conv_x: conv_yx's kernel without its y pass.
template <typename T>
int launch_conv_x(const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,
                  int64_t radius, const void* w, const void* off, int64_t n, int64_t r,
                  void* stream) {
  using A = typename mad::Compute<T>::type;
  TapList<A> ty{}, tx;
  if (!tap_list(w, off, n, r, &tx) || !radius_fits(radius, n, r)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_conv_yx_k<T, false>(radius, in, out, nz, ny, nx, ty, tx, stream);
}

}  // namespace

// conv_z: lines are y rows, positions z planes; conv_y: lines are z planes,
// positions y rows (edge mode: base -r).
#define MAD_CONV_ENTRY(SUF, T)                                                 \
  extern "C" int mad_conv_z_##SUF(                                             \
      const void* in, void* out, int64_t zi, int64_t ny, int64_t nx,           \
      int64_t zo, int64_t base, int64_t radius, const void* w, const void* off, \
      int64_t n, int64_t r, void* stream) {                                    \
    return launch_conv_run<T>(in, out, zi, zo, base, ny * nx, ny, nx, nx,      \
                              radius, w, off, n, r, stream);                   \
  }                                                                            \
  extern "C" int mad_conv_yx_##SUF(                                            \
      const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,           \
      int64_t radius, const void* wy, const void* offy, int64_t nty,           \
      int64_t ry, const void* wx, const void* offx, int64_t ntx, int64_t rx,   \
      void* stream) {                                                          \
    return launch_conv_yx<T>(in, out, nz, ny, nx, radius, wy, offy, nty, ry,   \
                             wx, offx, ntx, rx, stream);                       \
  }                                                                            \
  extern "C" int mad_conv_y_##SUF(                                             \
      const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,           \
      int64_t radius, const void* w, const void* off, int64_t n, int64_t r,    \
      void* stream) {                                                          \
    return launch_conv_run<T>(in, out, ny, ny, -r, nx, nz, ny * nx, nx,        \
                              radius, w, off, n, r, stream);                   \
  }                                                                            \
  extern "C" int mad_conv_x_##SUF(                                             \
      const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,           \
      int64_t radius, const void* w, const void* off, int64_t n, int64_t r,    \
      void* stream) {                                                          \
    return launch_conv_x<T>(in, out, nz, ny, nx, radius, w, off, n, r, stream); \
  }

MAD_FOR_EACH_TYPE(MAD_CONV_ENTRY)
