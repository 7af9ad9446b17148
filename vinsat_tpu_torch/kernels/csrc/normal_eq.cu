// Robust-weighted normal-equation assembly per knot, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by
// vinsat_tpu_torch/kernels/normal_eq.py.
//
// Replaces the TPU kernel vinsat_tpu/kernels/normal_eq.py
// (assemble_normal_eq, pallas_call at :70; body _assemble_kernel :27).  For
// every knot n of the per-knot observation budget layout
//     J (N, D, 2, 9), r (N, D, 2), w (N, D)
// it forms
//     G[n] = sum_d sum_k w[n,d] J[n,d,k,:]^T J[n,d,k,:]     (9 x 9)
//     g[n] = sum_d sum_k w[n,d] J[n,d,k,:]^T r[n,d,k]       (9)
// with the arithmetic of assemble_normal_eq_reference (normal_eq.py:87):
// each Jacobian entry is first weighted (JW = J * w, rounded), then
// multiplied, and the 2D rows are summed in order d = 0..D-1, k = 0..1.
// G is symmetric: the 45 entries i <= j are computed as
// sum (w J_i) J_j and mirrored on store, so G_ji is that same value where
// the reference forms sum (w J_j) J_i, which may differ in the last bit
// (the 1e-12 relative tests hold it).
//
// Types: f64 in and sums, f32 in and sums, or f64 in with f32 sums (the TPU
// kernel's contract, `f32=True`): each value is rounded to f32 as it is
// loaded (round to nearest, as .float() does), the sums run in f32 and the
// results are stored as f64 -- the arithmetic of cast-then-f32-kernel in
// one launch.
//
// What bounds it on this card: the bytes.  At the long arc's shape (2168
// knots, D = 4, f64) it reads 72 + 8 + 4 doubles and writes 90 per knot,
// ~3.0 MB in all (~0.9 us at 3.35 TB/s), and does 8 x (9 + 2 x 54) flops
// per knot (2 Mflop, well under 0.1 us).  Either way it sits near the
// launch latency; it runs once per LM iteration.
//
// What the design does about it: a warp per knot and no block barrier.
// The warp copies its knot's 18D + 2D + D contiguous values into its own
// shared-memory slot with 16-byte loads (8-byte in f32) -- where D is
// known at compile time, every load issued before the first shared store,
// so that the warp waits on memory once -- then __syncwarp.  Each lane
// owns about two of the 54 outputs (45 of G, 9 of g) and reduces over the
// 2D rows in a register; the output-to-(i, j) map is worked out once per
// lane without a divide.  D is a template parameter for the long arc's
// D = 4 (loops unrolled), with a runtime-D instantiation for the rest.
// The runtime-D path stages a knot's rows D_CHUNK slots at a time (a slot
// of 21 x 64 values, 43 KiB for 4 warps in f64, under the 48 KiB default),
// each lane carrying its sums in registers from chunk to chunk, so that any
// D runs and the rows are still summed in order d = 0..D-1.
// The TPU layout (knots tiled by 8 on sublanes, G and g packed into a
// 128-lane row) does not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr int D_CHUNK = 64;  // observation slots a warp stages at a time
constexpr int N_SYM = 45;  // entries i <= j of the 9 x 9 G
constexpr int N_OUT = 54;  // then the 9 of g

template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

// Copy count values from src to the warp's slot dst, rounding each to Acc;
// as pairs (16 bytes in f64) where src and count allow.
template <typename In, typename Acc>
__device__ __forceinline__ void stage(const In* __restrict__ src, Acc* dst,
                                      int count, bool pairs, int lane) {
  if (pairs && (count & 1) == 0 &&
      ((uintptr_t)src % (2 * sizeof(In))) == 0) {
    using V = typename Vec2<In>::type;
    const V* s = reinterpret_cast<const V*>(src);
#pragma unroll
    for (int i = lane; i < count / 2; i += 32) {
      const V v = __ldg(s + i);
      dst[2 * i] = (Acc)v.x;
      dst[2 * i + 1] = (Acc)v.y;
    }
  } else {
    for (int i = lane; i < count; i += 32) dst[i] = (Acc)__ldg(src + i);
  }
}

// The same for a compile-time (even) D: the knot's J, r and w as one run
// of pairs into the slot (they lie one after another there), every load
// issued before the first store, so that a warp waits on memory once.
template <typename In, typename Acc, int DT>
__device__ __forceinline__ void stage_all(const In* __restrict__ J,
                                          const In* __restrict__ r,
                                          const In* __restrict__ w,
                                          Acc* slot, int64_t n, int lane) {
  static_assert(DT > 0 && DT % 2 == 0, "pairs of w need an even D");
  using V = typename Vec2<In>::type;
  constexpr int NJ = 9 * DT, NR = DT, S = NJ + NR + DT / 2;
  constexpr int K = (S + 31) / 32;
  const V* Jv = reinterpret_cast<const V*>(J + n * 18 * DT);
  const V* rv = reinterpret_cast<const V*>(r + n * 2 * DT);
  const V* wv = reinterpret_cast<const V*>(w + n * DT);
  V v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = lane + 32 * k;
    v[k] = q < NJ        ? __ldg(Jv + q)
           : q < NJ + NR ? __ldg(rv + (q - NJ))
           : q < S       ? __ldg(wv + (q - NJ - NR))
                         : V{};
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = lane + 32 * k;
    if (q < S) {
      slot[2 * q] = (Acc)v[k].x;
      slot[2 * q + 1] = (Acc)v[k].y;
    }
  }
}

// One output of the knot: G[i][j] (j < 9) or g[i] (j = 9), the R rows of
// the warp's slot (its dc observation slots) added to acc in order.
template <typename Acc, int DT>
__device__ __forceinline__ Acc reduce_one(const Acc* Js, const Acc* rs,
                                          const Acc* ws, int i, int j,
                                          int dc, Acc acc) {
  const int R = DT > 0 ? 2 * DT : 2 * dc;
  // column j of J, or the residuals for g
  const Acc* col = j < 9 ? Js + j : rs;
  const int stride = j < 9 ? 9 : 1;
#pragma unroll
  for (int row = 0; row < R; ++row) {
    const Acc jw = Js[row * 9 + i] * ws[row >> 1];
    acc += jw * col[row * stride];
  }
  return acc;
}

template <typename In, typename Acc, int DT>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
    normal_eq_kernel(const In* __restrict__ J, const In* __restrict__ r,
                     const In* __restrict__ w, In* __restrict__ G,
                     In* __restrict__ g, int64_t N, int D_rt, bool pairs) {
  extern __shared__ unsigned char smem_raw[];
  const int D = DT > 0 ? DT : D_rt;
  // observation slots staged at a time: all of them for a compile-time D
  const int DC = DT > 0 ? DT : (D < D_CHUNK ? D : D_CHUNK);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = (int64_t)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (n >= N) return;  // warp-uniform
  const int slot = 21 * DC;  // J (18 DC), r (2 DC), w (DC)
  Acc* Js = reinterpret_cast<Acc*>(smem_raw) + warp * slot;
  Acc* rs = Js + 18 * DC;
  Acc* ws = rs + 2 * DC;

  // this lane's outputs: q = lane (always in G) and q = lane + 32; q < 45
  // is G's upper-triangle entry q (row-major), then g's 9
  int oi[2], oj[2];
  Acc acc[2] = {Acc(0), Acc(0)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = lane + 32 * h;
    if (q < N_SYM) {  // walk the upper triangle's rows of 9, 8, ..., 1
      int rem = q;
      int i = 0;
      while (rem >= 9 - i) {
        rem -= 9 - i;
        ++i;
      }
      oi[h] = i;
      oj[h] = i + rem;
    } else {
      oi[h] = q - N_SYM;
      oj[h] = 9;
    }
  }

  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = D - d0 < DC ? D - d0 : DC;
    bool staged = false;
    if constexpr (DT > 0) {
      if (pairs) {
        stage_all<In, Acc, DT>(J, r, w, Js, n, lane);
        staged = true;
      }
    }
    if (!staged) {
      const int64_t row0 = n * D + d0;
      stage(J + row0 * 18, Js, 18 * dc, pairs, lane);
      stage(r + row0 * 2, rs, 2 * dc, pairs, lane);
      stage(w + row0, ws, dc, pairs, lane);
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lane + 32 * h < N_OUT)
        acc[h] = reduce_one<Acc, DT>(Js, rs, ws, oi[h], oj[h], dc, acc[h]);
    }
    __syncwarp();  // the slot is restaged by the next chunk
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (lane + 32 * h >= N_OUT) break;
    const int i = oi[h], j = oj[h];
    const Acc v = acc[h];
    if (j < 9) {
      G[n * 81 + i * 9 + j] = (In)v;
      if (i != j) G[n * 81 + j * 9 + i] = (In)v;
    } else {
      g[n * 9 + i] = (In)v;
    }
  }
}

template <typename In, typename Acc>
int launch(const In* J, const In* r, const In* w, In* G, In* g, int64_t N,
           int D, cudaStream_t st) {
  if (N == 0) return 0;
  if (D <= 0) return (int)cudaErrorInvalidValue;
  const int DC = D < D_CHUNK ? D : D_CHUNK;
  const size_t smem = (size_t)WARPS_PER_BLOCK * 21 * DC * sizeof(Acc);
  const uintptr_t align = 2 * sizeof(In);
  const bool pairs = (((uintptr_t)J | (uintptr_t)r | (uintptr_t)w) %
                      align) == 0;
  const unsigned blocks =
      (unsigned)((N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const unsigned threads = 32 * WARPS_PER_BLOCK;
  if (D == 4)
    normal_eq_kernel<In, Acc, 4><<<blocks, threads, smem, st>>>(
        J, r, w, G, g, N, D, pairs);
  else
    normal_eq_kernel<In, Acc, 0><<<blocks, threads, smem, st>>>(
        J, r, w, G, g, N, D, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// J (N,D,2,9), r (N,D,2), w (N,D) of one dtype (is_f64: 1 double, 0
// float); G (N,9,9) and g (N,9) outputs of the same dtype -- all
// contiguous device memory.  f32_sums: sum in f32 (f64 inputs are rounded
// on load, the results stored as f64).  Launches on `stream`; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for D < 1).
int vinsat_normal_eq(const void* J, const void* r, const void* w, void* G,
                     void* g, long long N, int D, int is_f64, int f32_sums,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64 && !f32_sums)
    return launch<double, double>((const double*)J, (const double*)r,
                                  (const double*)w, (double*)G, (double*)g,
                                  N, D, st);
  if (is_f64)
    return launch<double, float>((const double*)J, (const double*)r,
                                 (const double*)w, (double*)G, (double*)g,
                                 N, D, st);
  return launch<float, float>((const float*)J, (const float*)r,
                              (const float*)w, (float*)G, (float*)g, N, D,
                              st);
}

}  // extern "C"
