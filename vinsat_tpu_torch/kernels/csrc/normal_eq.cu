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
// each Jacobian row is first weighted (JW = J * w), then multiplied, and
// the 2D rows are summed in order d = 0..D-1, k = 0..1.  It is instantiated
// for f32 and f64; the wrapper casts for the TPU kernel's f32 contract.
//
// What bounds it on this card: the bytes.  At the long arc's shape (2168
// knots, D = 4, f64) it reads 72 + 8 + 4 doubles and writes 90 per knot,
// ~3 MB in all (~0.9 us at 3.35 TB/s), and does 2 x 8 x 90 flops per knot
// (3.1 Mflop, ~0.1 us at the f64 peak).  Either way it sits at the launch
// latency; it runs once per LM iteration.
//
// What the design does about it: a block takes KNOTS_PER_BLOCK knots, and
// its threads first copy each knot's 2D x 9 Jacobian rows, residuals and
// weights from device memory into shared memory with neighbouring threads
// on neighbouring addresses (one coalesced pass over the block's
// contiguous slice), weighting the rows as they land.  Then each of 90
// threads per knot owns one output (81 entries of G, 9 of g) and reduces
// over the 2D rows in a register.  The TPU layout (knots tiled by 8 on
// sublanes, the D * 18 Jacobian entries on lanes, G and g packed into a
// 128-lane output row) does not carry over: the outputs are written
// straight to (N, 9, 9) and (N, 9).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KNOTS_PER_BLOCK = 4;
constexpr int OUTS = 90;  // 81 entries of G, then 9 of g

template <typename T>
__global__ void normal_eq_kernel(const T* __restrict__ J,
                                 const T* __restrict__ r,
                                 const T* __restrict__ w, T* __restrict__ G,
                                 T* __restrict__ g, int64_t N, int D) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int R = 2 * D;  // Jacobian rows per knot
  // per knot: J rows (R x 9), weighted rows (R x 9), residuals (R)
  const int per_knot = 19 * R;
  const int64_t n0 = (int64_t)blockIdx.x * KNOTS_PER_BLOCK;
  const int nk = (int)((N - n0) < KNOTS_PER_BLOCK ? (N - n0) : KNOTS_PER_BLOCK);

  // stage: J and r are contiguous over the block's knots
  const int nJ = nk * R * 9;
  for (int i = threadIdx.x; i < nJ; i += blockDim.x) {
    const int kn = i / (R * 9);
    const int e = i - kn * (R * 9);
    const int row = e / 9;
    const T v = J[n0 * R * 9 + i];
    T* s = smem + kn * per_knot;
    s[e] = v;
    s[R * 9 + e] = v * w[(n0 + kn) * D + row / 2];
  }
  for (int i = threadIdx.x; i < nk * R; i += blockDim.x) {
    const int kn = i / R;
    smem[kn * per_knot + 18 * R + (i - kn * R)] = r[n0 * R + i];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < nk * OUTS; o += blockDim.x) {
    const int kn = o / OUTS;
    const int q = o - kn * OUTS;
    const T* Js = smem + kn * per_knot;
    const T* JWs = Js + R * 9;
    const T* rs = Js + 18 * R;
    T acc = T(0);
    if (q < 81) {
      const int i = q / 9, j = q % 9;
      for (int row = 0; row < R; ++row) acc += JWs[row * 9 + i] * Js[row * 9 + j];
      G[(n0 + kn) * 81 + q] = acc;
    } else {
      const int i = q - 81;
      for (int row = 0; row < R; ++row) acc += JWs[row * 9 + i] * rs[row];
      g[(n0 + kn) * 9 + i] = acc;
    }
  }
}

template <typename T>
int launch(const T* J, const T* r, const T* w, T* G, T* g, int64_t N, int D,
           cudaStream_t st) {
  if (N == 0) return 0;
  if (D <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)KNOTS_PER_BLOCK * 19 * 2 * D * sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((N + KNOTS_PER_BLOCK - 1) / KNOTS_PER_BLOCK);
  // 96 threads (three warps) per knot: each of the block's
  // KNOTS_PER_BLOCK x 90 outputs has a thread of its own
  normal_eq_kernel<T><<<blocks, 96 * KNOTS_PER_BLOCK, smem, st>>>(
      J, r, w, G, g, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// J (N,D,2,9), r (N,D,2), w (N,D) of one dtype (is_f64: 1 double, 0
// float); G (N,9,9) and g (N,9) outputs of the same dtype — all contiguous
// device memory.  Launches on `stream`; returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a D the shared memory cannot hold).
int vinsat_normal_eq(const void* J, const void* r, const void* w, void* G,
                     void* g, long long N, int D, int is_f64, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64)
    return launch<double>((const double*)J, (const double*)r,
                          (const double*)w, (double*)G, (double*)g, N, D, st);
  return launch<float>((const float*)J, (const float*)r, (const float*)w,
                       (float*)G, (float*)g, N, D, st);
}

}  // extern "C"
