// Block-tridiagonal solve by parallel cyclic reduction (PCR), batched, for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// vinsat_tpu_torch/kernels/tridiag_pcr.py.
//
// Replaces the TPU kernel vinsat_tpu/kernels/tridiag_pallas.py
// (block_tridiag_solve_pallas, pallas_call at :178; body _kernel :125,
// elimination _gj_refs :97).  Same algorithm and elimination order: at
// level s every row i holds  L_i x_{i-s} + D_i x_i + U_i x_{i+s} = b_i;
// one pivot-free Gauss-Jordan pass forms P = D^{-1} [L, U, b] for all rows,
// then
//     D'_i = D_i - L_i PU_{i-s} - U_i PL_{i+s}
//     b'_i = b_i - L_i Pb_{i-s} - U_i Pb_{i+s}
//     L'_i = -L_i PL_{i-s}          U'_i = -U_i PU_{i+s}
// and s doubles; after ceil(log2 N) levels x_i = D_i^{-1} b_i.  Rows out of
// range count as zero blocks (no padding to 128 as on the TPU lanes).
//
// What bounds it on this card: the level state.  Per row it is D, L, U
// (3 x 81 values) + b, and P = D^{-1}[L, U, b] (2 x 81 + 9): 3.4 KB per
// row in f64, 5.4 KB with the next level's copy, 21.8 MB of scratch at the
// main path's B=9, N=448 — ~100x one SM's 227 KB of shared memory, so the
// TPU design (everything resident in one core's VMEM across all levels)
// does not carry over.  The state ping-pongs in
// global memory instead; at these sizes it stays in the 50 MB L2, and the
// work per level (~2.3k FMAs per row) is small, so a level costs about two
// launch latencies.  The solve is latency-bound: 2 launches per level +
// 2, i.e. 20 launches at N=448.
//
// What the design does about it: one warp owns one (batch, row).
//   * Gauss-Jordan pass: lane c holds column c of the 9 x 28 augmented
//     block [D | L | U | b] in 9 registers; each pivot step broadcasts the
//     pivot column with __shfl_sync, so no shared memory and no
//     serialisation across rows.  The arithmetic per element is the JAX
//     kernel's: row_i = M_i / piv; M_r -= A_ri * row_i.
//   * Update pass: the row's L_i, U_i are staged in shared memory once per
//     warp; lanes 0-8 form D' columns, 9-17 L' columns, 18-26 U' columns,
//     lane 27 b', each a 9-term ordered dot product as in _bmm_lanes.
// Making it fast (fusing levels, keeping a block's rows in shared memory
// or a thread-block cluster) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 9;
constexpr int KK = K * K;
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

// Level state: D, L, U blocks (R x 81 each) and b (R x 9), R = B * N.
template <typename T>
struct Level {
  T* D;
  T* L;
  T* U;
  T* b;
};

template <typename T>
__host__ __device__ Level<T> level_at(T* base, int64_t R) {
  Level<T> s;
  s.D = base;
  s.L = base + R * KK;
  s.U = base + 2 * R * KK;
  s.b = base + 3 * R * KK;
  return s;
}

// W0 from the inputs: L_i = U_{i-1}^T (zero at i=0), U_{N-1} = 0.
template <typename T>
__global__ void pcr_init(const T* __restrict__ D, const T* __restrict__ U,
                         const T* __restrict__ b, Level<T> w, int64_t B,
                         int64_t N, int64_t u_batch_stride) {
  int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  int64_t R = B * N;
  if (t >= R * KK) return;
  int64_t g = t / KK;
  int e = (int)(t % KK);
  int r = e / K, c = e % K;
  int64_t bi = g / N, i = g % N;
  const T* Ub = U + bi * u_batch_stride;
  w.D[t] = D[t];
  w.U[t] = (i < N - 1) ? Ub[i * KK + e] : T(0);
  w.L[t] = (i > 0) ? Ub[(i - 1) * KK + c * K + r] : T(0);
  if (e < K) w.b[g * K + e] = b[g * K + e];
}

// P = D^{-1} [L, U, b] per (batch, row); with_lu == 0 solves D x = b only
// (the final back-solve), writing x into Pb.
template <typename T>
__global__ void pcr_gauss_jordan(Level<T> w, T* __restrict__ PL,
                                 T* __restrict__ PU, T* __restrict__ Pb,
                                 int64_t R, int with_lu) {
  int64_t g = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x & 31;
  if (g >= R) return;  // uniform across the warp
  // lane c: 0-8 D col, 9-17 L col, 18-26 U col, 27 b; others idle
  const T* src = nullptr;
  int col = 0, stride = K;
  if (lane < 9) {
    src = w.D + g * KK;
    col = lane;
  } else if (lane < 18 && with_lu) {
    src = w.L + g * KK;
    col = lane - 9;
  } else if (lane < 27 && with_lu) {
    src = w.U + g * KK;
    col = lane - 18;
  } else if (lane == 27) {
    src = w.b + g * K;
    col = 0;
    stride = 1;
  }
  T a[K];
#pragma unroll
  for (int r = 0; r < K; ++r) a[r] = src ? src[r * stride + col] : T(0);

#pragma unroll
  for (int i = 0; i < K; ++i) {
    T piv = __shfl_sync(FULL, a[i], i);  // D[i][i]: lane i holds column i
    T row_i = a[i] / piv;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      T f = __shfl_sync(FULL, a[r], i);  // A[r][i] before this step
      if (r != i) a[r] -= f * row_i;
    }
    a[i] = row_i;
  }

  T* dst = nullptr;
  if (lane >= 9 && lane < 18 && with_lu) {
    dst = PL + g * KK;
    col = lane - 9;
  } else if (lane >= 18 && lane < 27 && with_lu) {
    dst = PU + g * KK;
    col = lane - 18;
  } else if (lane == 27) {
    dst = Pb + g * K;
  }
  if (dst) {
#pragma unroll
    for (int r = 0; r < K; ++r) dst[r * stride + col] = a[r];
  }
}

// One PCR level: w (level s) + P -> nw (level 2s).
template <typename T>
__global__ void pcr_update(Level<T> w, const T* __restrict__ PL,
                           const T* __restrict__ PU,
                           const T* __restrict__ Pb, Level<T> nw, int64_t B,
                           int64_t N, int64_t s) {
  __shared__ T sm[WARPS_PER_BLOCK][2 * KK];
  int wib = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int64_t g = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  if (g >= B * N) return;  // uniform across the warp
  int64_t i = g % N;
  bool has_m = i - s >= 0, has_p = i + s < N;
  int64_t gm = g - s, gp = g + s;

  T* Ls = sm[wib];
  T* Us = sm[wib] + KK;
  for (int e = lane; e < KK; e += 32) {
    Ls[e] = w.L[g * KK + e];
    Us[e] = w.U[g * KK + e];
  }
  __syncwarp();

  if (lane < 9) {  // D'[:, c] = D - L PU_{i-s} - U PL_{i+s}
    int c = lane;
    T pm[K], pp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pm[j] = has_m ? PU[gm * KK + j * K + c] : T(0);
      pp[j] = has_p ? PL[gp * KK + j * K + c] : T(0);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      T x = Ls[r * K] * pm[0];
      T y = Us[r * K] * pp[0];
#pragma unroll
      for (int j = 1; j < K; ++j) {
        x += Ls[r * K + j] * pm[j];
        y += Us[r * K + j] * pp[j];
      }
      nw.D[g * KK + r * K + c] = (w.D[g * KK + r * K + c] - x) - y;
    }
  } else if (lane < 18) {  // L'[:, c] = -L PL_{i-s}
    int c = lane - 9;
    T pm[K];
#pragma unroll
    for (int j = 0; j < K; ++j) pm[j] = has_m ? PL[gm * KK + j * K + c] : T(0);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      T x = Ls[r * K] * pm[0];
#pragma unroll
      for (int j = 1; j < K; ++j) x += Ls[r * K + j] * pm[j];
      nw.L[g * KK + r * K + c] = -x;
    }
  } else if (lane < 27) {  // U'[:, c] = -U PU_{i+s}
    int c = lane - 18;
    T pp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) pp[j] = has_p ? PU[gp * KK + j * K + c] : T(0);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      T y = Us[r * K] * pp[0];
#pragma unroll
      for (int j = 1; j < K; ++j) y += Us[r * K + j] * pp[j];
      nw.U[g * KK + r * K + c] = -y;
    }
  } else if (lane == 27) {  // b' = b - L Pb_{i-s} - U Pb_{i+s}
    T pm[K], pp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pm[j] = has_m ? Pb[gm * K + j] : T(0);
      pp[j] = has_p ? Pb[gp * K + j] : T(0);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      T x = Ls[r * K] * pm[0];
      T y = Us[r * K] * pp[0];
#pragma unroll
      for (int j = 1; j < K; ++j) {
        x += Ls[r * K + j] * pm[j];
        y += Us[r * K + j] * pp[j];
      }
      nw.b[g * K + r] = (w.b[g * K + r] - x) - y;
    }
  }
}

int64_t work_elems(int64_t B, int64_t N) {
  int64_t R = B * N;
  // two level buffers (3*81 + 9 each) + P (2*81 + 9)
  return R * (2 * (3 * KK + K) + 2 * KK + K);
}

template <typename T>
int solve(const T* D, const T* U, const T* b, T* x, T* work, int64_t B,
          int64_t N, int u_batched, cudaStream_t st) {
  int64_t R = B * N;
  if (R == 0) return 0;
  Level<T> cur = level_at<T>(work, R);
  Level<T> nxt = level_at<T>(work + R * (3 * KK + K), R);
  T* PL = work + 2 * R * (3 * KK + K);
  T* PU = PL + R * KK;
  T* Pb = PU + R * KK;
  int64_t u_stride = u_batched ? (N - 1) * KK : 0;

  const int threads = 32 * WARPS_PER_BLOCK;
  const unsigned warp_blocks = (unsigned)((R + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const unsigned elem_blocks = (unsigned)((R * KK + threads - 1) / threads);
  cudaError_t err;

  pcr_init<T><<<elem_blocks, threads, 0, st>>>(D, U, b, cur, B, N, u_stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int64_t s = 1; s < N; s *= 2) {
    pcr_gauss_jordan<T><<<warp_blocks, threads, 0, st>>>(cur, PL, PU, Pb, R, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pcr_update<T><<<warp_blocks, threads, 0, st>>>(cur, PL, PU, Pb, nxt, B, N, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    Level<T> t = cur;
    cur = nxt;
    nxt = t;
  }
  pcr_gauss_jordan<T><<<warp_blocks, threads, 0, st>>>(cur, nullptr, nullptr, x, R, 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of scratch (of the solve's dtype) the caller allocates.
long long vinsat_tridiag_pcr_work_elems(long long B, long long N) {
  return (long long)work_elems(B, N);
}

// D (B,N,9,9), U (B,N-1,9,9) or (N-1,9,9) when u_batched == 0, b (B,N,9),
// x (B,N,9) out, work (vinsat_tridiag_pcr_work_elems) — all contiguous
// device memory of one dtype (is_f64: 1 double, 0 float).  Launches on
// `stream`; returns the first cudaGetLastError() that is not success.
int vinsat_tridiag_pcr(const void* D, const void* U, const void* b, void* x,
                       void* work, long long B, long long N, int u_batched,
                       int is_f64, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64)
    return solve<double>((const double*)D, (const double*)U, (const double*)b,
                         (double*)x, (double*)work, B, N, u_batched, st);
  return solve<float>((const float*)D, (const float*)U, (const float*)b,
                      (float*)x, (float*)work, B, N, u_batched, st);
}

}  // extern "C"
