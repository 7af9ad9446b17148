// Block-tridiagonal solve by parallel cyclic reduction (PCR), batched, for
// Hopper (sm_90a): one persistent cooperative kernel per solve.  Plain C
// interface, loaded with ctypes by vinsat_tpu_torch/kernels/tridiag_pcr.py.
//
// Replaces the TPU kernel vinsat_tpu/kernels/tridiag_pallas.py
// (block_tridiag_solve_pallas, pallas_call at :178; body _kernel :125,
// elimination _gj_refs :97).  Same algorithm and elimination order: at
// level s every row i holds  L_i x_{i-s} + D_i x_i + U_i x_{i+s} = b_i;
// one pivot-free Gauss-Jordan pass forms P_i = D_i^{-1} [L_i, U_i, b_i],
// then
//     D'_i = D_i - L_i PU_{i-s} - U_i PL_{i+s}
//     b'_i = b_i - L_i Pb_{i-s} - U_i Pb_{i+s}
//     L'_i = -L_i PL_{i-s}          U'_i = -U_i PU_{i+s}
// and s doubles; after ceil(log2 N) levels x_i = D_i^{-1} b_i.  Rows out of
// range count as zero blocks (no padding to 128 as on the TPU lanes).
//
// What bounds it on this card.  At the main path's B=9, N=448 in f64 the
// solve needs ~307 Mflop (per level and row, the Gauss-Jordan on the
// columns of [D | L U b] not yet reduced and the update's block products,
// leaving out blocks that are zero by structure; then the 9 x 10 solves:
// chip_smoke.py _pcr_flops), 4.6 us at the card's 67 TFLOP/s f64 peak.
// The 9 levels are sequential and each is ~8.5k flops a row, which the
// design spreads over a warp's lanes, so the time goes to latency and to
// the data handed to each lane: one grid-wide barrier per level, the
// neighbours' P read through L2, and within a row the 9 dependent pivot
// steps (a shuffled pivot column and an f64 divide each) and the update,
// in which every lane reads all of L and U to form its column.
// k1_study.py times builds of this file with each of those parts cut out,
// which says how the time splits (PERF.md).  The level state (3.4 KB a row
// in f64, 13.6 MB at B=9, N=448) is ~60x one SM's shared memory, so the
// TPU design (everything in one core's VMEM across levels) does not carry
// over.
//
// What the design does about it:
//   * One launch: a cooperative grid sized to the co-resident limit, a
//     warp per (batch, row), grid-stride where B*N exceeds the resident
//     warps (4224 at 64 registers a thread).  cooperative_groups'
//     grid.sync() takes the place of the launch boundaries: one barrier
//     per level, ceil(log2 N) in all; it needs no -rdc.
//   * Only P crosses rows, so only P is shared, double-buffered in global
//     memory and read through L2 (__ldcg).  A row's own D, L, U, b are
//     touched only by its warp and updated in place: in the warp's
//     shared-memory slot when each warp owns at most one row, else in
//     global scratch, staged through the slot for each row.
//   * The update of level s and the Gauss-Jordan of the next level are one
//     step: lane c holds column c of the augmented block [D | L | U | b]
//     (lanes 0-8 D, 9-17 L, 18-26 U, 27 b), which is also the column the
//     update produces, so the new block is formed in the registers the
//     elimination runs on.  Every 9-vector (a block's column, a column of
//     P) is padded to 16-byte multiples and moves in 16-byte accesses; the
//     two neighbours' P columns are loaded at once, one parked in shared
//     memory to spare registers.  Every lane runs the same ordered 9-term
//     dot products (absent terms are zero), so the warp does not diverge.
//   * Gauss-Jordan: each pivot step broadcasts the pivot column with
//     __shfl_sync; the arithmetic per element is the JAX kernel's:
//     row_i = M_i / piv; M_r -= A_ri * row_i.
//   * After the last level each warp solves its own row, x_i = D_i^{-1} b_i,
//     with no barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int K = 9;
constexpr int KK = K * K;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = 32 * WARPS_PER_BLOCK;
// 4 blocks of 8 warps an SM: at most 64 registers a thread, so that one
// warp per row still fits the main path's 4032 rows on 132 SMs
constexpr int MIN_BLOCKS_PER_SM = 4;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Vec;  // the 16-byte vector of T
template <>
struct Vec<double> {
  using type = double2;
  __device__ static void put(const double2& v, double* o) {
    o[0] = v.x;
    o[1] = v.y;
  }
  __device__ static double2 get(const double* o) {
    return make_double2(o[0], o[1]);
  }
};
template <>
struct Vec<float> {
  using type = float4;
  __device__ static void put(const float4& v, float* o) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static float4 get(const float* o) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};

// Layout, in values of T.  A 9-vector (a column of a block or of P) is
// padded to LP values, so that it moves in NV 16-byte accesses.
template <typename T>
struct Lay {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LP = (K + VEC - 1) / VEC * VEC;  // 10 (f64), 12 (f32)
  static constexpr int NV = LP / VEC;
  // a row's state: the 28 columns of [D | L | U | b], column k at k * LP
  static constexpr int ROW = 28 * LP;
  // a row's P: the columns of PL, then of PU, then Pb
  static constexpr int PROW = (2 * K + 1) * LP;
  // a warp's shared-memory slot: a row's state and a column per lane for
  // the P of row i+s
  static constexpr int STAGE = ROW;
  static constexpr int SLOT = STAGE + 28 * LP;
};

// v[0..LP) from p (16-byte aligned); l2: through L2 only (P written by
// other SMs since the last barrier)
template <typename T, bool l2>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[Lay<T>::LP]) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int k = 0; k < Lay<T>::NV; ++k) {
    const V* q = reinterpret_cast<const V*>(p) + k;
    Vec<T>::put(l2 ? __ldcg(q) : *q, v + k * Lay<T>::VEC);
  }
}

// a[0..K) to p (16-byte aligned), zero padded
template <typename T, int M>
__device__ __forceinline__ void store_vec(T* p, const T (&a)[M]) {
  using V = typename Vec<T>::type;
  T v[Lay<T>::LP];
#pragma unroll
  for (int r = 0; r < Lay<T>::LP; ++r) v[r] = r < K ? a[r] : T(0);
#pragma unroll
  for (int k = 0; k < Lay<T>::NV; ++k)
    reinterpret_cast<V*>(p)[k] = Vec<T>::get(v + k * Lay<T>::VEC);
}

// Pivot-free Gauss-Jordan of the 9 x 28 block held a column per lane; lane
// i broadcasts the pivot column of step i.
template <typename T>
__device__ __forceinline__ void gauss_jordan(T (&a)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T f[K];  // the pivot column A[:, i] before this step
#pragma unroll
    for (int r = 0; r < K; ++r) f[r] = __shfl_sync(FULL, a[r], i);
    T row_i = a[i] / f[i];
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (r != i) a[r] -= f[r] * row_i;
    a[i] = row_i;
  }
}

// acc = M v for the 9 x 9 block M stored by columns at m: the same ordered
// 9-term dot product per row as _bmm_lanes (the first term a product, then
// j = 1..8 added in turn), formed a column of M at a time.
template <typename T>
__device__ __forceinline__ void block_times(const T* m, const T (&v)[Lay<T>::LP],
                                            T (&acc)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T col[Lay<T>::LP];
    load_vec<T, false>(m + j * Lay<T>::LP, col);
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = j == 0 ? col[r] * v[0] : acc[r] + col[r] * v[j];
  }
}

// D (B,N,9,9), U (B,N-1,9,9) or shared (u_stride 0), b (B,N,9) -> x.
// state: B*N rows of Lay::ROW, read only when B*N exceeds the grid's warps
// (null otherwise); P0, P1: B*N rows of Lay::PROW each.  Dynamic shared memory: a slot of
// Lay::SLOT values per warp.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
pcr_solve(const T* __restrict__ D, const T* __restrict__ U,
          const T* __restrict__ b, T* __restrict__ x, T* state, T* P0, T* P1,
          int64_t B, int64_t N, int64_t u_stride) {
  using L = Lay<T>;
  using V = typename Vec<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  T* slot = reinterpret_cast<T*>(smem) + (threadIdx.x >> 5) * L::SLOT;
  const bool active = lane < 28;
  // this lane's stage (lanes 28-31 read lane 0's and write nothing)
  T* stage = slot + L::STAGE + (active ? lane : 0) * L::LP;
  // row indices fit 32 bits (solve() checks); element offsets are 64-bit
  const int R = (int)(B * N), n = (int)N;
  const int nwarps = gridDim.x * WARPS_PER_BLOCK;
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const bool resident = R <= nwarps;

  // Lane l < 28 holds column l of the row's [D | L | U | b], at l * LP of
  // its state.  Lanes 28-31 hold nothing and run along with zeros.
  const int c = lane % K;
  const int own = lane * L::LP;
  const bool has_own = lane < 9 || lane == 27;  // D' and b' keep D and b
  // where in a row's P this lane's column of the update reads the vector
  // that multiplies L (row i-s) and U (row i+s); -1 where it is absent
  int vm_off = -1, vp_off = -1;
  if (lane < 9) {
    vm_off = (K + c) * L::LP;  // PU_{i-s}
    vp_off = c * L::LP;        // PL_{i+s}
  } else if (lane < 18) {
    vm_off = c * L::LP;  // PL_{i-s}
  } else if (lane < 27) {
    vp_off = (K + c) * L::LP;  // PU_{i+s}
  } else if (lane == 27) {
    vm_off = vp_off = 2 * K * L::LP;  // Pb_{i-s}, Pb_{i+s}
  }
  const int p_off = (lane - 9) * L::LP;  // this lane's column of its own P

  // Level 0: the rows from the inputs (L_i = U_{i-1}^T, zero at i = 0;
  // U_{N-1} = 0), then P^0.
  for (int g = warp; g < R; g += nwarps) {
    const int bi = g / n, i = g % n;
    const T* Ub = U + bi * u_stride;
    T a[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      T v = T(0);
      if (lane < 9)
        v = D[(int64_t)g * KK + r * K + c];
      else if (lane < 18)
        v = i > 0 ? Ub[(int64_t)(i - 1) * KK + c * K + r] : T(0);
      else if (lane < 27)
        v = i < n - 1 ? Ub[(int64_t)i * KK + r * K + c] : T(0);
      else if (lane == 27)
        v = b[(int64_t)g * K + r];
      a[r] = v;
    }
    if (n > 1 && active) store_vec((resident ? slot : state + (int64_t)g * L::ROW) + own, a);
    gauss_jordan(a);
    if (n == 1) {
      if (lane == 27) {
#pragma unroll
        for (int r = 0; r < K; ++r) x[(int64_t)g * K + r] = a[r];
      }
    } else if (lane >= 9 && active) {
      store_vec(P0 + (int64_t)g * L::PROW + p_off, a);
    }
  }

  // Levels s = 1, 2, 4, ...: one barrier each, then every row's update
  // fused with its next Gauss-Jordan.
  T* cur = P0;
  T* nxt = P1;
  for (int s = 1; s < n; s *= 2) {
    grid.sync();
    const bool last = 2 * s >= n;
    for (int g = warp; g < R; g += nwarps) {
      const int i = g % n;
      if (!resident) {
        const V* src = reinterpret_cast<const V*>(state + (int64_t)g * L::ROW);
        for (int e = lane; e < L::ROW / L::VEC; e += 32)
          reinterpret_cast<V*>(slot)[e] = src[e];
      }
      // both neighbours' P columns in flight at once; the one for U waits
      // in this lane's stage
      T v[L::LP], w[L::LP];
      if (vm_off >= 0 && i >= s)
        load_vec<T, true>(cur + (int64_t)(g - s) * L::PROW + vm_off, v);
      else
#pragma unroll
        for (int j = 0; j < L::LP; ++j) v[j] = T(0);
      if (vp_off >= 0 && i + s < n)
        load_vec<T, true>(cur + (int64_t)(g + s) * L::PROW + vp_off, w);
      else
#pragma unroll
        for (int j = 0; j < L::LP; ++j) w[j] = T(0);
      if (active) store_vec(stage, w);
      __syncwarp();
      // a = (own - L P_{i-s}) - U P_{i+s}, the same on every lane (a lane
      // without a term multiplies zeros), so the warp does not diverge
      T a[K], acc[K];
      block_times(slot + K * L::LP, v, acc);
      load_vec<T, false>(slot + own, v);
#pragma unroll
      for (int r = 0; r < K; ++r) a[r] = (has_own ? v[r] : T(0)) - acc[r];
      load_vec<T, false>(stage, v);
      block_times(slot + 2 * K * L::LP, v, acc);
#pragma unroll
      for (int r = 0; r < K; ++r) a[r] -= acc[r];
      __syncwarp();  // every lane has read the old state
      if (!last && active) store_vec((resident ? slot : state + (int64_t)g * L::ROW) + own, a);
      gauss_jordan(a);
      if (last) {
        if (lane == 27) {
#pragma unroll
          for (int r = 0; r < K; ++r) x[(int64_t)g * K + r] = a[r];
        }
      } else if (lane >= 9 && active) {
        store_vec(nxt + (int64_t)g * L::PROW + p_off, a);
      }
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)WARPS_PER_BLOCK * Lay<T>::SLOT * sizeof(T);
}
// within the 48 KB a launch gets without opting in
static_assert(smem_bytes<double>() <= 48 * 1024, "shared slot too large");
static_assert(smem_bytes<float>() <= 48 * 1024, "shared slot too large");

// Co-resident blocks of pcr_solve<T> on the current device, queried once
// per device and dtype.
template <typename T>
cudaError_t grid_limit(int* blocks) {
  static int cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pcr_solve<T>, THREADS, smem_bytes<T>());
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

// Scratch of the solve, in values of T: the two P buffers, then the rows'
// state where B*N exceeds the resident warps (in shared memory otherwise).
// A negative value is a CUDA error, negated.
template <typename T>
int64_t work_elems(int64_t B, int64_t N) {
  int limit = 0;
  cudaError_t err = grid_limit<T>(&limit);
  if (err != cudaSuccess) return -(int64_t)err;
  const int64_t R = B * N;
  const bool resident = R <= (int64_t)limit * WARPS_PER_BLOCK;
  return R * (2 * Lay<T>::PROW + (resident ? 0 : Lay<T>::ROW));
}

template <typename T>
int solve(const T* D, const T* U, const T* b, T* x, T* work, int64_t B,
          int64_t N, int u_batched, cudaStream_t st) {
  int64_t R = B * N;
  if (R == 0) return 0;
  // 32-bit row indices (g + s stays below INT_MAX)
  if (R > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = grid_limit<T>(&limit);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (R + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > limit) blocks = limit;
  T* P0 = work;
  T* P1 = P0 + R * Lay<T>::PROW;
  // read only where the grid holds fewer warps than rows (work_elems)
  T* state = R <= (int64_t)limit * WARPS_PER_BLOCK ? nullptr
                                                   : P1 + R * Lay<T>::PROW;
  int64_t u_stride = u_batched ? (N - 1) * KK : 0;
  void* args[] = {&D, &U, &b, &x, &state, &P0, &P1, &B, &N, &u_stride};
  err = cudaLaunchCooperativeKernel((const void*)pcr_solve<T>,
                                    dim3((unsigned)blocks), dim3(THREADS),
                                    args, smem_bytes<T>(), st);
  // clear the error a refused launch leaves behind, so that it is reported
  // here and not by the next launch of the process
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Elements of scratch of the solve's dtype (is_f64: 1 double, 0 float)
// the caller allocates on the current device.  A negative value is a CUDA
// error, negated.
long long vinsat_tridiag_pcr_work_elems(long long B, long long N, int is_f64) {
  return (long long)(is_f64 ? work_elems<double>(B, N)
                            : work_elems<float>(B, N));
}

// Warps the solve keeps resident on the current device (is_f64: 1 double,
// 0 float): one row each at B*N up to this, grid-stride above it.  A
// negative value is a CUDA error, negated.
long long vinsat_tridiag_pcr_resident_warps(int is_f64) {
  int blocks = 0;
  cudaError_t err = is_f64 ? grid_limit<double>(&blocks)
                           : grid_limit<float>(&blocks);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)blocks * WARPS_PER_BLOCK;
}

// D (B,N,9,9), U (B,N-1,9,9) or (N-1,9,9) when u_batched == 0, b (B,N,9),
// x (B,N,9) out, work (vinsat_tridiag_pcr_work_elems) — all contiguous
// device memory of one dtype (is_f64: 1 double, 0 float).  One cooperative
// launch on `stream`; returns its CUDA error (0 on success).
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
