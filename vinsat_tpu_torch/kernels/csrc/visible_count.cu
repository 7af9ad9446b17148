// Landmark-visibility count per footprint box, for Hopper (sm_90a).  Plain
// C interface, loaded with ctypes by vinsat_tpu_torch/kernels/visible_count.py.
//
// Replaces the TPU kernel vinsat_tpu/kernels/matching.py (visible_count,
// pallas_call at :72; body _visible_count_kernel :20).  For every frame f
// it counts the landmarks l with best[l] != 0 strictly inside the box
// bounds[f] = (lon_min, lat_min, lon_max, lat_max):
//     (lon_min < lon < lon_max  or  lon_min < lon + 360 < lon_max)
//     and lat_min < lat < lat_max
// (the lon + 360 test catches boxes that wrap the antimeridian, whose
// lon_max exceeds 180).  A NaN bound compares false, so its frame counts 0.
// The arithmetic is that of visible_count_reference (matching.py:88), in
// the input's dtype: f64 for the simulator, f32 for the TPU kernel's cast.
//
// What bounds it on this card: the compares.  The simulator's gate runs it
// at F = 10801 frames x L = 7920 landmarks: 85.5M pairs x 8 compares, about
// 10 us at the card's 67 TFLOP/s f64 peak (20 us at the 34 TFLOP/s outside
// the tensor cores), while the bytes (bounds 346 KB, landmarks 135 KB,
// counts 43 KB) move in under 1 us.  The landmark arrays are read by every
// frame, so they stay in the 50 MB L2 after the first warps touch them.
//
// What the design does about it: one warp per frame, lanes striding over
// the landmarks (neighbouring lanes on neighbouring addresses, so each
// load is one coalesced transaction), the four bounds held in registers,
// an integer count per lane and a __shfl_down_sync reduction; lane 0
// writes the int32 count.  The TPU layout (F padded to 8, L to 128 with
// 1e9 landmarks and empty boxes) does not carry over: the loop bound and
// the grid guard mask the ragged edges.  Tiling landmarks through shared
// memory for several frames per warp is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__global__ void visible_count_kernel(const T* __restrict__ bounds,
                                     const T* __restrict__ lon,
                                     const T* __restrict__ lat,
                                     const unsigned char* __restrict__ best,
                                     int* __restrict__ out, int64_t F,
                                     int64_t L) {
  const int lane = threadIdx.x & 31;
  const int64_t f = blockIdx.x * (int64_t)WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (f >= F) return;  // whole warps leave together: f is warp-uniform
  const T lon_min = bounds[4 * f + 0];
  const T lat_min = bounds[4 * f + 1];
  const T lon_max = bounds[4 * f + 2];
  const T lat_max = bounds[4 * f + 3];
  const T wrap = T(360);
  int n = 0;
  for (int64_t l = lane; l < L; l += 32) {
    const T lo = lon[l];
    const T la = lat[l];
    const T lo_w = lo + wrap;
    const bool in_lon = (lo > lon_min && lo < lon_max) ||
                        (lo_w > lon_min && lo_w < lon_max);
    n += (in_lon && la > lat_min && la < lat_max && best[l] != 0) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(FULL, n, off);
  if (lane == 0) out[f] = n;
}

template <typename T>
int launch(const T* bounds, const T* lon, const T* lat,
           const unsigned char* best, int* out, int64_t F, int64_t L,
           cudaStream_t st) {
  if (F == 0) return 0;
  const unsigned blocks = (unsigned)((F + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  visible_count_kernel<T><<<blocks, 32 * WARPS_PER_BLOCK, 0, st>>>(
      bounds, lon, lat, best, out, F, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bounds (F,4), lon (L,), lat (L,) of one dtype (is_f64: 1 double, 0
// float), best (L,) bytes (0 = not counted), out (F,) int32 — all
// contiguous device memory.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
int vinsat_visible_count(const void* bounds, const void* lon, const void* lat,
                         const void* best, void* out, long long F, long long L,
                         int is_f64, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* b = (const unsigned char*)best;
  if (is_f64)
    return launch<double>((const double*)bounds, (const double*)lon,
                          (const double*)lat, b, (int*)out, F, L, st);
  return launch<float>((const float*)bounds, (const float*)lon,
                       (const float*)lat, b, (int*)out, F, L, st);
}

}  // extern "C"
