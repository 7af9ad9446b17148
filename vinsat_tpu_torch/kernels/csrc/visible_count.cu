// Landmark-visibility count per footprint box, for Hopper (sm_90a).  Plain
// C interface, loaded with ctypes by vinsat_tpu_torch/kernels/visible_count.py.
//
// Replaces the TPU kernel vinsat_tpu/kernels/matching.py (visible_count,
// pallas_call at :72; body _visible_count_kernel :23).  For every frame f
// it counts the landmarks l with best[l] != 0 strictly inside the box
// bounds[f] = (lon_min, lat_min, lon_max, lat_max):
//     (lon_min < lon < lon_max  or  lon_min < lon + 360 < lon_max)
//     and lat_min < lat < lat_max
// (the lon + 360 test catches boxes that wrap the antimeridian, whose
// lon_max exceeds 180).  A NaN bound compares false, so its frame counts 0.
// The arithmetic is that of visible_count_reference (matching.py:88), in
// the input's dtype: f64 for the simulator, f32 for the TPU kernel's cast.
// Counts are integers, so the result equals the plain twin's bit for bit
// whatever the order of the sums.
//
// What bounds it on this card: the compares, on the CUDA cores (no tensor
// core compares).  The simulator's gate runs it at F = 10801 frames x
// L = 7920 landmarks: brute force is 85.5M pairs x 6 compares, ~30 us at
// the card's 17e12 f64 instructions/s.  But few pairs can hit: the
// landmarks come region by region, a tile of them covers a few degrees,
// and a footprint ~8 x 4 degrees, so ~1-2% of (frame, tile) pairs overlap.
//
// What the design does about it, in two launches:
//   1. tile_box_kernel: per tile of TILE landmarks, the box (min, max) of
//      lon, of lon + 360 and of lat over its accepted landmarks (NaN
//      values left out; a tile with none gets the empty box +inf / -inf);
//      it also zeroes the counts.
//   2. count_kernel: a frame per lane (its four bounds and its count in
//      registers, the count added once with atomicAdd), FRAMES frames a
//      block, the tiles split over gridDim.y into ~32 blocks for each SM
//      (a block's work is a chain of latencies: bounds, boxes, barrier,
//      tile, compares; short chains in many blocks measured fastest).  A
//      block first tests its frames against its tiles' boxes with the
//      count's own strict compares, as bit masks: a tile no lane can meet
//      is never loaded.  Each tile a block needs is staged once into
//      shared memory (coalesced, one landmark a thread, fetched into
//      registers a tile ahead, two buffers, one barrier a tile) with what
//      was per pair folded in: lon + 360 computed once, and lat = NaN for
//      a landmark not accepted, which then fails every compare.  Each
//      shared read is a broadcast to the 32 lanes.  A warp runs a tile
//      only where one of its lanes meets the tile's lon box (4 compares a
//      pair), its lon + 360 box (4) or both (6).
// The cull can only drop pairs that count 0: if lon_min < x < lon_max for
// some x of the tile, then lon_min < max and min < lon_max; a NaN or inf
// bound, and an empty box, fail the test.  The TPU layout (F padded to 8,
// L to 128 with 1e9 landmarks) does not carry over: NaN pads the tail.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;           // landmarks per tile; one per thread
constexpr int WARPS = 4;
constexpr int FRAMES = 32 * WARPS;  // frames per block, one per lane
constexpr int CHUNK = 64;           // tiles per mask word
constexpr int PAIR_UNROLL = 8;      // landmarks per pass of a pair loop
constexpr int TARGET_BLOCKS = 4224;  // ~32 per SM of the H100's 132

template <typename T> struct Num;
template <> struct Num<double> {
  using Pair = double2;
  static __device__ double nan() { return CUDART_NAN; }
  static __device__ double inf() { return CUDART_INF; }
};
template <> struct Num<float> {
  using Pair = float2;
  static __device__ float nan() { return CUDART_NAN_F; }
  static __device__ float inf() { return CUDART_INF_F; }
};

// Box of tile blockIdx.x: (lon_min, lon_max, lonw_min, lonw_max, lat_min,
// lat_max) over its accepted landmarks, lonw = lon + 360 in T.  Zeroes
// out[0, F) on the way (out may be null when F is 0).
template <typename T>
__global__ void __launch_bounds__(TILE)
    tile_box_kernel(const T* __restrict__ lon, const T* __restrict__ lat,
                    const unsigned char* __restrict__ best,
                    T* __restrict__ boxes, int* __restrict__ out, int64_t F,
                    int64_t L) {
  for (int64_t i = (int64_t)blockIdx.x * TILE + threadIdx.x; i < F;
       i += (int64_t)gridDim.x * TILE)
    out[i] = 0;
  const T inf = Num<T>::inf();
  T mn[3] = {inf, inf, inf}, mx[3] = {-inf, -inf, -inf};
  const int64_t l = (int64_t)blockIdx.x * TILE + threadIdx.x;
  if (l < L && best[l]) {
    const T lo = lon[l];
    const T v[3] = {lo, lo + T(360), lat[l]};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (v[k] == v[k]) mn[k] = mx[k] = v[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T a = __shfl_xor_sync(0xffffffffu, mn[k], off);
      const T b = __shfl_xor_sync(0xffffffffu, mx[k], off);
      mn[k] = a < mn[k] ? a : mn[k];
      mx[k] = b > mx[k] ? b : mx[k];
    }
  __shared__ T part[TILE / 32][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      part[warp][2 * k] = mn[k];
      part[warp][2 * k + 1] = mx[k];
    }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    T v = part[0][k];
    for (int w = 1; w < TILE / 32; ++w) {
      const T u = part[w][k];
      v = (k & 1) ? (u > v ? u : v) : (u < v ? u : v);
    }
    boxes[blockIdx.x * 6 + k] = v;
  }
}

// Pairs of the lanes' frames with the TILE landmarks s[] = (lon or
// lon + 360, lat) that lie inside: 4 compares a pair.
template <typename T>
__device__ __forceinline__ int pairs_one(const typename Num<T>::Pair* s,
                                         T a0, T a1, T b0, T b1) {
  int n = 0;
#pragma unroll (PAIR_UNROLL)
  for (int j = 0; j < TILE; ++j) {
    const typename Num<T>::Pair v = s[j];
    n += (int)((v.x > a0) & (v.x < a1) & (v.y > b0) & (v.y < b1));
  }
  return n;
}

// The same testing lon and lon + 360: 6 compares a pair.
template <typename T>
__device__ __forceinline__ int pairs_both(const typename Num<T>::Pair* ll,
                                          const typename Num<T>::Pair* wl,
                                          T a0, T a1, T b0, T b1) {
  int n = 0;
#pragma unroll (PAIR_UNROLL)
  for (int j = 0; j < TILE; ++j) {
    const typename Num<T>::Pair v = ll[j];
    const T w = wl[j].x;
    n += (int)((((v.x > a0) & (v.x < a1)) | ((w > a0) & (w < a1))) &
               (v.y > b0) & (v.y < b1));
  }
  return n;
}

__device__ __forceinline__ uint64_t warp_or(uint64_t m) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
  return ((uint64_t)hi << 32) | lo;
}

template <typename T>
__global__ void __launch_bounds__(FRAMES)
    count_kernel(const T* __restrict__ bounds, const T* __restrict__ lon,
                 const T* __restrict__ lat,
                 const unsigned char* __restrict__ best,
                 const T* __restrict__ boxes, int* __restrict__ out,
                 int64_t F, int64_t L, int n_tiles, int tiles_per_split) {
  using Pair = typename Num<T>::Pair;
  __shared__ Pair s_ll[2][TILE];  // (lon, lat or NaN)
  __shared__ Pair s_wl[2][TILE];  // (lon + 360, lat or NaN)
  __shared__ uint64_t s_need[2][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t f = (int64_t)blockIdx.x * FRAMES + tid;
  const T qnan = Num<T>::nan();
  T a0 = qnan, b0 = qnan, a1 = qnan, b1 = qnan;  // lon_min, lat_min, max, max
  if (f < F) {
    a0 = bounds[4 * f];
    b0 = bounds[4 * f + 1];
    a1 = bounds[4 * f + 2];
    b1 = bounds[4 * f + 3];
  }
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  int n = 0;
  int parity = 0;
  for (int c0 = t_begin; c0 < t_end; c0 += CHUNK, parity ^= 1) {
    const int nc = min(CHUNK, t_end - c0);
    uint64_t m_lon = 0, m_w = 0;
    for (int k = 0; k < nc; ++k) {
      const T* bx = boxes + (int64_t)(c0 + k) * 6;
      const bool lat_ok = (b0 < bx[5]) & (bx[4] < b1);
      m_lon |= (uint64_t)(lat_ok & (a0 < bx[1]) & (bx[0] < a1)) << k;
      m_w |= (uint64_t)(lat_ok & (a0 < bx[3]) & (bx[2] < a1)) << k;
    }
    const uint64_t w_lon = warp_or(m_lon), w_w = warp_or(m_w);
    if (lane == 0) s_need[parity][warp] = w_lon | w_w;
    __syncthreads();
    uint64_t need = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) need |= s_need[parity][w];
    if (need == 0) continue;  // block-uniform

    // stage the first needed tile, then each next one a tile ahead
    int t = c0 + __ffsll((long long)need) - 1;
    need &= need - 1;
    T lo = qnan, la = qnan;
    unsigned char keep = 0;
    auto fetch = [&](int tile) {
      const int64_t l = (int64_t)tile * TILE + tid;
      lo = la = qnan;
      keep = 0;
      if (l < L) {
        lo = lon[l];
        la = lat[l];
        keep = best[l];
      }
    };
    auto store = [&](int buf) {
      const T lat_f = keep ? la : qnan;
      s_ll[buf][tid] = Pair{lo, lat_f};
      s_wl[buf][tid] = Pair{lo + T(360), lat_f};
    };
    int buf = 0;
    fetch(t);
    store(buf);
    __syncthreads();
    while (true) {
      const bool more = need != 0;
      int next = 0;
      if (more) {
        next = c0 + __ffsll((long long)need) - 1;
        need &= need - 1;
        fetch(next);
      }
      const int bit = t - c0;
      const bool do_lon = (w_lon >> bit) & 1, do_w = (w_w >> bit) & 1;
      if (do_lon && do_w)
        n += pairs_both<T>(s_ll[buf], s_wl[buf], a0, a1, b0, b1);
      else if (do_lon)
        n += pairs_one<T>(s_ll[buf], a0, a1, b0, b1);
      else if (do_w)
        n += pairs_one<T>(s_wl[buf], a0, a1, b0, b1);
      if (!more) break;
      buf ^= 1;
      store(buf);
      __syncthreads();
      t = next;
    }
  }
  if (n != 0 && f < F) atomicAdd(out + f, n);
}

int n_tiles_of(int64_t L) { return (int)((L + TILE - 1) / TILE); }

template <typename T>
int launch(const T* bounds, const T* lon, const T* lat,
           const unsigned char* best, T* boxes, int* out, int64_t F,
           int64_t L, cudaStream_t st) {
  if (F == 0) return 0;
  const int n_tiles = n_tiles_of(L);
  if (n_tiles == 0) {
    cudaMemsetAsync(out, 0, F * sizeof(int), st);
    return (int)cudaGetLastError();
  }
  tile_box_kernel<T><<<n_tiles, TILE, 0, st>>>(lon, lat, best, boxes, out,
                                               F, L);
  const int64_t bx = (F + FRAMES - 1) / FRAMES;
  if (bx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int splits = (int)((TARGET_BLOCKS + bx - 1) / bx);
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const int per = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + per - 1) / per;
  count_kernel<T><<<dim3((unsigned)bx, (unsigned)splits), FRAMES, 0, st>>>(
      bounds, lon, lat, best, boxes, out, F, L, n_tiles, per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bounds (F,4), lon (L,), lat (L,) of one dtype (is_f64: 1 double, 0
// float), best (L,) bytes (0 = not counted), out (F,) int32, boxes a
// scratch of n_boxes x 6 of the dtype, n_boxes = ceil(L / 128) -- all
// contiguous device memory.  Launches on `stream` (two kernels: the tile
// boxes, then the count); returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for a scratch of another size.
int vinsat_visible_count(const void* bounds, const void* lon, const void* lat,
                         const void* best, void* boxes, void* out, long long F,
                         long long L, long long n_boxes, int is_f64,
                         void* stream) {
  if (n_boxes != n_tiles_of(L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* b = (const unsigned char*)best;
  if (is_f64)
    return launch<double>((const double*)bounds, (const double*)lon,
                          (const double*)lat, b, (double*)boxes, (int*)out, F,
                          L, st);
  return launch<float>((const float*)bounds, (const float*)lon,
                       (const float*)lat, b, (float*)boxes, (int*)out, F, L,
                       st);
}

// The tile boxes alone (the first launch above, without the zeroing):
// boxes (ceil(L / 128), 6) of lon (L,), lat (L,), best (L,).
int vinsat_visible_count_tile_boxes(const void* lon, const void* lat,
                                    const void* best, void* boxes,
                                    long long L, long long n_boxes,
                                    int is_f64, void* stream) {
  if (n_boxes != n_tiles_of(L)) return (int)cudaErrorInvalidValue;
  if (n_boxes == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* b = (const unsigned char*)best;
  if (is_f64)
    tile_box_kernel<double><<<(unsigned)n_boxes, TILE, 0, st>>>(
        (const double*)lon, (const double*)lat, b, (double*)boxes, nullptr,
        0, L);
  else
    tile_box_kernel<float><<<(unsigned)n_boxes, TILE, 0, st>>>(
        (const float*)lon, (const float*)lat, b, (float*)boxes, nullptr, 0,
        L);
  return (int)cudaGetLastError();
}

}  // extern "C"
