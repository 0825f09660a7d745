// E1: the event chains' sort and group tables on the card (sm_90a).
//
// Counterpart of the JAX package's host library native/event_preproc.cpp
// (sort_events_by_pixel :28-68, group_tables :71-84), which
// enerf_tpu/data/native_events.py binds.  The result is the stable order of
// M events by (frame, pixel, time), the pixel trunc(y_f32) * W +
// trunc(x_f32), ties in time in index order: numpy's
// lexsort((t, pixel, frame)) exactly.
//
// A counting sort over the composite key k = (frame - fmin) * P +
// (pixel - pmin), P = pmax - pmin + 1, all O(M + K):
//   1. e1_prepass: the key's range and whether any t[i] < t[i-1] (block
//      reductions, one atomic a block); the host reads these once;
//   2. e1_histogram: k into key[M] (int32), one atomicAdd a event into
//      count[K], whose old value is the event's rank within its key (in
//      no particular order) into rank[M];
//   3. e1_scan: exclusive scans over K (a block scan of 4096-entry tiles,
//      then the tile sums, recursively): the key's start, and the group
//      number of each non-empty key;
//   4. e1_scatter: each event into slot start[k] + rank (not stable);
//   5. e1_fixup: each key's indices sorted back into (t, index) order, or
//      index order when the times are sorted, its group number written
//      beside them and its count into counts[group]: one thread a key of at
//      most SMALL events (insertion sort), one block a longer key (bitonic
//      sort of 2048-entry tiles in shared memory, then block-wide merges in
//      global memory).
// e1_group_tables: counts (an int32 histogram), offsets (the scan) and the
// successors after each event in its group.
//
// Counters are int32, indices and offsets int64.  The host checks K <=
// 2^30 and M < 2^31 before it launches.

#include <cstdint>
#include <cuda_runtime.h>

typedef long long i64;

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_ITEMS = 16;
constexpr i64 TILE = (i64)THREADS * SCAN_ITEMS;  // scan tile: 4096 entries
constexpr int SMALL = 32;                        // keys a thread sorts alone
constexpr int SORT_TILE = 2048;                  // a block's bitonic tile
constexpr int MERGE_ITEMS = 8;                   // outputs a thread merges in a step
constexpr unsigned FULL = 0xffffffffu;

int grid_for(i64 n) {
  i64 b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 32) b = 132 * 32;
  return (int)(b < 1 ? 1 : b);
}

__device__ __forceinline__ i64 pixel_of(const float* xs, const float* ys, i64 i, int W) {
  // float -> int64 conversions truncate toward zero, as the C++ casts do
  return (i64)ys[i] * (i64)W + (i64)xs[i];
}

__global__ void prepass_init(i64* red) {
  red[0] = INT64_MAX;  // frame min
  red[1] = INT64_MIN;  // frame max
  red[2] = INT64_MAX;  // pixel min
  red[3] = INT64_MIN;  // pixel max
  red[4] = 0;          // 1 when some t[i] < t[i-1]
}

__global__ void prepass_kernel(const float* xs, const float* ys, const double* ts,
                               const int* fids, i64 n, int W, i64* red) {
  i64 fmin = INT64_MAX, fmax = INT64_MIN, pmin = INT64_MAX, pmax = INT64_MIN, uns = 0;
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    const i64 p = pixel_of(xs, ys, i, W);
    const i64 f = fids[i];
    fmin = min(fmin, f);
    fmax = max(fmax, f);
    pmin = min(pmin, p);
    pmax = max(pmax, p);
    if (i > 0 && ts[i] < ts[i - 1]) uns = 1;
  }
  for (int o = 16; o > 0; o >>= 1) {
    fmin = min(fmin, __shfl_xor_sync(FULL, fmin, o));
    fmax = max(fmax, __shfl_xor_sync(FULL, fmax, o));
    pmin = min(pmin, __shfl_xor_sync(FULL, pmin, o));
    pmax = max(pmax, __shfl_xor_sync(FULL, pmax, o));
    uns = max(uns, __shfl_xor_sync(FULL, uns, o));
  }
  __shared__ i64 s[5][THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s[0][warp] = fmin; s[1][warp] = fmax; s[2][warp] = pmin; s[3][warp] = pmax;
    s[4][warp] = uns;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      fmin = min(fmin, s[0][w]); fmax = max(fmax, s[1][w]);
      pmin = min(pmin, s[2][w]); pmax = max(pmax, s[3][w]);
      uns = max(uns, s[4][w]);
    }
    atomicMin(&red[0], fmin);
    atomicMax(&red[1], fmax);
    atomicMin(&red[2], pmin);
    atomicMax(&red[3], pmax);
    if (uns) atomicMax(&red[4], (i64)1);
  }
}

__global__ void histogram_kernel(const float* xs, const float* ys, const int* fids, i64 n,
                                 int W, i64 fmin, i64 pmin, i64 P, int* key, int* rank,
                                 int* count) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    const i64 k = ((i64)fids[i] - fmin) * P + (pixel_of(xs, ys, i, W) - pmin);
    key[i] = (int)k;
    rank[i] = atomicAdd(&count[k], 1);
  }
}

// exclusive block scan of one value a thread; *total gets the block's sum
__device__ i64 block_exclusive_scan(i64 v, i64* total) {
  __shared__ i64 warp_sums[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  i64 x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const i64 before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[THREADS / 32 - 1];
  __syncthreads();
  return before;
}

// one tile of TILE outputs: out[i] = sum of value(in[j]) for j < i, over
// n_out = n_in + 1 outputs (inputs past n_in are 0); FLAG counts in[j] > 0
template <typename T, bool FLAG>
__global__ void scan_tiles(const T* in, i64 n_in, i64 n_out, i64* out, i64* tile_sums) {
  const i64 base = blockIdx.x * TILE + (i64)threadIdx.x * SCAN_ITEMS;
  i64 v[SCAN_ITEMS];
  i64 s = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const i64 i = base + j;
    i64 x = i < n_in ? (i64)in[i] : 0;
    if (FLAG) x = x > 0;
    v[j] = x;
    s += x;
  }
  i64 total;
  i64 run = block_exclusive_scan(s, &total);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const i64 i = base + j;
    if (i < n_out) out[i] = run;
    run += v[j];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void add_tile_offsets(i64* out, i64 n, const i64* offsets) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x)
    out[i] += offsets[i / TILE];
}

i64 scan_workspace(i64 n_out) {
  const i64 tiles = (n_out + TILE - 1) / TILE;
  if (tiles <= 1) return 1;
  return tiles + (tiles + 1) + scan_workspace(tiles + 1);
}

// exclusive scan of n_in values into out[0 .. n_in] (out[n_in] = the sum)
template <typename T, bool FLAG>
void scan(const T* in, i64 n_in, i64* out, i64* ws, cudaStream_t stream) {
  const i64 n_out = n_in + 1;
  const i64 tiles = (n_out + TILE - 1) / TILE;
  scan_tiles<T, FLAG><<<(unsigned)tiles, THREADS, 0, stream>>>(in, n_in, n_out, out, ws);
  if (tiles <= 1) return;
  i64* sums_scan = ws + tiles;
  scan<i64, false>(ws, tiles, sums_scan, ws + tiles + (tiles + 1), stream);
  add_tile_offsets<<<grid_for(n_out), THREADS, 0, stream>>>(out, n_out, sums_scan);
}

__global__ void scatter_kernel(const int* key, const int* rank, i64 n, const i64* start,
                               i64* order) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x)
    order[start[key[i]] + rank[i]] = i;
}

// (time, index) order, or index order when the times are sorted
template <bool BY_TIME>
struct Item {
  double t;
  i64 i;
};

template <bool BY_TIME>
__device__ __forceinline__ bool before(const Item<BY_TIME>& a, const Item<BY_TIME>& b) {
  if (BY_TIME && a.t != b.t) return a.t < b.t;
  return a.i < b.i;
}

template <bool BY_TIME>
__device__ __forceinline__ Item<BY_TIME> item_of(i64 idx, const double* ts) {
  Item<BY_TIME> it;
  it.t = BY_TIME ? ts[idx] : 0.0;
  it.i = idx;
  return it;
}

template <bool BY_TIME>
__global__ void fixup_small(i64* order, const i64* start, const i64* gbase, i64 K,
                            const double* ts, i64* group_id, i64* counts, int* big,
                            int* n_big) {
  for (i64 k = blockIdx.x * (i64)blockDim.x + threadIdx.x; k < K;
       k += (i64)gridDim.x * blockDim.x) {
    const i64 a = start[k], n = start[k + 1] - a;
    if (n > SMALL) {
      big[atomicAdd(n_big, 1)] = (int)k;
      continue;
    }
    if (n > 0) counts[gbase[k]] = n;
    for (int j = 0; j < n; ++j) group_id[a + j] = gbase[k];
    i64* o = order + a;
    for (int i = 1; i < n; ++i) {
      const Item<BY_TIME> v = item_of<BY_TIME>(o[i], ts);
      int j = i - 1;
      while (j >= 0 && before<BY_TIME>(v, item_of<BY_TIME>(o[j], ts))) {
        o[j + 1] = o[j];
        --j;
      }
      o[j + 1] = v.i;
    }
  }
}

// bitonic sort of one tile (at most SORT_TILE entries) of o in shared memory
template <bool BY_TIME>
__device__ void sort_tile(i64* o, int n, const double* ts, Item<BY_TIME>* s) {
  for (int i = threadIdx.x; i < SORT_TILE; i += blockDim.x) {
    if (i < n) {
      s[i] = item_of<BY_TIME>(o[i], ts);
    } else {  // padding sorts last
      s[i].t = __longlong_as_double(0x7ff0000000000000LL);  // +inf
      s[i].i = INT64_MAX;
    }
  }
  __syncthreads();
  for (int k = 2; k <= SORT_TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < SORT_TILE; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const Item<BY_TIME> a = s[i], b = s[p];
          const bool up = (i & k) == 0;
          if (up ? before<BY_TIME>(b, a) : before<BY_TIME>(a, b)) {
            s[i] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = s[i].i;
  __syncthreads();
}

// block-wide stable merge of src[0, n1) and src[n1, n1 + n2) into dst
template <bool BY_TIME>
__device__ void merge_runs(const i64* A, i64 n1, const i64* B, i64 n2, i64* dst,
                           const double* ts) {
  const i64 L = n1 + n2;
  for (i64 d0 = 0; d0 < L; d0 += (i64)blockDim.x * MERGE_ITEMS) {
    const i64 d = d0 + (i64)threadIdx.x * MERGE_ITEMS;
    if (d >= L) continue;
    // merge path: how many of the first d outputs come from A
    i64 lo = d > n2 ? d - n2 : 0, hi = d < n1 ? d : n1;
    while (lo < hi) {
      const i64 mid = (lo + hi) >> 1;
      if (!before<BY_TIME>(item_of<BY_TIME>(B[d - 1 - mid], ts),
                           item_of<BY_TIME>(A[mid], ts)))
        lo = mid + 1;
      else
        hi = mid;
    }
    i64 i = lo, j = d - lo;
    const i64 end = d + MERGE_ITEMS < L ? d + MERGE_ITEMS : L;
    for (i64 q = d; q < end; ++q) {
      bool take_a;
      if (i >= n1) take_a = false;
      else if (j >= n2) take_a = true;
      else take_a = !before<BY_TIME>(item_of<BY_TIME>(B[j], ts), item_of<BY_TIME>(A[i], ts));
      dst[q] = take_a ? A[i++] : B[j++];
    }
  }
}

template <bool BY_TIME>
__global__ void fixup_large(i64* order, i64* tmp, const i64* start, const i64* gbase,
                            const double* ts, i64* group_id, i64* counts, const int* big,
                            const int* n_big) {
  __shared__ Item<BY_TIME> s[SORT_TILE];
  const int count = *n_big;
  for (int b = blockIdx.x; b < count; b += gridDim.x) {
    const int k = big[b];
    const i64 a = start[k], n = start[k + 1] - a;
    if (threadIdx.x == 0) counts[gbase[k]] = n;
    for (i64 i = threadIdx.x; i < n; i += blockDim.x) group_id[a + i] = gbase[k];
    i64* src = order + a;
    i64* dst = tmp + a;
    for (i64 t0 = 0; t0 < n; t0 += SORT_TILE)
      sort_tile<BY_TIME>(src + t0, (int)(n - t0 < SORT_TILE ? n - t0 : SORT_TILE), ts, s);
    for (i64 w = SORT_TILE; w < n; w <<= 1) {
      for (i64 r = 0; r < n; r += 2 * w) {
        const i64 n1 = n - r < w ? n - r : w;
        const i64 rest = n - r - n1;
        const i64 n2 = rest < w ? rest : w;
        merge_runs<BY_TIME>(src + r, n1, src + r + n1, n2, dst + r, ts);
      }
      __syncthreads();
      i64* t = src;
      src = dst;
      dst = t;
    }
    if (src != order + a) {
      for (i64 i = threadIdx.x; i < n; i += blockDim.x) order[a + i] = src[i];
      __syncthreads();
    }
  }
}

__global__ void group_hist(const i64* group_id, i64 n, int* count) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x)
    atomicAdd(&count[group_id[i]], 1);
}

__global__ void group_finish(const i64* group_id, i64 n, i64 G, const int* count,
                             const i64* offs, i64* counts, i64* num_succ) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n || i < G;
       i += (i64)gridDim.x * blockDim.x) {
    if (i < G) counts[i] = count[i];
    if (i < n) num_succ[i] = offs[group_id[i] + 1] - i - 1;
  }
}

template <bool BY_TIME>
void fixup(i64* order, i64* tmp, const i64* start, const i64* gbase, i64 K, const double* ts,
           i64* group_id, i64* counts, int* big, int* n_big, cudaStream_t s) {
  fixup_small<BY_TIME><<<grid_for(K), THREADS, 0, s>>>(order, start, gbase, K, ts, group_id,
                                                       counts, big, n_big);
  fixup_large<BY_TIME><<<132 * 2, THREADS, 0, s>>>(order, tmp, start, gbase, ts, group_id,
                                                   counts, big, n_big);
}

}  // namespace

extern "C" {

long long e1_scan_workspace(long long n_out) { return scan_workspace(n_out); }

// the fix-up's list of long keys: room for every key of more than SMALL of n events
long long e1_big_capacity(long long n) { return n / (SMALL + 1) + 1; }

int e1_prepass(const void* xs, const void* ys, const void* ts, const void* fids, long long n,
               int W, void* red, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  prepass_init<<<1, 1, 0, s>>>((i64*)red);
  prepass_kernel<<<grid_for(n), THREADS, 0, s>>>((const float*)xs, (const float*)ys,
                                                 (const double*)ts, (const int*)fids, n, W,
                                                 (i64*)red);
  return (int)cudaGetLastError();
}

// count: K zeroed int32 counters
int e1_histogram(const void* xs, const void* ys, const void* fids, long long n, int W,
                 long long fmin, long long pmin, long long P, void* key, void* rank,
                 void* count, void* stream) {
  histogram_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)xs, (const float*)ys, (const int*)fids, n, W, fmin, pmin, P, (int*)key,
      (int*)rank, (int*)count);
  return (int)cudaGetLastError();
}

// flag 0: the exclusive scan of count; 1: of count > 0
int e1_scan(const void* count, long long K, int flag, void* out, void* ws, void* stream) {
  if (flag)
    scan<int, true>((const int*)count, K, (i64*)out, (i64*)ws, (cudaStream_t)stream);
  else
    scan<int, false>((const int*)count, K, (i64*)out, (i64*)ws, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int e1_scatter(const void* key, const void* rank, long long n, const void* start,
               void* order, void* stream) {
  scatter_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)key, (const int*)rank, n, (const i64*)start, (i64*)order);
  return (int)cudaGetLastError();
}

// counts: [groups]; n_big: one zeroed int32; big: e1_big_capacity(n) int32
int e1_fixup(void* order, void* tmp, const void* start, const void* gbase, long long K,
             const void* ts, int by_time, void* group_id, void* counts, void* big,
             void* n_big, void* stream) {
  if (by_time)
    fixup<true>((i64*)order, (i64*)tmp, (const i64*)start, (const i64*)gbase, K,
                (const double*)ts, (i64*)group_id, (i64*)counts, (int*)big, (int*)n_big,
                (cudaStream_t)stream);
  else
    fixup<false>((i64*)order, (i64*)tmp, (const i64*)start, (const i64*)gbase, K,
                 (const double*)ts, (i64*)group_id, (i64*)counts, (int*)big, (int*)n_big,
                 (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// count: G zeroed int32 counters; offs: [G + 1]; counts: [G]; num_succ: [n]
int e1_group_tables(const void* group_id, long long n, long long G, void* count, void* offs,
                    void* counts, void* num_succ, void* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  group_hist<<<grid_for(n), THREADS, 0, s>>>((const i64*)group_id, n, (int*)count);
  scan<int, false>((const int*)count, G, (i64*)offs, (i64*)ws, s);
  group_finish<<<grid_for(n > G ? n : G), THREADS, 0, s>>>(
      (const i64*)group_id, n, G, (const int*)count, (const i64*)offs, (i64*)counts,
      (i64*)num_succ);
  return (int)cudaGetLastError();
}

}  // extern "C"
