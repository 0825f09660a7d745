// E1: the event chains' sort and group tables on the card (sm_90a).
//
// Counterpart of the JAX package's host library native/event_preproc.cpp
// (sort_events_by_pixel :28-68, group_tables :71-84), which
// enerf_tpu/data/native_events.py binds (:63, :81).  The result is the
// stable order of M events by (frame, pixel, time), the pixel
// trunc(y_f32) * W + trunc(x_f32), ties in time in index order: numpy's
// lexsort((t, pixel, frame)) exactly.
//
// Bound: bytes.  The least work reads x, y (f32), t (f64) and the frame
// (i32) once and writes the int64 order and group ids once, 36 B an event.
// The design keeps every pass a stream over the events, so its cost grows
// with M alone and never with the key space K = frames x pixel range
// (~1.75e7 at 1280 x 720 in 19 windows, more than 1e7 events):
//   1. e1_prepass: the key's range and whether any t[i] < t[i-1] (block
//      reductions, one atomic a block); the host reads these once and
//      plans the digits (native_events.digit_plan: b = ceil(log2 K) <= 30
//      bits in the fewest passes of at most 11 bits each);
//   2. e1_histogram: the composite key k = (frame - fmin) * P + (pixel -
//      pmin) of each event, every digit's histogram at once in shared
//      memory (no global atomic an event: one a bin a block), then each
//      digit's exclusive scan: its buckets' starts;
//   3. e1_pass, once a digit, least significant first: a stable LSD radix
//      pass over 4096-key tiles.  Each tile ranks its keys by the digit in
//      index order (__match_any_sync within a warp, per-warp counters
//      scanned across warps), stages its keys and indices in shared memory
//      in digit order, finds each bucket's offset by a decoupled look-back
//      over the tiles before it, and stores its keys and indices as runs:
//      consecutive threads to consecutive addresses of a bucket, no
//      per-event random store.  The look-back's status words pack a flag
//      and a count into 64 bits (a bucket may hold up to M < 2^31 events);
//      tile numbers come from an atomic counter, so no tile waits on one
//      that was not scheduled; a thread reads a window of tiles for its
//      bins at once.  The words are read and written with relaxed gpu-scope
//      accesses, not acquire / release: each word carries its own data and
//      publishes nothing else, and acquire loads wait for each other (they
//      made E1 slower at 1e8 events on an H100, PERF.md §6).
//      The first pass computes the key itself and takes the index from the
//      position; the last writes the index as int64 into the order;
//   4. e1_groups: one streaming pass over the sorted keys: a flag where the
//      key changes (a ballot a warp), a (count, last start) scan over
//      4096-key tiles with a look-back of 32 tiles a step (a warp); the group
//      id of each event, and each group's count where the group ends.  The
//      host reads the last group id once;
//   5. e1_fixup, only when the pre-pass found the times unsorted: each
//      group's indices (in index order after the LSD passes) sorted into
//      (t, index) order, one thread a group of at most SMALL events
//      (insertion sort), one block a longer one (bitonic sort of 2048-entry
//      tiles in shared memory, then block-wide merges in global memory).
//      JAX's library takes std::stable_sort by (key, t) there.  When the
//      times are sorted, (key, index) order is already lexsort's order.
// Nothing is of size K: the workspace (e1_sort_workspace: one zeroed int64
// buffer, laid out here) is O(M + tiles x 2^bits).
//
// e1_group_tables (group_tables over the sorted, hence non-decreasing, group
// ids): each group's offset where a run of its id starts, then the counts
// and each event's successors from the offsets; no atomics.  Ids that
// decrease somewhere or leave [0, G) are refused (a flag the host reads),
// where JAX's library, which counts with a histogram, would return tables.
//
// Counters and positions are int32 (the host checks M < 2^31 and K <=
// 2^30), the order, group ids and offsets int64.

#include <cstdint>
#include <cuda_runtime.h>

typedef long long i64;
typedef unsigned long long u64;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                    // keys a thread holds in a tile
constexpr int TILE = THREADS * ITEMS;        // 4096 keys a tile
constexpr int SMALL = 32;                    // a group a thread sorts alone
constexpr int BITONIC_TILE = 2048;           // a block's bitonic tile
constexpr int MERGE_ITEMS = 8;               // outputs a thread merges in a step
constexpr int LOOKBACK_LOADS = 8;            // status loads a thread of a pass has in flight
constexpr int HIST_UNROLL = 4;               // events a thread of the histogram loads at once
constexpr int HIST_BLOCKS = 132 * 8;         // the histogram's blocks: 8 an SM
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 AGGREGATE = 1ull << 62;        // status: the tile's own count
constexpr u64 INCLUSIVE = 2ull << 62;        // status: the count over tiles <= this one
constexpr u64 FLAGS = 3ull << 62;

int grid_for(i64 n) {
  i64 b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 32) b = 132 * 32;
  return (int)(b < 1 ? 1 : b);
}

__device__ __forceinline__ i64 pixel_of(const float* xs, const float* ys, i64 i, int W) {
  // float -> int64 conversions truncate toward zero, as the C++ casts do
  return (i64)ys[i] * (i64)W + (i64)xs[i];
}

__device__ __forceinline__ int key_of(const float* xs, const float* ys, const int* fids, i64 i,
                                      int W, i64 fmin, i64 pmin, i64 P) {
  return (int)(((i64)fids[i] - fmin) * P + (pixel_of(xs, ys, i, W) - pmin));
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// ----------------------------------------------------------------- workspace

// E1's sort workspace for n events and d digits of bits[p] bits, one zeroed
// int64 buffer: each digit's bucket counts (u64) and starts (i64), 2^bits
// each; a tile counter for each pass and for the group pass (an int32 in a
// word each); each digit's look-back status words [tiles][2^bits] and the
// group pass's [tiles] (u64)
struct Workspace {
  u64* hist[3];
  i64* start[3];
  int* counter[4];
  u64* status[3];
  u64* group_status;
};

bool plan_ok(int d, const int* bits) {
  if (d < 1 || d > 3) return false;
  for (int p = 0; p < d; ++p)
    if (bits[p] < 1 || bits[p] > 11) return false;
  return true;
}

// the workspace's size in words; its regions in *ws, from base
i64 layout(void* base, i64 n, int d, const int* bits, Workspace* ws) {
  const i64 tiles = (n + TILE - 1) / TILE;
  i64 off = 0;
  auto take = [&](i64 words) {
    i64* r = base ? (i64*)base + off : nullptr;
    off += words;
    return r;
  };
  Workspace l{};
  for (int p = 0; p < d; ++p) {
    l.hist[p] = (u64*)take((i64)1 << bits[p]);
    l.start[p] = take((i64)1 << bits[p]);
  }
  for (int p = 0; p <= d; ++p) l.counter[p] = (int*)take(1);
  for (int p = 0; p < d; ++p) l.status[p] = (u64*)take(tiles << bits[p]);
  l.group_status = (u64*)take(tiles);
  if (ws) *ws = l;
  return off;
}

// ------------------------------------------------------------------ pre-pass

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
  __shared__ i64 s[5][WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s[0][warp] = fmin; s[1][warp] = fmax; s[2][warp] = pmin; s[3][warp] = pmax;
    s[4][warp] = uns;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
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

// ----------------------------------------------------------------- histogram

struct Digits {
  int d;            // passes, at most 3
  int shift[3];
  int bits[3];
  u64* hist[3];     // [1 << bits[p]] zeroed counters
  i64* start[3];    // [1 << bits[p]] each bucket's start
};

__global__ void histogram_kernel(const float* xs, const float* ys, const int* fids, i64 n,
                                 int W, i64 fmin, i64 pmin, i64 P, Digits dg) {
  extern __shared__ int sh[];  // every digit's bins, one after the other
  int off[3], mask[3], total = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    off[p] = total;
    mask[p] = (1 << dg.bits[p]) - 1;
    if (p < dg.d) total += 1 << dg.bits[p];
  }
  for (int b = threadIdx.x; b < total; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i0 = blockIdx.x * (i64)blockDim.x + threadIdx.x; i0 < n; i0 += HIST_UNROLL * stride) {
    int k[HIST_UNROLL];  // the loads of HIST_UNROLL events in flight together
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      const i64 i = i0 + u * stride;
      k[u] = i < n ? key_of(xs, ys, fids, i, W, fmin, pmin, P) : -1;
    }
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
        if (k[u] >= 0 && p < dg.d) atomicAdd(&sh[off[p] + ((k[u] >> dg.shift[p]) & mask[p])], 1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (p >= dg.d) break;
    for (int b = threadIdx.x; b <= mask[p]; b += blockDim.x)
      if (sh[off[p] + b]) atomicAdd(&dg.hist[p][b], (u64)sh[off[p] + b]);
  }
}

// exclusive block scan of one value a thread; *total gets the block's sum
__device__ i64 block_exclusive_scan(i64 v, i64* total) {
  __shared__ i64 warp_sums[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  i64 x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < WARPS ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const i64 before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[WARPS - 1];
  __syncthreads();
  return before;
}

// one block a digit: start[b] = sum of hist[c] for c < b (at most 2048 bins)
__global__ void digit_starts(Digits dg) {
  const int p = blockIdx.x;
  const int bins = 1 << dg.bits[p];
  const int per = (bins + THREADS - 1) / THREADS;
  const int b0 = threadIdx.x * per;
  i64 s = 0;
  for (int b = b0; b < b0 + per && b < bins; ++b) s += (i64)dg.hist[p][b];
  i64 total;
  i64 run = block_exclusive_scan(s, &total);
  for (int b = b0; b < b0 + per && b < bins; ++b) {
    dg.start[p][b] = run;
    run += (i64)dg.hist[p][b];
  }
}

// -------------------------------------------------------------- radix passes

// Shared memory of a pass over 2^bits bins: per-warp counters [WARPS][bins
// + 1] (the last bin holds a partial tile's positions past n), later the
// staging area [2][TILE]; then the tile's counts, starts and each bin's
// global offset less its start.
__host__ __device__ constexpr int pass_area(int bins) {
  return WARPS * (bins + 1) > 2 * TILE ? WARPS * (bins + 1) : 2 * TILE;
}

size_t pass_smem(int bins) { return sizeof(int) * (size_t)(pass_area(bins) + 3 * (bins + 1)); }

// one LSD pass's operands.  first: the keys from xs, ys, fids and the
// indices from the positions (key_in, val_in unused); last: the indices
// into order as int64 (val_out unused)
struct Pass {
  const float* xs;
  const float* ys;
  const int* fids;
  int W;
  i64 fmin, pmin, P;
  const int* key_in;
  const int* val_in;
  i64 n;
  int shift, bits;
  const i64* start;  // [2^bits] the digit's bucket starts
  u64* status;       // [tiles << bits] zeroed
  int* tile_counter; // zeroed
  int* key_out;
  int* val_out;
  i64* order;
};

// BPT: bins a thread walks in the look-back, 2^bits / THREADS or 1
template <bool FIRST, bool LAST, int BPT>
__global__ void __launch_bounds__(THREADS, 3) radix_pass(Pass a) {
  const i64 n = a.n;
  const int shift = a.shift, bits = a.bits;
  extern __shared__ int smem[];
  const int bins = 1 << bits, cols = bins + 1, mask = bins - 1;
  int* wcount = smem;                                 // [WARPS][cols]
  int* tcount = smem + pass_area(bins);               // [cols]
  int* tstart = tcount + cols;                        // [cols]
  int* gofs = tstart + cols;                          // [cols]
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(a.tile_counter, 1);
  for (int i = threadIdx.x; i < WARPS * cols; i += THREADS) wcount[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp-striped: item j of lane l is event first + j * 32
  const i64 first = (i64)tile * TILE + (i64)warp * 32 * ITEMS + lane;
  // a past-the-end item takes the bin after every real one, and is never stored
  auto digit = [&](int j, int k) { return first + j * 32 < n ? (k >> shift) & mask : bins; };

  int key[ITEMS], val[FIRST ? 1 : ITEMS], rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const i64 i = first + j * 32;
    if (FIRST) {
      key[j] = i < n ? key_of(a.xs, a.ys, a.fids, i, a.W, a.fmin, a.pmin, a.P) : 0;
    } else {
      key[j] = i < n ? a.key_in[i] : 0;
      val[j] = i < n ? a.val_in[i] : 0;
    }
  }

  // stable rank within the warp: items in index order, lanes in order
  int* wc = wcount + warp * cols;
  const unsigned lower_lanes = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int d = digit(j, key[j]);
    const unsigned peers = __match_any_sync(FULL, d);
    const int below = __popc(peers & lower_lanes);
    const int c = wc[d];
    __syncwarp();
    if (below == 0) wc[d] = c + __popc(peers);
    __syncwarp();
    rank[j] = c + below;
  }
  __syncthreads();

  // each bin: the warps' exclusive offsets and the tile's count
  for (int b = threadIdx.x; b < cols; b += THREADS) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcount[w * cols + b];
      wcount[w * cols + b] = run;
      run += c;
    }
    tcount[b] = run;
  }
  __syncthreads();

  // decoupled look-back, part 1: publish the tile's counts
  u64* mine = a.status + (i64)tile * bins;
  for (int b = threadIdx.x; b < bins; b += THREADS)
    store_status(&mine[b], (tile == 0 ? INCLUSIVE : AGGREGATE) | (u64)tcount[b]);

  // the tile's bucket starts: an exclusive scan over the bins
  {
    const int per = (cols + THREADS - 1) / THREADS;
    const int b0 = threadIdx.x * per;
    i64 s = 0;
    for (int b = b0; b < b0 + per && b < cols; ++b) s += tcount[b];
    i64 total;
    i64 run = block_exclusive_scan(s, &total);
    for (int b = b0; b < b0 + per && b < cols; ++b) {
      tstart[b] = (int)run;
      run += tcount[b];
    }
  }
  __syncthreads();

  // each item's place in the tile, in digit order
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int d = digit(j, key[j]);
    rank[j] += tstart[d] + wcount[warp * cols + d];
  }
  __syncthreads();  // the counters become the staging area
  int* skey = smem;
  int* sval = smem + TILE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (first + j * 32 < n) {
      skey[rank[j]] = key[j];
      sval[rank[j]] = FIRST ? (int)(first + j * 32) : val[FIRST ? 0 : j];
    }
  }


  // part 2: add the counts of the tiles before this one, bin by bin, until
  // one has its inclusive sum.  A thread reads a window of WIN tiles for
  // each of its bins at once, so that BPT * WIN loads are in flight together.
  constexpr int WIN = LOOKBACK_LOADS / BPT > 1 ? LOOKBACK_LOADS / BPT : 1;
  i64 excl[BPT];
  unsigned open = 0;  // bins still walking
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    excl[q] = 0;
    if (tile > 0 && threadIdx.x + q * THREADS < bins) open |= 1u << q;
  }
  for (int p = tile - 1; open; p -= WIN) {
    u64 st[BPT][WIN];
#pragma unroll
    for (int q = 0; q < BPT; ++q)
#pragma unroll
      for (int w = 0; w < WIN; ++w)
        st[q][w] = (open >> q & 1) && p - w >= 0
                       ? load_status(a.status + (i64)(p - w) * bins + threadIdx.x + q * THREADS)
                       : INCLUSIVE;
#pragma unroll
    for (int q = 0; q < BPT; ++q) {
#pragma unroll
      for (int w = 0; w < WIN; ++w) {
        if (!(open >> q & 1)) break;
        u64 v = st[q][w];
        for (unsigned wait = 8; (v & FLAGS) == 0; wait = wait < 256 ? 2 * wait : wait) {
          __nanosleep(wait);
          v = load_status(a.status + (i64)(p - w) * bins + threadIdx.x + q * THREADS);
        }
        excl[q] += (i64)(v & ~FLAGS);
        if ((v & FLAGS) == INCLUSIVE) open &= ~(1u << q);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    const int b = threadIdx.x + q * THREADS;
    if (b < bins) {
      if (tile > 0) store_status(&mine[b], INCLUSIVE | (u64)(excl[q] + tcount[b]));
      gofs[b] = (int)(a.start[b] + excl[q]) - tstart[b];
    }
  }
  __syncthreads();

  // runs out: consecutive threads store to consecutive places of a bucket
  const i64 base = (i64)tile * TILE;
  const int valid = n - base < TILE ? (int)(n - base) : TILE;
  for (int i = threadIdx.x; i < valid; i += THREADS) {
    const int k = skey[i];
    const int dst = gofs[(k >> shift) & mask] + i;
    a.key_out[dst] = k;
    if (LAST)
      a.order[dst] = (i64)sval[i];
    else
      a.val_out[dst] = sval[i];
  }
}

template <bool FIRST, bool LAST, int BPT>
int launch_pass(const Pass& a, cudaStream_t s) {
  const size_t smem = pass_smem(1 << a.bits);
  cudaError_t err = cudaFuncSetAttribute(radix_pass<FIRST, LAST, BPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  radix_pass<FIRST, LAST, BPT><<<(unsigned)((a.n + TILE - 1) / TILE), THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool FIRST, bool LAST>
int launch_pass(const Pass& a, cudaStream_t s) {
  switch (a.bits) {
    case 11: return launch_pass<FIRST, LAST, 8>(a, s);
    case 10: return launch_pass<FIRST, LAST, 4>(a, s);
    case 9: return launch_pass<FIRST, LAST, 2>(a, s);
    default: return launch_pass<FIRST, LAST, 1>(a, s);
  }
}

// ---------------------------------------------------------------- group ids

// a scan element: flags counted, and the last group start + 1 (0: none)
struct Run {
  int n;
  int last;
};

__device__ __forceinline__ Run combine(Run a, Run b) {
  return Run{a.n + b.n, a.last > b.last ? a.last : b.last};
}

__device__ __forceinline__ u64 pack_run(u64 flag, Run r) {
  return flag | ((u64)(unsigned)r.n << 31) | (u64)(unsigned)r.last;
}

__device__ __forceinline__ Run unpack_run(u64 s) {
  return Run{(int)((s >> 31) & 0x7fffffffu), (int)(s & 0x7fffffffu)};
}

__device__ __forceinline__ Run shfl_up_run(Run r, int o) {
  return Run{__shfl_up_sync(FULL, r.n, o), __shfl_up_sync(FULL, r.last, o)};
}

__device__ __forceinline__ Run shfl_run(Run r, int lane) {
  return Run{__shfl_sync(FULL, r.n, lane), __shfl_sync(FULL, r.last, lane)};
}

__device__ __forceinline__ Run shfl_xor_run(Run r, int o) {
  return Run{__shfl_xor_sync(FULL, r.n, o), __shfl_xor_sync(FULL, r.last, o)};
}

// Run of the starts flagged in a ballot over 32 events from `first` on
__device__ __forceinline__ Run run_of(unsigned ballot, i64 first) {
  return ballot ? Run{__popc(ballot), (int)(first + 31 - __clz(ballot)) + 1} : Run{0, 0};
}

// warp-striped: item j of lane l is event base + warp * 32 * ITEMS + j * 32 + l
__global__ void __launch_bounds__(THREADS) group_kernel(const int* keys, i64 n, u64* status,
                                                        int* tile_counter, i64* group_id,
                                                        i64* counts) {
  __shared__ int s_tile;
  __shared__ Run s_warp[WARPS];  // each warp's run, then what comes before the warp
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const i64 w0 = (i64)tile * TILE + (i64)warp * 32 * ITEMS;
  int k[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) k[j] = w0 + j * 32 + lane < n ? keys[w0 + j * 32 + lane] : 0;
  // the key before each event from the lane below, or the item before; the
  // warp's first and the key after its last from memory
  int before = lane == 0 && w0 > 0 && w0 <= n ? keys[w0 - 1] : 0;
  const i64 after_last = w0 + 32 * ITEMS;  // the event after the warp's last
  const bool last_ends = lane == 31 && (after_last >= n || keys[after_last] != k[ITEMS - 1]);
  unsigned starts[ITEMS], ends[ITEMS];  // ballots: a group starts / ends at the event
  Run agg{0, 0};
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const i64 i = w0 + j * 32 + lane;
    const int up = __shfl_up_sync(FULL, k[j], 1);
    const int prev = lane > 0 ? up : before;
    before = __shfl_sync(FULL, k[j], 31);  // lane 0's key before, at item j + 1
    starts[j] = __ballot_sync(FULL, i < n && (i == 0 || prev != k[j]));
    agg = combine(agg, run_of(starts[j], w0 + j * 32));
  }
  // an event ends its group where the next one starts one, or at n - 1
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const i64 i = w0 + j * 32 + lane;
    const bool next_starts = lane < 31 ? starts[j] >> (lane + 1) & 1
                                       : j + 1 < ITEMS ? starts[j + 1] & 1 : last_ends;
    ends[j] = __ballot_sync(FULL, i < n && (i == n - 1 || next_starts));
  }
  if (lane == 0) s_warp[warp] = agg;
  __syncthreads();

  if (warp == 0) {  // the warps' prefixes, then the tile's decoupled look-back
    Run w = lane < WARPS ? s_warp[lane] : Run{0, 0};
    for (int o = 1; o < 32; o <<= 1) {
      const Run y = shfl_up_run(w, o);
      if (lane >= o) w = combine(y, w);
    }
    const Run total = shfl_run(w, WARPS - 1);
    Run before_warp = shfl_up_run(w, 1);
    if (lane == 0) before_warp = Run{0, 0};
    Run prefix{0, 0};
    if (tile == 0) {
      if (lane == 0) store_status(&status[0], pack_run(INCLUSIVE, total));
    } else {
      if (lane == 0) store_status(&status[tile], pack_run(AGGREGATE, total));
      // a window of 32 tiles a step, lane l on tile p - l, until an inclusive one
      unsigned wait = 8;
      for (int p = tile - 1;;) {
        const int q = p - lane;
        const u64 st = q >= 0 ? load_status(&status[q]) : INCLUSIVE;
        const unsigned incl = __ballot_sync(FULL, (st & FLAGS) == INCLUSIVE);
        const unsigned need = incl ? FULL >> (31 - (__ffs(incl) - 1)) : FULL;
        if ((__ballot_sync(FULL, (st & FLAGS) != 0) & need) != need) {
          __nanosleep(wait);
          if (wait < 256) wait <<= 1;
          continue;
        }
        Run r = need >> lane & 1 ? unpack_run(st) : Run{0, 0};
        for (int o = 16; o > 0; o >>= 1) r = combine(r, shfl_xor_run(r, o));
        prefix = combine(r, prefix);
        if (incl) break;
        p -= 32;
      }
      if (lane == 0) store_status(&status[tile], pack_run(INCLUSIVE, combine(prefix, total)));
    }
    if (lane < WARPS) s_warp[lane] = combine(prefix, before_warp);
  }
  __syncthreads();

  Run run = s_warp[warp];
  const unsigned upto = FULL >> (31 - lane);  // this lane and the ones below
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const i64 i = w0 + j * 32 + lane;
    const Run r = combine(run, run_of(starts[j] & upto, w0 + j * 32));
    if (i < n) {
      group_id[i] = r.n - 1;
      if (ends[j] >> lane & 1) counts[r.n - 1] = i + 1 - (r.last - 1);
    }
    run = combine(run, run_of(starts[j], w0 + j * 32));
  }
}

// one key: every event in one group, in index order
__global__ void single_key_kernel(i64 n, i64* order, i64* group_id, i64* counts) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    order[i] = i;
    group_id[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[0] = n;
}

// ------------------------------------------- fix-up when the times are unsorted

struct Item {
  double t;
  i64 i;
};

// (time, index) order
__device__ __forceinline__ bool before(const Item& a, const Item& b) {
  if (a.t != b.t) return a.t < b.t;
  return a.i < b.i;
}

__device__ __forceinline__ Item item_of(i64 idx, const double* ts) { return Item{ts[idx], idx}; }

__global__ void fixup_small(i64* order, i64 n, const i64* group_id, const i64* counts,
                            const double* ts, int* big, int* n_big) {
  for (i64 a = blockIdx.x * (i64)blockDim.x + threadIdx.x; a < n;
       a += (i64)gridDim.x * blockDim.x) {
    if (a > 0 && group_id[a] == group_id[a - 1]) continue;  // not a group's start
    const i64 len = counts[group_id[a]];
    if (len > SMALL) {
      big[atomicAdd(n_big, 1)] = (int)a;
      continue;
    }
    i64* o = order + a;
    for (int i = 1; i < len; ++i) {
      const Item v = item_of(o[i], ts);
      int j = i - 1;
      while (j >= 0 && before(v, item_of(o[j], ts))) {
        o[j + 1] = o[j];
        --j;
      }
      o[j + 1] = v.i;
    }
  }
}

// bitonic sort of one tile (at most BITONIC_TILE entries) of o in shared memory
__device__ void sort_tile(i64* o, int n, const double* ts, Item* s) {
  for (int i = threadIdx.x; i < BITONIC_TILE; i += blockDim.x) {
    if (i < n) {
      s[i] = item_of(o[i], ts);
    } else {  // padding sorts last
      s[i].t = __longlong_as_double(0x7ff0000000000000LL);  // +inf
      s[i].i = INT64_MAX;
    }
  }
  __syncthreads();
  for (int k = 2; k <= BITONIC_TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < BITONIC_TILE; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const Item a = s[i], b = s[p];
          const bool up = (i & k) == 0;
          if (up ? before(b, a) : before(a, b)) {
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

// block-wide stable merge of A[0, n1) and B[0, n2) into dst
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
      if (!before(item_of(B[d - 1 - mid], ts), item_of(A[mid], ts)))
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
      else take_a = !before(item_of(B[j], ts), item_of(A[i], ts));
      dst[q] = take_a ? A[i++] : B[j++];
    }
  }
}

__global__ void fixup_large(i64* order, i64* tmp, const i64* group_id, const i64* counts,
                            const double* ts, const int* big, const int* n_big) {
  __shared__ Item s[BITONIC_TILE];
  const int count = *n_big;
  for (int b = blockIdx.x; b < count; b += gridDim.x) {
    const i64 a = big[b], n = counts[group_id[a]];
    i64* src = order + a;
    i64* dst = tmp + a;
    for (i64 t0 = 0; t0 < n; t0 += BITONIC_TILE)
      sort_tile(src + t0, (int)(n - t0 < BITONIC_TILE ? n - t0 : BITONIC_TILE), ts, s);
    for (i64 w = BITONIC_TILE; w < n; w <<= 1) {
      for (i64 r = 0; r < n; r += 2 * w) {
        const i64 n1 = n - r < w ? n - r : w;
        const i64 rest = n - r - n1;
        const i64 n2 = rest < w ? rest : w;
        merge_runs(src + r, n1, src + r + n1, n2, dst + r, ts);
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

// -------------------------------------------------------------- group tables

// offs[g] for every g in (the previous event's id, this one's] where a run
// starts, offs[g] = n for g after the last id; *bad = 1 where an id is
// below the one before it or outside [0, G), and nothing written for it
__global__ void group_offsets(const i64* group_id, i64 n, i64 G, i64* offs, int* bad) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    const i64 g = group_id[i];
    const i64 prev = i > 0 ? group_id[i - 1] : -1;
    if (g < prev || g < 0 || g >= G) {
      *bad = 1;
      continue;
    }
    for (i64 h = prev + 1; h <= g; ++h) offs[h] = i;
    if (i == n - 1)
      for (i64 h = g + 1; h <= G; ++h) offs[h] = n;
  }
}

__global__ void group_finish(const i64* group_id, i64 n, i64 G, const i64* offs, i64* counts,
                             i64* num_succ, const int* bad) {
  if (*bad) return;  // offs is incomplete: the host raises
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n || i < G;
       i += (i64)gridDim.x * blockDim.x) {
    if (i < G) counts[i] = offs[i + 1] - offs[i];
    if (i < n) num_succ[i] = offs[group_id[i] + 1] - i - 1;
  }
}

}  // namespace

extern "C" {

// the fix-up's list of long groups: room for every group of more than SMALL of n events
long long e1_big_capacity(long long n) { return n / (SMALL + 1) + 1; }

// keys a tile of e1_pass / e1_groups ranks
int e1_tile() { return TILE; }

// the sort workspace's int64 words for n events and d digits of b0, b1, b2
// bits (the ones past d unused); -1 for a plan E1 does not take
long long e1_sort_workspace(long long n, int d, int b0, int b1, int b2) {
  const int bits[3] = {b0, b1, b2};
  return plan_ok(d, bits) ? layout(nullptr, n, d, bits, nullptr) : -1;
}

int e1_prepass(const void* xs, const void* ys, const void* ts, const void* fids, long long n,
               int W, void* red, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  prepass_init<<<1, 1, 0, s>>>((i64*)red);
  prepass_kernel<<<grid_for(n), THREADS, 0, s>>>((const float*)xs, (const float*)ys,
                                                 (const double*)ts, (const int*)fids, n, W,
                                                 (i64*)red);
  return (int)cudaGetLastError();
}

// every digit's histogram and bucket starts into ws (e1_sort_workspace's
// words, zeroed), for d digits of b0, b1, b2 bits, least significant first
int e1_histogram(const void* xs, const void* ys, const void* fids, long long n, int W,
                 long long fmin, long long pmin, long long P, int d, int b0, int b1, int b2,
                 void* ws, void* stream) {
  const int bits[3] = {b0, b1, b2};
  if (!plan_ok(d, bits)) return (int)cudaErrorInvalidValue;
  Workspace l;
  layout(ws, n, d, bits, &l);
  Digits dg;
  dg.d = d;
  int shift = 0, bins = 0;
  for (int p = 0; p < 3; ++p) {
    dg.shift[p] = shift;
    dg.bits[p] = p < d ? bits[p] : 0;
    dg.hist[p] = l.hist[p];
    dg.start[p] = l.start[p];
    if (p < d) {
      shift += bits[p];
      bins += 1 << bits[p];
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  histogram_kernel<<<HIST_BLOCKS, THREADS, sizeof(int) * bins, s>>>(
      (const float*)xs, (const float*)ys, (const int*)fids, n, W, fmin, pmin, P, dg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  digit_starts<<<d, THREADS, 0, s>>>(dg);
  return (int)cudaGetLastError();
}

// LSD pass p of the plan over its digit, as Pass says: the first computes
// the keys from xs, ys, fids (key_in, val_in unused), the last writes the
// indices into order (val_out unused)
int e1_pass(const void* xs, const void* ys, const void* fids, long long n, int W,
            long long fmin, long long pmin, long long P, const void* key_in,
            const void* val_in, int p, int d, int b0, int b1, int b2, void* ws, void* key_out,
            void* val_out, void* order, void* stream) {
  const int bits[3] = {b0, b1, b2};
  if (!plan_ok(d, bits) || p < 0 || p >= d) return (int)cudaErrorInvalidValue;
  Workspace l;
  layout(ws, n, d, bits, &l);
  int shift = 0;
  for (int q = 0; q < p; ++q) shift += bits[q];
  const Pass a{(const float*)xs, (const float*)ys, (const int*)fids, W, fmin, pmin, P,
               (const int*)key_in, (const int*)val_in, n, shift, bits[p], l.start[p],
               l.status[p], l.counter[p], (int*)key_out, (int*)val_out, (i64*)order};
  cudaStream_t s = (cudaStream_t)stream;
  const bool first = p == 0, last = p == d - 1;
  if (first) return last ? launch_pass<true, true>(a, s) : launch_pass<true, false>(a, s);
  return last ? launch_pass<false, true>(a, s) : launch_pass<false, false>(a, s);
}

// group ids and counts from the sorted keys; ws: the passes' workspace;
// counts: room for n
int e1_groups(const void* keys, long long n, int d, int b0, int b1, int b2, void* ws,
              void* group_id, void* counts, void* stream) {
  const int bits[3] = {b0, b1, b2};
  if (!plan_ok(d, bits)) return (int)cudaErrorInvalidValue;
  Workspace l;
  layout(ws, n, d, bits, &l);
  const i64 tiles = (n + TILE - 1) / TILE;
  group_kernel<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)keys, n, l.group_status, l.counter[d], (i64*)group_id, (i64*)counts);
  return (int)cudaGetLastError();
}

// one key (K = 1): the order is the identity, one group of n
int e1_single_key(long long n, void* order, void* group_id, void* counts, void* stream) {
  single_key_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      n, (i64*)order, (i64*)group_id, (i64*)counts);
  return (int)cudaGetLastError();
}

// each group's indices into (t, index) order; tmp: [n] int64; n_big: one
// zeroed int32; big: e1_big_capacity(n) int32
int e1_fixup(void* order, void* tmp, long long n, const void* group_id, const void* counts,
             const void* ts, void* big, void* n_big, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  fixup_small<<<grid_for(n), THREADS, 0, s>>>((i64*)order, n, (const i64*)group_id,
                                              (const i64*)counts, (const double*)ts, (int*)big,
                                              (int*)n_big);
  fixup_large<<<132 * 2, THREADS, 0, s>>>((i64*)order, (i64*)tmp, (const i64*)group_id,
                                          (const i64*)counts, (const double*)ts,
                                          (const int*)big, (const int*)n_big);
  return (int)cudaGetLastError();
}

// group_id: [n] non-decreasing in [0, G); offs: [G + 1]; counts: [G]; num_succ: [n];
// bad: one zeroed int32, 1 after the launch where the ids are not so
int e1_group_tables(const void* group_id, long long n, long long G, void* offs, void* counts,
                    void* num_succ, void* bad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(offs, 0, sizeof(i64) * (G + 1), s);
    if (err != cudaSuccess) return (int)err;
  }
  group_offsets<<<grid_for(n), THREADS, 0, s>>>((const i64*)group_id, n, G, (i64*)offs,
                                                (int*)bad);
  group_finish<<<grid_for(n > G ? n : G), THREADS, 0, s>>>(
      (const i64*)group_id, n, G, (const i64*)offs, (i64*)counts, (i64*)num_succ,
      (const int*)bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
