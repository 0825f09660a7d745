// Block-grid table gradient for Hopper (sm_90a): the backward pass of the
// block-packed multiresolution encoder with respect to its table.
//
// Replaces enerf_tpu/ops/scatter_accum.py:_make_kernel (the Pallas TPU
// kernel behind block_table_grad_pallas).  For each (sample, level) pair i
// with table row r = rid[i], cell offset lo[i] in [0, block)^3, trilinear
// fraction frac[i] and the two feature gradients g[i]:
//   for each corner (dx, dy, dz) in {0, 1}^3:
//     w = (wx(dx) * wy(dy)) * wz(dz)       wx(0) = 1 - fx, wx(1) = fx
//     p = ((lo.x + dx) * halo + lo.y + dy) * halo + lo.z + dz
//     grad[r, c * row_cells + p] += g[i, c] * w      for c = 0, 1
// The corner weights are multiplied in the order of the plain PyTorch
// version (ops/scatter_accum.py:block_table_grad_reference, which builds
// W = (wx * wy) * wz over the whole row), so every addend is bit-equal to
// the plain version's; only the order of the sums differs.
//
// What bounds it on an H100: bytes.  The work reads g (8 bytes) of every
// pair and 28 bytes more (rid 4, lo 12, frac 12) of each live pair, one
// whose g is not all zero, and writes the table gradient once (97,827 rows
// x 250 f32 = 97.8 MB at 16 x 2 levels, block 4).  At 2,097,152 live pairs
// that is 75.5 MB + 97.8 MB: 52 us at 3.35 TB/s.  There is no arithmetic
// to speak of (8 weights, 16 products per live pair).
//
// Design: the TPU kernel kept one level's gradient in VMEM, added into it
// and wrote the level once.  A Hopper block has at most 227 KB of shared
// memory, not a level's 8 MB, so the pairs are sorted into tiles of rows
// that do fit (tile_rows consecutive global rows, ~96 KB), and each tile
// is accumulated in shared memory and written once:
//  - Pre-pass (block_table_grad_prepass), three small kernels:
//    count_kernel counts the pairs of each tile, skipping pairs whose g is
//    all zero (out-of-box samples), in per-block histograms first;
//    scan_kernel (one block) takes the exclusive scan of the counts and
//    cuts each tile's segment into chunks of at most chunk_pairs pairs (a
//    tile with no pair still gets one chunk, which writes its zeros), the
//    work list; scatter_kernel writes each pair into its tile's segment as
//    a 24-byte record, {row in tile << 16 | first cell, fx, fy, fz} and
//    {g0, g1}, staged in shared memory tile by tile so that consecutive
//    threads store consecutive records.  Given pairs level by level (as
//    pair_inputs lists them), a block's pairs fall on few tiles and those
//    runs are long; any order is right.
//  - accumulate_kernel: persistent blocks (two per SM) claim chunks from a
//    counter.  For each, the block streams the chunk's records and adds
//    each pair's 16 products into the tile in shared memory, then writes
//    the tile out and leaves it zeroed for the next chunk.  Hopper has no
//    f32 add on shared memory (red.shared.add.f32 compiles to a
//    compare-and-swap loop per float), so the tile keeps a cell's two
//    channels side by side and one 64-bit compare-and-swap adds both: 8
//    shared-memory atomics per pair.  Rows are padded to an odd number of
//    cells, which spreads the bank pairs (block 3's rows are 64 cells).
//  - A tile of one chunk is owned by its block, which writes every float
//    of the tile, zeros included, with coalesced stores: no memset of the
//    gradient comes first.  A tile of several chunks (the dense coarse
//    levels, where ~131,072 pairs fall on a few hundred rows) is shared:
//    zero_shared_kernel zeroes its rows alone, and each chunk's block adds
//    its non-zero partial sums with global atomics.
// A cell that no pair adds to is written as an exact 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPassThreads = 512, kPassItems = 16;  // the count: pairs per thread
constexpr int kScatterThreads = 256, kScatterItems = 4;  // the scatter: pairs per thread
constexpr int kStage = kScatterThreads * kScatterItems;  // the scatter's pairs per block
constexpr int kStageBytes = kStage * (16 + 8 + 4);  // its staged records and their tiles
constexpr int kScanThreads = 1024;
constexpr int kAccThreads = 512;
// The accumulation's shared memory at most: a tile of 96 KB of gradient
// (ops/scatter_accum.py: TILE_BYTES) whose rows are padded by one cell,
// at most 9/8 of it (a row holds 8 cells at least).
constexpr int kTileSmem = 108 * 1024;
constexpr int kMaxTiles = 16384;  // the pre-pass's per-block histograms in shared memory
constexpr int kMaxBlocksPerSM = 4;

// The plan, one int32 buffer: counts[tiles] | offsets[tiles + 1] |
// chunk_off[tiles + 1] | cursor[tiles] | ctl[2] (chunks, next chunk to
// claim) | chunk_tile[chunks].  Tile t's records are
// [offsets[t], offsets[t + 1]); its chunks are [chunk_off[t], chunk_off[t + 1]).
struct Plan {
  int *counts, *offsets, *chunk_off, *cursor, *ctl, *chunk_tile;
};

__host__ __device__ __forceinline__ Plan plan_of(int* base, int tiles) {
  Plan p;
  p.counts = base;
  p.offsets = p.counts + tiles;
  p.chunk_off = p.offsets + tiles + 1;
  p.cursor = p.chunk_off + tiles + 1;
  p.ctl = p.cursor + tiles;
  p.chunk_tile = p.ctl + 2;
  return p;
}

__device__ __forceinline__ bool live(const float* __restrict__ g, long long i) {
  return g[2 * i] != 0.0f || g[2 * i + 1] != 0.0f;
}

__device__ __forceinline__ int chunks_of(int count, int chunk_pairs) {
  return count == 0 ? 1 : (count + chunk_pairs - 1) / chunk_pairs;
}

// counts[t] += the live pairs on tile t; traps on a row out of range.
__global__ void __launch_bounds__(kPassThreads)
count_kernel(const int* __restrict__ rid, const float* __restrict__ g, long long pairs,
             int total_rows, int tile_rows, int tiles, int* __restrict__ counts) {
  extern __shared__ int hist[];
  for (int t = threadIdx.x; t < tiles; t += kPassThreads) hist[t] = 0;
  __syncthreads();
  const long long first = (long long)blockIdx.x * kPassThreads * kPassItems;
  int row_of[kPassItems];
#pragma unroll
  for (int j = 0; j < kPassItems; ++j) {  // every load first, then the adds
    const long long i = first + (long long)j * kPassThreads + threadIdx.x;
    row_of[j] = -1;
    if (i < pairs && live(g, i)) {
      row_of[j] = rid[i];
      if (row_of[j] < 0 || row_of[j] >= total_rows) __trap();
    }
  }
#pragma unroll
  for (int j = 0; j < kPassItems; ++j)
    if (row_of[j] >= 0) atomicAdd(&hist[row_of[j] / tile_rows], 1);
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += kPassThreads)
    if (hist[t]) atomicAdd(&counts[t], hist[t]);
}

// One block: offsets = exclusive scan of counts, cursor = offsets, the
// chunks of each tile and the work list chunk_tile.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ plan, int tiles, int chunk_pairs) {
  const Plan p = plan_of(plan, tiles);
  __shared__ int warp_pairs[kScanThreads / 32], warp_chunks[kScanThreads / 32];
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min((int)threadIdx.x * per, tiles), t1 = min(t0 + per, tiles);
  int np = 0, nc = 0;
  for (int t = t0; t < t1; ++t) {
    np += p.counts[t];
    nc += chunks_of(p.counts[t], chunk_pairs);
  }
  // inclusive scan in the warp, then over the warps' totals
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int sp = np, sc = nc;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(0xffffffffu, sp, d), uc = __shfl_up_sync(0xffffffffu, sc, d);
    if (lane >= d) {
      sp += up;
      sc += uc;
    }
  }
  if (lane == 31) {
    warp_pairs[warp] = sp;
    warp_chunks[warp] = sc;
  }
  __syncthreads();
  if (warp == 0) {
    int wp = warp_pairs[lane], wc = warp_chunks[lane];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, wp, d), uc = __shfl_up_sync(0xffffffffu, wc, d);
      if (lane >= d) {
        wp += up;
        wc += uc;
      }
    }
    warp_pairs[lane] = wp - warp_pairs[lane];  // exclusive
    warp_chunks[lane] = wc - warp_chunks[lane];
  }
  __syncthreads();
  int off = warp_pairs[warp] + sp - np, coff = warp_chunks[warp] + sc - nc;
  for (int t = t0; t < t1; ++t) {
    const int c = p.counts[t], k = chunks_of(c, chunk_pairs);
    p.offsets[t] = off;
    p.cursor[t] = off;
    p.chunk_off[t] = coff;
    for (int j = 0; j < k; ++j) p.chunk_tile[coff + j] = t;
    off += c;
    coff += k;
  }
  if (threadIdx.x == kScanThreads - 1) {  // holds the totals
    p.offsets[tiles] = off;
    p.chunk_off[tiles] = coff;
    p.ctl[0] = coff;
    p.ctl[1] = 0;
  }
}

// Each live pair's record into its tile's segment.  A block takes kStage
// consecutive pairs (coalesced loads); it ranks them by tile in shared
// memory, reserves a range of each tile's segment (cursor), stages the
// records there tile by tile and copies them out, so that consecutive
// threads store consecutive records of one run.  Pairs listed level by
// level (ops/scatter_accum.py:pair_inputs) fall on few tiles per block,
// which makes the runs long.  Traps on a cell offset outside the block.
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const int* __restrict__ rid, const int* __restrict__ lo,
               const float* __restrict__ frac, const float* __restrict__ g, long long pairs,
               int tile_rows, int tiles, int halo, int* __restrict__ cursor,
               float4* __restrict__ rec_a, float2* __restrict__ rec_b) {
  extern __shared__ __align__(16) unsigned char sm[];
  float4* stage_a = reinterpret_cast<float4*>(sm);           // [kStage]
  float2* stage_b = reinterpret_cast<float2*>(stage_a + kStage);
  int* stage_tile = reinterpret_cast<int*>(stage_b + kStage);  // [kStage]
  int* local = stage_tile + kStage;  // [tiles]: the block's count, then its first slot
  int* global_start = local + tiles;  // [tiles]: the block's range of the segment
  __shared__ int warp_sums[kScatterThreads / 32], staged;
  for (int t = threadIdx.x; t < tiles; t += kScatterThreads) local[t] = 0;
  __syncthreads();
  const long long first = (long long)blockIdx.x * kStage;
  int row_of[kScatterItems], rank[kScatterItems];
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j) {
    const long long i = first + j * kScatterThreads + threadIdx.x;
    row_of[j] = i < pairs && live(g, i) ? rid[i] : -1;
  }
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j)
    if (row_of[j] >= 0) rank[j] = atomicAdd(&local[row_of[j] / tile_rows], 1);
  __syncthreads();
  // each thread a run of tiles: reserve their ranges, then the exclusive
  // scan of the counts over the block gives each tile's first slot
  const int per = (tiles + kScatterThreads - 1) / kScatterThreads;
  const int t0 = min((int)threadIdx.x * per, tiles), t1 = min(t0 + per, tiles);
  int sum = 0;
  for (int t = t0; t < t1; ++t) {
    const int c = local[t];
    if (c) global_start[t] = atomicAdd(&cursor[t], c);
    sum += c;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int t = t0; t < t1; ++t) {
    const int c = local[t];
    local[t] = run;
    run += c;
  }
  if (threadIdx.x == kScatterThreads - 1) staged = run;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j) {
    if (row_of[j] < 0) continue;
    const long long i = first + j * kScatterThreads + threadIdx.x;
    const int t = row_of[j] / tile_rows, k = local[t] + rank[j];
    const int lx = lo[3 * i], ly = lo[3 * i + 1], lz = lo[3 * i + 2];
    if ((unsigned)lx >= (unsigned)(halo - 1) || (unsigned)ly >= (unsigned)(halo - 1) ||
        (unsigned)lz >= (unsigned)(halo - 1))
      __trap();
    const uint32_t hdr = ((uint32_t)(row_of[j] - t * tile_rows) << 16) |
                         (uint32_t)((lx * halo + ly) * halo + lz);
    stage_a[k] = make_float4(__uint_as_float(hdr), frac[3 * i], frac[3 * i + 1], frac[3 * i + 2]);
    stage_b[k] = make_float2(g[2 * i], g[2 * i + 1]);
    stage_tile[k] = t;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < staged; k += kScatterThreads) {
    const int t = stage_tile[k], pos = global_start[t] + k - local[t];
    rec_a[pos] = stage_a[k];
    rec_b[pos] = stage_b[k];
  }
}

// Zero the rows of the shared tiles (the tiles of several chunks), which
// accumulate_kernel adds into with global atomics.
__global__ void __launch_bounds__(256)
zero_shared_kernel(const int* __restrict__ plan, int tiles, float* __restrict__ grad,
                   int total_rows, int tile_rows, int row_floats) {
  const Plan p = plan_of(const_cast<int*>(plan), tiles);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (p.chunk_off[t + 1] - p.chunk_off[t] < 2) continue;
    float* dst = grad + (size_t)t * tile_rows * row_floats;  // 16-byte aligned: tile_rows even
    const int n = min(tile_rows, total_rows - t * tile_rows) * row_floats;
    for (int j = threadIdx.x; j < n / 4; j += blockDim.x)
      reinterpret_cast<float4*>(dst)[j] = make_float4(0, 0, 0, 0);
    for (int j = n / 4 * 4 + threadIdx.x; j < n; j += blockDim.x) dst[j] = 0.0f;
  }
}

// cell[0] += a and cell[1] += b, one 64-bit compare-and-swap on shared
// memory (Hopper has no f32 add on shared memory: red.shared.add.f32 is
// the same loop, one float at a time).
__device__ __forceinline__ void add2_shared(float* cell, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long old = *q, seen;
  do {
    seen = old;
    const float x = __fadd_rn(__uint_as_float((uint32_t)seen), a);
    const float y = __fadd_rn(__uint_as_float((uint32_t)(seen >> 32)), b);
    old = atomicCAS(q, seen, ((unsigned long long)__float_as_uint(y) << 32) | __float_as_uint(x));
  } while (old != seen);
}

// One record's 16 products into the tile, whose cells hold their two
// channels side by side: cell (row, p) at tile + 2 * (row * stride + p).
__device__ __forceinline__ void add_pair(float* tile, float4 a, float2 b, int stride, int halo) {
  const uint32_t hdr = __float_as_uint(a.x);
  float* cell = tile + 2 * ((hdr >> 16) * stride + (hdr & 0xffffu));
  const float wxs[2] = {1.0f - a.y, a.y};
  const float wys[2] = {1.0f - a.z, a.z};
  const float wzs[2] = {1.0f - a.w, a.w};
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = __fmul_rn(wxs[dx], wys[dy]);
      float* q = cell + 2 * (dx * halo + dy) * halo;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(wxy, wzs[dz]);
        add2_shared(q + 2 * dz, __fmul_rn(b.x, w), __fmul_rn(b.y, w));
      }
    }
  }
}

// The tile's row stride in cells: row_cells made odd, so that the rows of
// a 64-bit word's bank pair spread (block 3: 64 cells a row).
__host__ __device__ __forceinline__ int tile_stride(int row_cells) { return row_cells | 1; }

__global__ void __launch_bounds__(kAccThreads, 2)
accumulate_kernel(const float4* __restrict__ rec_a, const float2* __restrict__ rec_b,
                  int* __restrict__ plan, int tiles, float* __restrict__ grad, int total_rows,
                  int tile_rows, int row_cells, int halo, int chunk_pairs) {
  extern __shared__ __align__(16) float tile[];
  __shared__ int claimed;
  const Plan p = plan_of(plan, tiles);
  const int row_floats = 2 * row_cells, stride = tile_stride(row_cells);
  for (int j = threadIdx.x; j < tile_rows * stride / 2; j += kAccThreads)
    reinterpret_cast<float4*>(tile)[j] = make_float4(0, 0, 0, 0);
  const int chunks = p.ctl[0];
  while (true) {
    if (threadIdx.x == 0) claimed = atomicAdd(&p.ctl[1], 1);
    __syncthreads();  // the claim, and the tile zeroed by the last chunk
    const int c = claimed;
    if (c >= chunks) break;
    const int t = p.chunk_tile[c];
    const bool shared = p.chunk_off[t + 1] - p.chunk_off[t] > 1;
    const int begin = p.offsets[t] + (c - p.chunk_off[t]) * chunk_pairs;
    const int end = min(begin + chunk_pairs, p.offsets[t + 1]);
    int i = begin + threadIdx.x;
    float4 a = make_float4(0, 0, 0, 0);
    float2 b = make_float2(0, 0);
    if (i < end) {
      a = __ldcs(rec_a + i);
      b = __ldcs(rec_b + i);
    }
    for (; i < end; i += kAccThreads) {
      float4 na = a;
      float2 nb = b;
      if (i + kAccThreads < end) {
        na = __ldcs(rec_a + i + kAccThreads);
        nb = __ldcs(rec_b + i + kAccThreads);
      }
      add_pair(tile, a, b, stride, halo);
      a = na;
      b = nb;
    }
    __syncthreads();
    // out: thread j takes the tile's floats j, j + kAccThreads, ... of the
    // flat gradient, so each warp stores 32 consecutive floats; (row,
    // channel, cell) of a float follows by increments.  A cell is zeroed
    // once read.  Owned: every float, zeros included; shared: the non-zero
    // ones added into rows zeroed by zero_shared_kernel.
    const int n = min(tile_rows, total_rows - t * tile_rows) * row_floats;
    float* dst = grad + (size_t)t * tile_rows * row_floats;
    int r = threadIdx.x / row_floats, rem = threadIdx.x % row_floats;
    const int step_r = kAccThreads / row_floats, step_rem = kAccThreads % row_floats;
    for (int j = threadIdx.x; j < n; j += kAccThreads) {
      const int ch = rem >= row_cells;
      float* cell = tile + 2 * (r * stride + rem - ch * row_cells) + ch;
      const float v = *cell;
      *cell = 0.0f;
      if (!shared)
        dst[j] = v;
      else if (v != 0.0f)
        atomicAdd(dst + j, v);
      r += step_r;
      rem += step_rem;
      if (rem >= row_floats) {
        rem -= row_floats;
        ++r;
      }
    }
  }
}

// The scratch of one call, one buffer: rec_a [pairs] float4 | rec_b
// [pairs] float2 | the plan (int32, 4 * tiles + 4 + max_chunks entries,
// max_chunks = tiles + ceil(pairs / chunk_pairs)); 16-byte aligned.
struct Scratch {
  float4* rec_a;
  float2* rec_b;
  int* plan;
};

Scratch scratch_of(void* base, long long pairs) {
  char* b = static_cast<char*>(base);
  return {reinterpret_cast<float4*>(b), reinterpret_cast<float2*>(b + 16 * pairs),
          reinterpret_cast<int*>(b + 24 * pairs)};
}

// The pre-pass's kernels on `s`; arguments checked by the caller.
cudaError_t prepass(const void* rid, const void* lo, const void* frac, const void* g,
                    const Scratch& sc, long long pairs, long long total_rows, int tile_rows,
                    int chunk_pairs, int halo, cudaStream_t s) {
  const long long tiles = (total_rows + tile_rows - 1) / tile_rows;
  thread_local int attrs_dev = -1;  // the device whose kernels' attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != attrs_dev) {
    err = cudaFuncSetAttribute(count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxTiles * 4);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStageBytes + kMaxTiles * 8);
    if (err != cudaSuccess) return err;
    attrs_dev = dev;
  }
  const Plan p = plan_of(sc.plan, (int)tiles);
  err = cudaMemsetAsync(p.counts, 0, sizeof(int) * (size_t)tiles, s);
  if (err != cudaSuccess) return err;
  const long long per_block = kPassThreads * kPassItems;
  const unsigned blocks = (unsigned)((pairs + per_block - 1) / per_block);
  const unsigned scatter_blocks = (unsigned)((pairs + kStage - 1) / kStage);
  if (blocks)
    count_kernel<<<blocks, kPassThreads, (size_t)tiles * 4, s>>>(
        (const int*)rid, (const float*)g, pairs, (int)total_rows, tile_rows, (int)tiles,
        p.counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(sc.plan, (int)tiles, chunk_pairs);
  if (blocks)
    scatter_kernel<<<scatter_blocks, kScatterThreads, kStageBytes + (size_t)tiles * 8, s>>>(
        (const int*)rid, (const int*)lo, (const float*)frac, (const float*)g, pairs, tile_rows,
        (int)tiles, halo, p.cursor, sc.rec_a, sc.rec_b);
  return cudaGetLastError();
}

bool bad_args(long long pairs, long long total_rows, int tile_rows, int chunk_pairs, int halo,
              const void* scratch) {
  return pairs < 0 || pairs > INT32_MAX || total_rows < 1 || total_rows > INT32_MAX ||
         tile_rows < 2 || tile_rows % 2 || tile_rows > 65535 || chunk_pairs < 1 || halo < 2 ||
         halo * halo * halo > 65535 || (uintptr_t)scratch % 16 ||
         (total_rows + tile_rows - 1) / tile_rows > kMaxTiles;
}

}  // namespace

// The pre-pass alone (its plan is read back by the caller).  rid [pairs]
// int32 global row ids, lo [pairs, 3] int32, frac [pairs, 3] f32, g
// [pairs, 2] f32; scratch as Scratch above.  tile_rows even, at most
// kMaxTiles tiles.  Launches on `stream`; returns a cudaError_t (0 on
// success).
extern "C" int block_table_grad_prepass(const void* rid, const void* lo, const void* frac,
                                        const void* g, void* scratch, long long pairs,
                                        long long total_rows, int tile_rows, int chunk_pairs,
                                        int halo, void* stream) {
  if (bad_args(pairs, total_rows, tile_rows, chunk_pairs, halo, scratch))
    return (int)cudaErrorInvalidValue;
  return (int)prepass(rid, lo, frac, g, scratch_of(scratch, pairs), pairs, total_rows,
                      tile_rows, chunk_pairs, halo, (cudaStream_t)stream);
}

// K2: the pre-pass, then the accumulation into grad [total_rows, 2 *
// row_cells] f32 (16-byte aligned, not zeroed by the caller: every row is
// written).  Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int block_table_grad_launch(const void* rid, const void* lo, const void* frac,
                                       const void* g, void* grad, void* scratch,
                                       long long pairs, long long total_rows, int tile_rows,
                                       int chunk_pairs, int halo, int row_cells,
                                       void* stream) {
  const int smem = tile_rows * tile_stride(row_cells) * 8;
  if (bad_args(pairs, total_rows, tile_rows, chunk_pairs, halo, scratch) ||
      row_cells != halo * halo * halo || smem > kTileSmem || (uintptr_t)grad % 16)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)((total_rows + tile_rows - 1) / tile_rows);
  const long long max_chunks = tiles + (pairs + chunk_pairs - 1) / chunk_pairs;
  const int row_floats = 2 * row_cells;
  cudaStream_t s = (cudaStream_t)stream;

  // the persistent grid's size on this device at kTileSmem, found once
  thread_local int last_dev = -1;
  thread_local long long max_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != last_dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kTileSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accumulate_kernel,
                                                          kAccThreads, kTileSmem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks = (long long)sms * (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM);
    last_dev = dev;
  }
  const Scratch sc = scratch_of(scratch, pairs);
  err = prepass(rid, lo, frac, g, sc, pairs, total_rows, tile_rows, chunk_pairs, halo, s);
  if (err != cudaSuccess) return (int)err;
  zero_shared_kernel<<<tiles < 1024 ? tiles : 1024, 256, 0, s>>>(
      sc.plan, tiles, (float*)grad, (int)total_rows, tile_rows, row_floats);
  const long long blocks = max_chunks < max_blocks ? max_chunks : max_blocks;
  accumulate_kernel<<<(unsigned)blocks, kAccThreads, smem, s>>>(
      sc.rec_a, sc.rec_b, sc.plan, tiles, (float*)grad, (int)total_rows, tile_rows, row_cells,
      halo, chunk_pairs);
  return (int)cudaGetLastError();
}
