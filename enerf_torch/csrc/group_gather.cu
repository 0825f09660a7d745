// 8-row group gather for Hopper (sm_90a): out[8i + r, :] = table[8 gidx[i] + r, :].
//
// Replaces scripts/bench_gather.py:make_group_gather.kernel, the Pallas TPU
// kernel of the random-row gather microbenchmark.  On the TPU, Mosaic only
// slices device memory in (8, 128) tiles, so the smallest random read is an
// 8-row group, copied by a W-deep window of async DMAs into VMEM.
//
// What bounds it on an H100: bytes.  Each distinct table group has to be
// read once and each output group written once (plus 4 bytes of index),
// with no arithmetic.  At the benchmark's shapes 262,144 groups are drawn
// from 16,784 (8 x 128 f32) or 12,228 (8 x 250 f32) table groups, so each is
// gathered 15.6x / 21.4x from a table (68.7 / 97.8 MB) about the size of the
// 50 MB L2, and the output (1.07 / 2.10 GB) is written once.  The floor is
// the output stream: 0.32 / 0.63 ms at 3.35 TB/s.  Gathered in the order
// given, the re-reads miss L2 long before the table fills it (measured on
// the H100, PERF.md: from an 8 MB table the gather runs at the output's
// write rate, from a 17 MB one it is a third slower, with or without L2
// cache policies), so a copy in index order pays for most re-reads in HBM.
//
// Design: the groups are copied slice by slice of the table, by the Tensor
// Memory Accelerator, with L2 cache policies.
//  - Slice order: when the table is larger than one slice (kSliceBytes), a
//    pre-pass lists the output groups by the table slice they read
//    (slice_count_kernel, slice_order_kernel: a counting sort on the slice,
//    in no order within one), and the copy blocks walk that list in step,
//    32 groups at a time (block b takes batches b, b + grid, ...), so the
//    groups in flight at any moment read from a few slices, which stay in
//    L2.  The output is the same bytes in any order.
//  - A group is one contiguous span of 8 * D f32 = 32 D bytes, a multiple of
//    16 for every D, so it is one cp.async.bulk into a stage of a shared-
//    memory ring (completion on that stage's mbarrier) and one cp.async.bulk
//    back out to the output (a bulk group).  A span larger than a stage is
//    cut into chunks; at the benchmark's shapes every span fits one stage.
//  - Loads carry an L2::evict_last policy, stores an L2::evict_first one
//    (createpolicy.fractional), passed as .L2::cache_hint operands; the
//    caller's stream state (its access policy window) is left alone.
//  - One thread of each block issues every copy; threads hold no data.  The
//    warp reads the next 32 group indices ahead, one per lane, and checks
//    them: an index outside [0, table_groups) traps before any copy of its
//    batch is issued (and in the pre-pass, before any copy at all), like
//    PyTorch's device-side index assert.
//  - `windows` (the TPU kernel's DMA window, groups in flight per block)
//    is the ring's stage count: W - 1 loads in flight while a store drains.
//  - The grid is persistent: a few blocks per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRingBytes = 128 * 1024;         // the ring's size at most, per block
constexpr long long kSliceBytes = 1LL << 20;  // table bytes per slice of the walk
constexpr int kMaxSlices = 1024;
constexpr int kMaxBlocksPerSM = 4;
constexpr int kThreads = 32;  // one warp: lane 0 issues, all lanes fetch indices
constexpr int kSortThreads = 256, kSortItems = 16;  // the pre-pass: groups per thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni LAB_DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "LAB_DONE:\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// Store groups still reading shared memory: at most N of them may remain.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// counts[s] += the groups whose source lies in slice s; traps on an index
// out of range.
__global__ void __launch_bounds__(kSortThreads)
slice_count_kernel(const int* __restrict__ gidx, long long groups, long long table_groups,
                   int slice_groups, int slices, int* __restrict__ counts) {
  __shared__ int hist[kMaxSlices];
  for (int s = threadIdx.x; s < slices; s += blockDim.x) hist[s] = 0;
  __syncthreads();
  const long long first = (long long)blockIdx.x * kSortThreads * kSortItems;
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = first + j * kSortThreads + threadIdx.x;
    if (i >= groups) break;
    const long long src = gidx[i];
    if (src < 0 || src >= table_groups) __trap();
    atomicAdd(&hist[src / slice_groups], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < slices; s += blockDim.x)
    if (hist[s]) atomicAdd(&counts[s], hist[s]);
}

// order = the groups listed slice by slice: each block reserves a range in
// each slice's part (cursor) and writes its groups there.
__global__ void __launch_bounds__(kSortThreads)
slice_order_kernel(const int* __restrict__ gidx, long long groups, int slice_groups,
                   int slices, const int* __restrict__ counts, int* __restrict__ cursor,
                   int* __restrict__ order) {
  __shared__ int start[kMaxSlices], hist[kMaxSlices];
  for (int s = threadIdx.x; s < slices; s += blockDim.x) {
    start[s] = counts[s];
    hist[s] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive prefix sum: where each slice's part begins
    int sum = 0;
    for (int s = 0; s < slices; ++s) {
      const int c = start[s];
      start[s] = sum;
      sum += c;
    }
  }
  const long long first = (long long)blockIdx.x * kSortThreads * kSortItems;
  int slice_of[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = first + j * kSortThreads + threadIdx.x;
    slice_of[j] = i < groups ? gidx[i] / slice_groups : -1;
    if (slice_of[j] >= 0) atomicAdd(&hist[slice_of[j]], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < slices; s += blockDim.x) {
    if (hist[s]) start[s] += atomicAdd(&cursor[s], hist[s]);
    hist[s] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (slice_of[j] < 0) continue;
    const int s = slice_of[j];
    order[start[s] + atomicAdd(&hist[s], 1)] = (int)(first + j * kSortThreads + threadIdx.x);
  }
}

// Item k = (position k / chunks in the walk, chunk k % chunks of that
// group's span); the walk is `order` (null: the groups in index order).
__global__ void __launch_bounds__(kThreads)
group_gather_kernel(const char* __restrict__ table, const int* __restrict__ gidx,
                    const int* __restrict__ order, char* __restrict__ out, long long items,
                    long long table_groups, long long span, int chunks, int chunk_bytes,
                    int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // one mbarrier per stage
  unsigned char* ring = smem + 256;                     // stages <= 32: 256 B of barriers
  const int lane = threadIdx.x;
  const long long batches = (items + kThreads - 1) / kThreads;
  if (blockIdx.x >= batches) return;

  uint64_t keep = 0, stream = 0;  // L2 policies (lane 0 issues every copy)
  if (lane == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(stream));
  }
  __syncwarp();

  // Lane 0 counts the block's items in `issued`; stores lag loads by `lag`
  // items, so lag + 1 loads are in flight when a store is issued, and a
  // stage is reloaded once its store has read it, with at most one newer
  // store still reading (none when there is one stage).  Each stage keeps
  // the destination and size of the item it holds.
  const int lag = stages >= 2 ? stages - 2 : 0;
  char* dst_of[32] = {};
  uint32_t bytes_of[32] = {};
  long long issued = 0;
  auto store = [&](long long k) {
    const int s = (int)(k % stages);
    mbar_wait(smem_u32(full + s), (uint32_t)((k / stages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
        ::"l"(dst_of[s]), "r"(smem_u32(ring + (size_t)s * chunk_bytes)), "r"(bytes_of[s]),
        "l"(stream)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };

  // the output group and the table group of item `item` (0, 0 past the end)
  auto fetch = [&](long long item, long long& g, long long& src) {
    g = src = 0;
    if (item < items) {
      g = item / chunks;
      if (order != nullptr) g = order[g];
      src = gidx[g];
    }
  };
  long long next_g, next_src;
  fetch((long long)blockIdx.x * kThreads + lane, next_g, next_src);
  for (long long q = blockIdx.x; q < batches; q += gridDim.x) {
    const long long base = q * kThreads, cur_g = next_g, cur_src = next_src;
    fetch(base + (long long)gridDim.x * kThreads + lane, next_g, next_src);  // in flight
    if (base + lane < items && (cur_src < 0 || cur_src >= table_groups)) __trap();
    const int n = items - base < kThreads ? (int)(items - base) : kThreads;
    for (int j = 0; j < n; ++j) {
      const long long g = __shfl_sync(0xffffffffu, cur_g, j);
      const long long src_group = __shfl_sync(0xffffffffu, cur_src, j);
      if (lane == 0) {
        const long long k = issued++;
        const int s = (int)(k % stages);
        if (k >= stages) {  // the stage's previous store must have read it
          if (stages >= 2) bulk_wait_read<1>(); else bulk_wait_read<0>();
        }
        const long long off = ((base + j) % chunks) * (long long)chunk_bytes;
        const uint32_t bytes = (uint32_t)(span - off < chunk_bytes ? span - off : chunk_bytes);
        const uint32_t bar = smem_u32(full + s);
        dst_of[s] = out + g * span + off;
        bytes_of[s] = bytes;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
            " [%0], [%1], %2, [%3], %4;\n"
            ::"r"(smem_u32(ring + (size_t)s * chunk_bytes)), "l"(table + src_group * span + off),
            "r"(bytes), "r"(bar), "l"(keep)
            : "memory");
        if (k >= lag) store(k - lag);
      }
    }
  }
  if (lane == 0) {
    for (long long k = issued > lag ? issued - lag : 0; k < issued; ++k) store(k);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace

// table [table_groups * 8, d] f32, gidx [groups] int32, out [groups * 8, d]
// f32; table and out 16-byte aligned; scratch: order [groups] int32 and
// counts [2 * 1024] int32 (the pre-pass's).  `windows` = the ring's stages
// (groups in flight per block), 1..32.  Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int group_gather_launch(const void* table, const void* gidx, void* out, void* order,
                                   void* counts, long long groups, long long table_groups,
                                   int d, int windows, void* stream) {
  if (groups < 0 || groups > INT32_MAX || table_groups < 1 || d < 1 || windows < 1 ||
      windows > 32 || ((uintptr_t)table % 16) != 0 || ((uintptr_t)out % 16) != 0)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long span = 32LL * d;  // 8 rows x d f32
  const long long stage_max = (kRingBytes / windows) & ~15LL;
  const int chunk_bytes = (int)(span < stage_max ? span : stage_max);
  const int chunks = (int)((span + chunk_bytes - 1) / chunk_bytes);
  const long long items = groups * chunks;
  const int smem = 256 + windows * chunk_bytes;

  // the persistent grid's size for (device, smem), kept from the last call
  thread_local int last_dev = -1, last_smem = -1;
  thread_local long long max_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(group_gather_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_gather_kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks = (long long)sms * (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM);
    last_dev = dev;
    last_smem = smem;
  }

  // the slices of the walk: kSliceBytes of table each, at most kMaxSlices
  long long slice_groups = kSliceBytes / span > 0 ? kSliceBytes / span : 1;
  if ((table_groups + slice_groups - 1) / slice_groups > kMaxSlices)
    slice_groups = (table_groups + kMaxSlices - 1) / kMaxSlices;
  const int slices = (int)((table_groups + slice_groups - 1) / slice_groups);
  const int* walk = nullptr;
  if (slices > 1) {
    int* cnt = (int*)counts;
    err = cudaMemsetAsync(cnt, 0, 2 * kMaxSlices * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const unsigned sort_blocks =
        (unsigned)((groups + kSortThreads * kSortItems - 1) / (kSortThreads * kSortItems));
    slice_count_kernel<<<sort_blocks, kSortThreads, 0, s>>>(
        (const int*)gidx, groups, table_groups, (int)slice_groups, slices, cnt);
    slice_order_kernel<<<sort_blocks, kSortThreads, 0, s>>>(
        (const int*)gidx, groups, (int)slice_groups, slices, cnt, cnt + kMaxSlices,
        (int*)order);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    walk = (const int*)order;
  }
  const long long batches = (items + kThreads - 1) / kThreads;
  const long long blocks = batches < max_blocks ? batches : max_blocks;
  group_gather_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      (const char*)table, (const int*)gidx, walk, (char*)out, items, table_groups, span,
      chunks, chunk_bytes, windows);
  return (int)cudaGetLastError();
}
