// 8-row group gather for Hopper (sm_90a): out[8i + r, :] = table[8 gidx[i] + r, :].
//
// Replaces scripts/bench_gather.py:make_group_gather.kernel, the Pallas TPU
// kernel of the random-row gather microbenchmark.  On the TPU, Mosaic only
// slices device memory in (8, 128) tiles, so the smallest random read is an
// 8-row group, copied by a W-deep window of async DMAs into VMEM.
//
// Here a group is one contiguous span of 8 * D f32 = 32 * D bytes, which is
// a multiple of 16 bytes for every D; with a 16-byte aligned table and
// output (the wrapper checks it) the span is 2 * D float4s.  So the kernel is
// a plain vectorised copy: one warp per group, each lane moving float4s at a
// stride of 32, up to kUnroll loads in flight before their stores.  `windows`
// warps share a block, so a block keeps `windows` groups in flight: the
// TPU's DMA window becomes the number of warps per block.  There are no
// semaphores and no staging in shared memory: the loads go through L1/L2 to
// registers and straight out again.
//
// What bounds it on an H100: bytes.  Each group is read once and written
// once (plus 4 bytes of index), with no arithmetic; at the benchmark's
// defaults (262,144 groups of 8 x 128 f32) that is 2 x 1.07 GB = 0.64 ms at
// 3.35 TB/s.  Random 4 KB spans are long enough for full DRAM bursts, so
// the gather can in principle stream near the copy rate; TMA bulk copies
// (cp.async.bulk) of the spans are later work.
//
// An index outside [0, table_groups) traps, like PyTorch's device-side
// index assert: the launch's stream then reports an error at the next sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 4;

__global__ void group_gather_kernel(const float4* __restrict__ table,
                                    const int* __restrict__ gidx,
                                    float4* __restrict__ out, long long groups,
                                    long long table_groups, int span4) {
  const long long g = (long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (g >= groups) return;
  const int lane = threadIdx.x % kWarp;
  const long long src_group = gidx[g];
  if (src_group < 0 || src_group >= table_groups) __trap();
  const float4* src = table + src_group * span4;
  float4* dst = out + g * span4;
  for (int base = lane; base < span4; base += kWarp * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kWarp;
      if (j < span4) v[u] = src[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kWarp;
      if (j < span4) dst[j] = v[u];
    }
  }
}

}  // namespace

// table [table_groups * 8, d] f32, gidx [groups] int32, out [groups * 8, d]
// f32; table and out 16-byte aligned.  `windows` groups (warps) per block,
// 1..32.  Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int group_gather_launch(const void* table, const void* gidx, void* out,
                                   long long groups, long long table_groups, int d,
                                   int windows, void* stream) {
  if (groups < 0 || table_groups < 1 || d < 1 || windows < 1 || windows > 32 ||
      ((uintptr_t)table % 16) != 0 || ((uintptr_t)out % 16) != 0)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const int span4 = 2 * d;  // 8 rows x d f32 = 2d float4s
  const long long blocks = (groups + windows - 1) / windows;
  group_gather_kernel<<<(unsigned)blocks, windows * kWarp, 0, (cudaStream_t)stream>>>(
      (const float4*)table, (const int*)gidx, (float4*)out, groups, table_groups, span4);
  return (int)cudaGetLastError();
}
