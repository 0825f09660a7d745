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
// What bounds it on an H100: it reads 36 bytes per pair (rid 4, lo 12,
// frac 12, g 8) and writes the table gradient once (97,827 rows x 250 f32 =
// 97.8 MB at 16 x 2 levels, block 4).  At the main path's 2,097,152 pairs
// per render that is 75.5 MB + 97.8 MB: 52 us at 3.35 TB/s.  There is no
// arithmetic to speak of (8 weights, 16 products per pair).
//
// Design: one thread per pair, 16 f32 atomicAdds into the flat
// [total_rows, 2 * row_cells] gradient (the compiler emits RED, as the
// results are unused).  The TPU kernel's per-level VMEM accumulator and its
// serial row loop do not carry over: blocks run in parallel here, and the
// L2 takes the atomics.  There are no padded lanes, no rows_max rounding
// and no depad.  Pairs with g = 0 (out-of-box samples) add nothing and
// return early.  The dense coarse levels concentrate their adds on a few
// hundred rows (level 0: 125 rows x 1 KB), so those atomics contend;
// accumulating them in shared memory first is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
block_table_grad_kernel(const int* __restrict__ rid, const int* __restrict__ lo,
                        const float* __restrict__ frac, const float* __restrict__ g,
                        float* __restrict__ grad, long long pairs, int halo,
                        int row_cells) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= pairs) return;
  const float g0 = g[2 * i], g1 = g[2 * i + 1];
  if (g0 == 0.0f && g1 == 0.0f) return;
  const int lx = lo[3 * i], ly = lo[3 * i + 1], lz = lo[3 * i + 2];
  const float fx = frac[3 * i], fy = frac[3 * i + 1], fz = frac[3 * i + 2];
  const float wxs[2] = {1.0f - fx, fx};
  const float wys[2] = {1.0f - fy, fy};
  const float wzs[2] = {1.0f - fz, fz};
  float* row = grad + (size_t)rid[i] * (size_t)(2 * row_cells);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = __fmul_rn(wxs[dx], wys[dy]);
      const int pxy = ((lx + dx) * halo + (ly + dy)) * halo + lz;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(wxy, wzs[dz]);
        atomicAdd(row + pxy + dz, __fmul_rn(g0, w));
        atomicAdd(row + row_cells + pxy + dz, __fmul_rn(g1, w));
      }
    }
  }
}

}  // namespace

// rid [pairs] int32 global row ids; lo [pairs, 3] int32; frac [pairs, 3],
// g [pairs, 2] f32; grad [total_rows, 2 * row_cells] f32, zeroed here on
// `stream` before the launch.  Returns a cudaError_t (0 on success).
extern "C" int block_table_grad_launch(const void* rid, const void* lo, const void* frac,
                                       const void* g, void* grad, long long pairs,
                                       long long total_rows, int halo, int row_cells,
                                       void* stream) {
  if (pairs < 0 || total_rows < 0 || halo < 2 || row_cells != halo * halo * halo)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      grad, 0, sizeof(float) * (size_t)total_rows * (size_t)(2 * row_cells), s);
  if (err != cudaSuccess || pairs == 0) return (int)err;
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  block_table_grad_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int*)rid, (const int*)lo, (const float*)frac, (const float*)g, (float*)grad,
      pairs, halo, row_cells);
  return (int)cudaGetLastError();
}
