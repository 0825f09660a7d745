// Hash-grid encode for Hopper (sm_90a): kernel pair H1, the forward and its
// table VJP.
//
// Replaces no Pallas kernel: enerf_tpu/ops/hashgrid.py:hash_encode is plain
// jnp.  The port's plain version (enerf_torch/ops/hashgrid.py:hash_address,
// encode_from_address, table_grad_from_address) writes every intermediate to
// device memory: an int64 cell index, int64 temporaries per corner, the
// stacked [N, L, 2^D] rows and weights, which the autograd node kept for the
// backward (1 KiB a sample at 16 levels), a gathered term per corner.  H1
// keeps the address step in registers, in the shape of torch-ngp's
// gridencoder.cu and tiny-cuda-nn:
//   - H1.fwd (hash_encode_fwd_kernel): positions x01 [N, D] and the table
//     [rows, C] -> the encoding [N, L * C]; nothing else is written;
//   - H1.bwd (hash_encode_bwd_kernel): the same positions and the output
//     gradient g [N, L * C] -> scatter-adds w * g into the table gradient
//     [rows, C]; the addresses are recomputed, never read.
//
// The address step, per sample and level: pos = x * scale + 0.5, cell =
// floor(pos), frac = pos - cell; corner c takes bit d of c as its offset
// along axis d, its weight is the product over d of frac or 1 - frac in
// axis order; its row is the uint32 spatial hash x ^ y * 2654435761 ^ z *
// 805459861 on a hashed level, else the uint32 dense index sum cell_d *
// stride_d, modulo the level's size, plus its offset.  uint32 products and
// sums wrap as the plain version's int64 arithmetic masked to 32 bits does.
//
// Bit-equality of H1.fwd with the plain version: every rounded operation is
// the one PyTorch's kernels compute, in the same order -- the scaled position
// a product, then a sum; each corner's weight its factors multiplied in axis
// order; the blend the corners' products summed from corner 0 up.  nvcc
// contracts a * b + c into an FMA by default, so every product and sum is
// written with __fmul_rn / __fadd_rn / __fsub_rn.  Samples outside [0, 1]^D
// write 0 (a NaN position is not outside, as in the plain version).  H1.bwd
// adds the plain version's addends w * g, in another order (atomics).
//
// What bounds it on an H100: the roofline counts the positions and the
// output once and the table once (benchmark/work.py): 140 B a sample at
// 16 levels x 2 channels, 0.45 ms for one render of 10.3 M samples.  The
// work is 2^D scattered row gathers (8 B each at C = 2) a sample and level:
// at the published 16 x 2 grid at 2^19, 1.3 G gathers a render from a
// 48.3 MiB table, about the card's 50 MB L2.  So the forward is bound by
// L2 sector traffic (a 32 B sector per 8 B gather where neighbouring
// samples do not share it), the backward by the same number of L2 atomics.
// The design:
//   - A block holds 32 consecutive samples (a lane each) and kWarps
//     warps, each on its own levels.  The samples of a ray are
//     consecutive, so at the coarse levels the 32 lanes of a warp gather
//     from the same few cells: one load instruction touches few sectors
//     and L1 serves the rest.  Each lane issues its 2^D gathers before it
//     blends, so 2^D loads are in flight a thread.
//   - The output [N, L * C] is staged in shared memory (a row pitch of
//     L * C | 1 floats: the lanes of a warp write to distinct banks) and
//     stored by the whole block as one contiguous run, with streaming
//     stores that do not push the table out of L2.  A warp per level
//     storing its own 8 B would cost a 32 B sector a store.
//   - The backward stages the block's g rows the same way (one coalesced
//     read), and before its atomics a warp merges the addends of lanes
//     that hit the same row as their left neighbour (the consecutive
//     samples of a ray in one coarse cell): one segmented sum over the
//     warp, one atomic a run.  A warp whose lanes all hit distinct rows
//     (the fine levels) skips the merge.  C = 2 rows take one 8-byte
//     vector atomic (sm_90's float2 atomicAdd on global memory).  At one
//     render of the published grid (16 warps a block) the VJP took
//     17.24 ms without the merge and 17.39 ms with two scalar atomics a
//     row, 11.44 ms with both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kSamples = 32;  // samples a block: one a lane
// warps a block, each on its own levels (a level a warp, looping over the
// rest); measured at one render of the published grid (PERF.md): the
// forward takes 3.85 ms with 8 (two levels a warp), 4.31 with 16 and 3.91
// with 4; the VJP 11.52-11.57 ms with 8 and 11.44 with 16, within noise
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoRow = 0xffffffffu;  // a lane with nothing to add
constexpr unsigned kPrime1 = 2654435761u, kPrime2 = 805459861u;

// Per-level constants, passed by value (a kernel parameter, 776 bytes).
struct Levels {
  int count;
  unsigned hashed;  // bit l: level l takes the spatial hash
  float scale[kMaxLevels];
  unsigned size[kMaxLevels];
  unsigned offset[kMaxLevels];
  unsigned stride[kMaxLevels][3];
};

// One level's address step for one sample: cell and fraction per axis.
template <int D>
struct Cell {
  unsigned pg[D];
  float frac[D], rest[D];  // frac and 1 - frac
};

template <int D>
__device__ __forceinline__ Cell<D> cell_of(const float* p, float scale) {
  Cell<D> c;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fadd_rn(__fmul_rn(p[d], scale), 0.5f);
    const float f = floorf(pos);
    c.frac[d] = __fsub_rn(pos, f);
    c.rest[d] = __fsub_rn(1.0f, c.frac[d]);
    c.pg[d] = (unsigned)f;
  }
  return c;
}

template <int D>
__device__ __forceinline__ float corner_weight(const Cell<D>& c, int corner) {
  float w = (corner & 1) ? c.frac[0] : c.rest[0];
#pragma unroll
  for (int d = 1; d < D; ++d) w = __fmul_rn(w, ((corner >> d) & 1) ? c.frac[d] : c.rest[d]);
  return w;
}

// A level's row rule, read once a level (warp-uniform).
template <int D>
struct Rule {
  bool hashed;
  unsigned size, offset, stride[D];
};

template <int D>
__device__ __forceinline__ Rule<D> rule_of(const Levels& lv, int l) {
  Rule<D> r;
  r.hashed = (lv.hashed >> l) & 1u;
  r.size = lv.size[l];
  r.offset = lv.offset[l];
#pragma unroll
  for (int d = 0; d < D; ++d) r.stride[d] = lv.stride[l][d];
  return r;
}

template <int D>
__device__ __forceinline__ unsigned corner_row(const Cell<D>& c, const Rule<D>& r, int corner) {
  unsigned idx;
  if (r.hashed) {
    idx = c.pg[0] + (corner & 1);
#pragma unroll
    for (int d = 1; d < D; ++d)
      idx ^= (c.pg[d] + ((corner >> d) & 1)) * (d == 1 ? kPrime1 : kPrime2);
  } else {
    idx = (c.pg[0] + (corner & 1)) * r.stride[0];
#pragma unroll
    for (int d = 1; d < D; ++d) idx += (c.pg[d] + ((corner >> d) & 1)) * r.stride[d];
  }
  // idx % size: a mask for the hashed levels' powers of two; a dense
  // index that spans every axis is below the size already
  const unsigned wrapped = (r.size & (r.size - 1)) == 0 ? (idx & (r.size - 1))
                           : idx < r.size               ? idx
                                                        : idx % r.size;
  return wrapped + r.offset;
}

template <int C>
struct Row {
  float v[C];
};

template <int C>
__device__ __forceinline__ Row<C> load_row(const float* __restrict__ table, unsigned row) {
  Row<C> out;
  const float* p = table + (size_t)row * C;
  if constexpr (C == 1) {
    out.v[0] = __ldg(p);
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    out.v[0] = t.x;
    out.v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
      out.v[k] = t.x;
      out.v[k + 1] = t.y;
      out.v[k + 2] = t.z;
      out.v[k + 3] = t.w;
    }
  }
  return out;
}

// A row's addends in sm_90's vector atomics on global memory (float2, float4)
template <int C>
__device__ __forceinline__ void atomic_add_row(float* dst, const float* v) {
  if constexpr (C == 1) {
    atomicAdd(dst, v[0]);
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < C; k += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  }
}

// Add v into row `row` of grad for each lane of the warp (kNoRow: none).
// Lanes that repeat their left neighbour's row first hand their addends to
// the first lane of their run (a segmented suffix sum), which adds the
// run's sum once.
template <int C>
__device__ __forceinline__ void scatter_row(float* __restrict__ grad, unsigned row, float* v,
                                            int lane) {
  const unsigned left = __shfl_up_sync(kFull, row, 1);
  const bool head = lane == 0 || left != row;
  const unsigned heads = __ballot_sync(kFull, head);
  if (heads != kFull) {
    const unsigned later = lane == 31 ? 0u : heads & (kFull << (lane + 1));
    const int end = later ? __ffs(later) - 2 : 31;  // the last lane of this lane's run
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float o = __shfl_down_sync(kFull, v[k], off);
        if (lane + off <= end) v[k] = __fadd_rn(v[k], o);
      }
    }
    if (!head) return;
  }
  if (row != kNoRow) atomic_add_row<C>(grad + (size_t)row * C, v);
}

template <int D>
__device__ __forceinline__ bool load_position(const float* __restrict__ x, long long i, float* p) {
  bool outside = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    p[d] = x[i * D + d];
    outside |= (p[d] < 0.0f) || (p[d] > 1.0f);
  }
  return outside;
}

template <int D, int C>
__global__ void __launch_bounds__(kSamples * kWarps, 2)
    hash_encode_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                           float* __restrict__ out, long long n, const Levels lv) {
  constexpr int kCorners = 1 << D;
  extern __shared__ float tile[];  // [kSamples][pitch]
  const int width = lv.count * C, pitch = width | 1;
  const long long first = (long long)blockIdx.x * kSamples;
  const int rows = (int)min((long long)kSamples, n - first);
  const int s = threadIdx.x;
  if (s < rows) {
    float p[D];
    const bool outside = load_position<D>(x, first + s, p);
    for (int l = threadIdx.y; l < lv.count; l += blockDim.y) {
      float acc[C];
      if (outside) {
#pragma unroll
        for (int k = 0; k < C; ++k) acc[k] = 0.0f;
      } else {
        const Cell<D> c = cell_of<D>(p, lv.scale[l]);
        const Rule<D> r = rule_of<D>(lv, l);
        Row<C> vals[kCorners];
#pragma unroll
        for (int corner = 0; corner < kCorners; ++corner)
          vals[corner] = load_row<C>(table, corner_row<D>(c, r, corner));
#pragma unroll
        for (int corner = 0; corner < kCorners; ++corner) {
          const float w = corner_weight<D>(c, corner);
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const float term = __fmul_rn(w, vals[corner].v[k]);
            acc[k] = corner == 0 ? term : __fadd_rn(acc[k], term);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < C; ++k) tile[s * pitch + l * C + k] = acc[k];
    }
  }
  __syncthreads();
  float* dst = out + first * width;
  const int total = rows * width, threads = blockDim.x * blockDim.y;
  for (int e = threadIdx.y * blockDim.x + s; e < total; e += threads)
    __stcs(dst + e, tile[(e / width) * pitch + e % width]);
}

template <int D, int C>
__global__ void __launch_bounds__(kSamples * kWarps, 2)
    hash_encode_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           float* __restrict__ grad, long long n, const Levels lv) {
  constexpr int kCorners = 1 << D;
  extern __shared__ float tile[];  // [kSamples][pitch]
  const int width = lv.count * C, pitch = width | 1;
  const long long first = (long long)blockIdx.x * kSamples;
  const int rows = (int)min((long long)kSamples, n - first);
  const float* src = g + first * width;
  const int total = rows * width, threads = blockDim.x * blockDim.y;
  for (int e = threadIdx.y * blockDim.x + threadIdx.x; e < total; e += threads)
    tile[(e / width) * pitch + e % width] = __ldcs(src + e);
  __syncthreads();
  const int s = threadIdx.x;
  float p[D];
  bool live = s < rows;
  if (live) {
    live = !load_position<D>(x, first + s, p);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = 0.0f;
  }
  // every lane of a warp runs each level (scatter_row's shuffles)
  for (int l = threadIdx.y; l < lv.count; l += blockDim.y) {
    float gl[C];
#pragma unroll
    for (int k = 0; k < C; ++k) gl[k] = live ? tile[s * pitch + l * C + k] : 0.0f;
    const Cell<D> c = cell_of<D>(p, lv.scale[l]);
    const Rule<D> r = rule_of<D>(lv, l);
#pragma unroll
    for (int corner = 0; corner < kCorners; ++corner) {
      const unsigned row = live ? corner_row<D>(c, r, corner) : kNoRow;
      const float w = corner_weight<D>(c, corner);
      float v[C];
#pragma unroll
      for (int k = 0; k < C; ++k) v[k] = __fmul_rn(w, gl[k]);
      scatter_row<C>(grad, row, v, s);
    }
  }
}

template <int D, int C>
int launch(bool backward, const float* x, const float* src, float* dst, long long n,
           const Levels& lv, cudaStream_t stream) {
  const dim3 block(kSamples, lv.count < kWarps ? lv.count : kWarps);
  const unsigned blocks = (unsigned)((n + kSamples - 1) / kSamples);
  const size_t smem = (size_t)kSamples * ((lv.count * C) | 1) * sizeof(float);  // <= 33 KB
  if (backward)
    hash_encode_bwd_kernel<D, C><<<blocks, block, smem, stream>>>(x, src, dst, n, lv);
  else
    hash_encode_fwd_kernel<D, C><<<blocks, block, smem, stream>>>(x, src, dst, n, lv);
  return (int)cudaGetLastError();
}

template <int D>
int launch_c(bool backward, int channels, const float* x, const float* src, float* dst,
             long long n, const Levels& lv, cudaStream_t stream) {
  switch (channels) {
    case 1: return launch<D, 1>(backward, x, src, dst, n, lv, stream);
    case 2: return launch<D, 2>(backward, x, src, dst, n, lv, stream);
    case 4: return launch<D, 4>(backward, x, src, dst, n, lv, stream);
    case 8: return launch<D, 8>(backward, x, src, dst, n, lv, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_any(bool backward, const void* x, const void* src, void* dst, long long n, int dims,
               int channels, int levels, const float* scales, const unsigned* strides,
               const unsigned* sizes, const unsigned* offsets, unsigned hashed, void* stream) {
  // the table's rows are read and the gradient's rows added as vectors
  const void* rows = backward ? dst : src;
  if (n < 0 || levels < 1 || levels > kMaxLevels || (dims != 2 && dims != 3) ||
      ((uintptr_t)rows % 16) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Levels lv{};
  lv.count = levels;
  lv.hashed = hashed;
  for (int l = 0; l < levels; ++l) {
    lv.scale[l] = scales[l];
    lv.size[l] = sizes[l];
    lv.offset[l] = offsets[l];
    if (sizes[l] == 0) return (int)cudaErrorInvalidValue;
    for (int d = 0; d < dims; ++d) lv.stride[l][d] = strides[l * dims + d];
  }
  const float* xf = (const float*)x;
  const float* sf = (const float*)src;
  float* df = (float*)dst;
  cudaStream_t st = (cudaStream_t)stream;
  return dims == 2 ? launch_c<2>(backward, channels, xf, sf, df, n, lv, st)
                   : launch_c<3>(backward, channels, xf, sf, df, n, lv, st);
}

}  // namespace

// H1.fwd: out [n, levels * channels] from x01 [n, dims] and table [rows, channels].
extern "C" int hash_encode_forward_launch(const void* x, const void* table, void* out, long long n,
                                          int dims, int channels, int levels, const float* scales,
                                          const unsigned* strides, const unsigned* sizes,
                                          const unsigned* offsets, unsigned hashed, void* stream) {
  return launch_any(false, x, table, out, n, dims, channels, levels, scales, strides, sizes,
                    offsets, hashed, stream);
}

// H1.bwd: adds into grad [rows, channels] (zeroed by the caller) from x01
// [n, dims] and the output gradient g [n, levels * channels].
extern "C" int hash_encode_backward_launch(const void* x, const void* g, void* grad, long long n,
                                           int dims, int channels, int levels, const float* scales,
                                           const unsigned* strides, const unsigned* sizes,
                                           const unsigned* offsets, unsigned hashed, void* stream) {
  return launch_any(true, x, g, grad, n, dims, channels, levels, scales, strides, sizes, offsets,
                    hashed, stream);
}
