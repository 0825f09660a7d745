// Fused field head for Hopper (sm_90a): the whole sigma + colour MLP of the
// --ff backbone in one kernel.
//
// Replaces enerf_tpu/ops/fused_mlp.py:_kernel (the Pallas TPU kernel behind
// fused_field_head).  Per sample:
//   h   = relu(enc @ ws0)            -> rounded to the input type
//   sg  = h @ ws1                    sigma = exp(sg[0])
//   geo = sg[1:]                     -> rounded to the input type
//   c   = relu([denc, geo] @ wc0)    -> rounded
//   c   = relu(c @ wc1)              -> rounded
//   rgb = sigmoid(c @ wc2)
// Weights are bias-free.  Inputs are bf16 or f32, every product is
// accumulated in f32, and activations are rounded to the input type exactly
// where the JAX _head_math rounds them, so the kernel and the plain PyTorch
// version (ops/fused_mlp.py:_head_math) agree.
//
// What bounds it on an H100: per sample it reads (E + D) inputs and writes
// 1 + C floats -- 104 bytes at the main path's bf16 widths (E=32, D=16,
// C=1) -- and does 2 * 9216 = 18,432 FLOP.  At B = 131,072 that is 13.6 MB
// and 2.42 GFLOP per launch: 4.1 us of HBM time at 3.35 TB/s against 2.4 us
// of bf16 tensor-core time, so the bound is memory.  This first version runs
// on the CUDA cores in f32 (67 TFLOP/s: 36 us of arithmetic), so it sits
// well above that bound; tensor cores (wgmma) and TMA-staged input tiles are
// later work.
//
// Design: one thread per sample.  All five weight matrices are staged once
// per block into shared memory as f32 (9,216 values, 36 KB at the main
// widths); every thread of a warp reads the same weight address, so the
// reads are broadcasts without bank conflicts.  The two 64-wide hidden
// activations live in registers (the hidden widths are template
// parameters, so the activation arrays are fully unrolled); the input
// widths E, D, G and the output width C are runtime values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an f32 activation to the input type (identity for f32 inputs).
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = to_f32(src[k]);
}

constexpr int kThreads = 128;

template <typename T, int HS, int HC>
__global__ void __launch_bounds__(kThreads)
fused_field_head_kernel(const T* __restrict__ enc, const T* __restrict__ denc,
                        const T* __restrict__ ws0, const T* __restrict__ ws1,
                        const T* __restrict__ wc0, const T* __restrict__ wc1,
                        const T* __restrict__ wc2, float* __restrict__ sigma,
                        float* __restrict__ rgb, int B, int E, int D, int G, int C) {
  extern __shared__ float smem[];
  const int S1 = 1 + G;
  float* s_ws0 = smem;                  // [E, HS]
  float* s_ws1 = s_ws0 + E * HS;        // [HS, 1 + G]
  float* s_wc0 = s_ws1 + HS * S1;       // [D + G, HC]
  float* s_wc1 = s_wc0 + (D + G) * HC;  // [HC, HC]
  float* s_wc2 = s_wc1 + HC * HC;       // [HC, C]
  stage(s_ws0, ws0, E * HS);
  stage(s_ws1, ws1, HS * S1);
  stage(s_wc0, wc0, (D + G) * HC);
  stage(s_wc1, wc1, HC * HC);
  stage(s_wc2, wc2, HC * C);
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;

  // sigma net, layer 0
  float h[HS];
#pragma unroll
  for (int j = 0; j < HS; ++j) h[j] = 0.f;
  const T* e = enc + i * E;
  for (int k = 0; k < E; ++k) {
    const float x = to_f32(e[k]);
    const float* w = s_ws0 + k * HS;
#pragma unroll
    for (int j = 0; j < HS; ++j) h[j] = fmaf(x, w[j], h[j]);
  }
#pragma unroll
  for (int j = 0; j < HS; ++j) h[j] = round_as<T>(fmaxf(h[j], 0.f));

  // colour net, layer 0: the direction part, then each geo feature as soon
  // as the sigma net's layer 1 produces it
  float c[HC];
#pragma unroll
  for (int j = 0; j < HC; ++j) c[j] = 0.f;
  const T* de = denc + i * D;
  for (int k = 0; k < D; ++k) {
    const float x = to_f32(de[k]);
    const float* w = s_wc0 + k * HC;
#pragma unroll
    for (int j = 0; j < HC; ++j) c[j] = fmaf(x, w[j], c[j]);
  }
  float sigma_raw = 0.f;
  for (int o = 0; o < S1; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < HS; ++k) acc = fmaf(h[k], s_ws1[k * S1 + o], acc);
    if (o == 0) {
      sigma_raw = acc;
    } else {
      const float g = round_as<T>(acc);
      const float* w = s_wc0 + (D + o - 1) * HC;
#pragma unroll
      for (int j = 0; j < HC; ++j) c[j] = fmaf(g, w[j], c[j]);
    }
  }
  sigma[i] = expf(sigma_raw);
#pragma unroll
  for (int j = 0; j < HC; ++j) c[j] = round_as<T>(fmaxf(c[j], 0.f));

  // colour net, layer 1
  float c2[HC];
#pragma unroll
  for (int j = 0; j < HC; ++j) c2[j] = 0.f;
#pragma unroll
  for (int k = 0; k < HC; ++k) {
    const float x = c[k];
    const float* w = s_wc1 + k * HC;
#pragma unroll
    for (int j = 0; j < HC; ++j) c2[j] = fmaf(x, w[j], c2[j]);
  }
#pragma unroll
  for (int j = 0; j < HC; ++j) c2[j] = round_as<T>(fmaxf(c2[j], 0.f));

  // colour net, layer 2 + sigmoid
  for (int o = 0; o < C; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < HC; ++k) acc = fmaf(c2[k], s_wc2[k * C + o], acc);
    rgb[i * C + o] = 1.f / (1.f + expf(-acc));
  }
}

template <typename T>
int launch(const void* enc, const void* denc, const void* ws0, const void* ws1,
           const void* wc0, const void* wc1, const void* wc2, float* sigma,
           float* rgb, int B, int E, int D, int G, int C, cudaStream_t stream) {
  constexpr int HS = 64, HC = 64;
  const size_t smem = sizeof(float) *
      ((size_t)E * HS + (size_t)HS * (1 + G) + (size_t)(D + G) * HC +
       (size_t)HC * HC + (size_t)HC * C);
  auto kernel = fused_field_head_kernel<T, HS, HC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, stream>>>(
      (const T*)enc, (const T*)denc, (const T*)ws0, (const T*)ws1,
      (const T*)wc0, (const T*)wc1, (const T*)wc2, sigma, rgb, B, E, D, G, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hidden_sigma / hidden_color must be 64
// (the only instantiated widths).  Returns a cudaError_t (0 on success).
extern "C" int fused_field_head_launch(int dtype, const void* enc, const void* denc,
                                       const void* ws0, const void* ws1,
                                       const void* wc0, const void* wc1,
                                       const void* wc2, void* sigma, void* rgb,
                                       int B, int E, int D, int G, int hidden_sigma,
                                       int hidden_color, int C, void* stream) {
  if (hidden_sigma != 64 || hidden_color != 64 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(enc, denc, ws0, ws1, wc0, wc1, wc2, (float*)sigma,
                         (float*)rgb, B, E, D, G, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(enc, denc, ws0, ws1, wc0, wc1, wc2, (float*)sigma,
                                 (float*)rgb, B, E, D, G, C, s);
  return (int)cudaErrorInvalidValue;
}
