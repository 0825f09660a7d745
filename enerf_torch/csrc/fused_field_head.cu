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
// Weights are bias-free.  Every product is accumulated in f32 and the
// activations are rounded to the input type exactly where the JAX
// _head_math rounds them (ops/fused_mlp.py:_head_math is the plain version).
//
// What bounds it on an H100: per sample it reads (E + D) inputs and writes
// 1 + C floats -- 104 bytes at the main path's bf16 widths (E=32, D=16,
// C=1) -- and does 2 * 9216 = 18,432 FLOP.  At B = 131,072 that is 13.6 MB
// and 2.42 GFLOP per launch: 4.1 us of HBM time at 3.35 TB/s against 2.4 us
// of bf16 tensor-core time, so the bound is memory.
//
// bf16 (the only type the --ff path runs): a fully fused head on the tensor
// cores.
//  - Each warp owns 16-sample tiles and runs the five products with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate).  An m16n8 accumulator
//    pair, rounded to packed bf16x2 (with the ReLU, one cvt.rn.relu), is
//    exactly the A fragment of the next m16k16 product, so activations stay
//    in registers from the input tile to the outputs (the scheme of the
//    reference's ffmlp.cu, which uses WMMA).  The layers are 16-64 wide and
//    the bound is bytes, so the warp-level mma serves; wgmma's 64-row tiles
//    would buy tensor rate the kernel cannot use.
//  - Measured on the H100 (PERF.md), the time is a few microseconds of
//    fixed cost plus a rate well under the HBM bound, and neither a deeper
//    input ring, more warps per block nor two m-tiles per warp moved it:
//    the warps' instruction stream (76 mma.sync per 16 samples and their
//    operand loads) is what is left.  So the input widths are template
//    parameters (every offset a constant), two B fragments come per load
//    and the ReLU rides on the bf16 conversion.
//  - The weights come pre-laid-out by the wrapper (ops/fused_mlp.py:
//    pack_head): zero-padded to the mma's K and N, the geo rows of wc0 as a
//    16 x 64 matrix whose row 0 (the sigma column) is zero, C padded to 8,
//    and the B fragments of two n-tiles stored together in lane order, so a
//    lane reads both with one 16-byte shared load and a warp's read is one
//    contiguous 512 B (no bank conflicts).  A persistent block stages them
//    once (19 KB at the main widths) and walks many tiles.
//  - Inputs: each warp copies its next tile's enc and denc rows with
//    cp.async into the other half of a double buffer while it computes the
//    current one, and reads A fragments with ldmatrix; rows are padded by
//    16 bytes so ldmatrix hits 8 different bank groups.  Rows past B are
//    zero-filled and not stored.  enc and denc are 16, 32 or 64 columns
//    (the wrapper zero-pads other widths up to one of these).
//  - The sigma column is set to 0 in the accumulator before it becomes the
//    geo operand (multiplying inf by the zero weight row would give NaN).
//
// f32 (no --ff configuration reaches it): one thread per sample on the CUDA
// cores; all five weight matrices staged per block in shared memory as f32
// and read as broadcasts; the two 64-wide hidden activations in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- f32 kernel

constexpr int kThreadsF32 = 128;

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

template <int HS, int HC>
__global__ void __launch_bounds__(kThreadsF32)
head_f32_kernel(const float* __restrict__ enc, const float* __restrict__ denc,
                const float* __restrict__ ws0, const float* __restrict__ ws1,
                const float* __restrict__ wc0, const float* __restrict__ wc1,
                const float* __restrict__ wc2, float* __restrict__ sigma,
                float* __restrict__ rgb, int B, int E, int D, int G, int C) {
  extern __shared__ float smem_f32[];
  const int S1 = 1 + G;
  float* s_ws0 = smem_f32;              // [E, HS]
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

  const int64_t i = (int64_t)blockIdx.x * kThreadsF32 + threadIdx.x;
  if (i >= B) return;

  // sigma net, layer 0
  float h[HS];
#pragma unroll
  for (int j = 0; j < HS; ++j) h[j] = 0.f;
  const float* e = enc + i * E;
  for (int k = 0; k < E; ++k) {
    const float x = e[k];
    const float* w = s_ws0 + k * HS;
#pragma unroll
    for (int j = 0; j < HS; ++j) h[j] = fmaf(x, w[j], h[j]);
  }
#pragma unroll
  for (int j = 0; j < HS; ++j) h[j] = fmaxf(h[j], 0.f);

  // colour net, layer 0: the direction part, then each geo feature as soon
  // as the sigma net's layer 1 produces it
  float c[HC];
#pragma unroll
  for (int j = 0; j < HC; ++j) c[j] = 0.f;
  const float* de = denc + i * D;
  for (int k = 0; k < D; ++k) {
    const float x = de[k];
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
      const float* w = s_wc0 + (D + o - 1) * HC;
#pragma unroll
      for (int j = 0; j < HC; ++j) c[j] = fmaf(acc, w[j], c[j]);
    }
  }
  sigma[i] = expf(sigma_raw);
#pragma unroll
  for (int j = 0; j < HC; ++j) c[j] = fmaxf(c[j], 0.f);

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
  for (int j = 0; j < HC; ++j) c2[j] = fmaxf(c2[j], 0.f);

  // colour net, layer 2 + sigmoid
  for (int o = 0; o < C; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < HC; ++k) acc = fmaf(c2[k], s_wc2[k * C + o], acc);
    rgb[i * C + o] = 1.f / (1.f + expf(-acc));
  }
}

// --------------------------------------------------------------- bf16 kernel

constexpr int kWarps = 4;   // warps per block
constexpr int kTile = 16;   // samples per warp tile: the mma's M
constexpr int kStages = 2;  // input tiles per warp in shared memory: 1 in flight
constexpr int kRowPad = 8;  // bf16 of padding per staged input row (16 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16 x 16, row) * b (16 x 8, col): bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The A fragment of a 16 x 16 bf16 tile at `tile` (row stride `ld` bf16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int lane) {
  const int m = lane >> 3, r = (lane & 7) + (m & 1) * 8;
  const uint32_t addr = smem_u32(tile + r * ld + (m >> 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Two f32 values rounded to bf16 (nearest even) and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// relu(lo), relu(hi) rounded to bf16 and packed, in one instruction.
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// relu of 8 n-tiles of accumulators, rounded: the A fragments of 4 k-steps.
__device__ __forceinline__ void relu_to_a(uint32_t (&a)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* lo = acc[2 * kk];
    const float* hi = acc[2 * kk + 1];
    a[kk][0] = pack_relu_bf16(lo[0], lo[1]);
    a[kk][1] = pack_relu_bf16(lo[2], lo[3]);
    a[kk][2] = pack_relu_bf16(hi[0], hi[1]);
    a[kk][3] = pack_relu_bf16(hi[2], hi[3]);
  }
}

// The B operands of n-tiles 2p and 2p + 1 (one 16-byte load per lane) into
// two accumulators.
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                     uint4 w) {
  mma(d0, a, make_uint2(w.x, w.y));
  mma(d1, a, make_uint2(w.z, w.w));
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
}

// 16 rows of W bf16 (a multiple of 16) from `src` (row stride W) into `dst`
// (row stride W + kRowPad); rows at or past `rows` zero-fill.
template <int W>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int lane) {
  constexpr int per_row = W / 8, chunks = kTile * per_row;  // 16-byte chunks
#pragma unroll
  for (int q = lane; q < (chunks + 31) / 32 * 32; q += 32) {
    if (chunks % 32 && q >= chunks) break;
    const int r = q / per_row, ch = q % per_row;
    const bool in = r < rows;
    const __nv_bfloat16* s = in ? src + (size_t)r * W + ch * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * (W + kRowPad) + ch * 8)),
                 "l"(s), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// Weight fragments in the order pack_head lays them out: for each layer,
// k-step-major, then pairs of n-tiles with 32 lanes x (2 x uint2) each (one
// n-tile of 32 x uint2 in the last layer).  The input
// widths are template parameters (enc 16 KE, denc 16 KD), so every loop
// unrolls and every shared-memory offset is a constant.
template <int KE, int KD>
__global__ void __launch_bounds__(kWarps * 32)
head_bf16_kernel(const __nv_bfloat16* __restrict__ enc, const __nv_bfloat16* __restrict__ denc,
                 const uint4* __restrict__ frags, float* __restrict__ sigma,
                 float* __restrict__ rgb, int B, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int n_frag = 8 * (KE + KD) + 52;
  const uint4* s_w = reinterpret_cast<const uint4*>(smem);  // 16 per fragment pair
  const uint2* s_w1 = reinterpret_cast<const uint2*>(smem);  // 32 per fragment
  constexpr int E = 16 * KE, D = 16 * KD;
  constexpr int lde = E + kRowPad, ldd = D + kRowPad;
  constexpr int buf_elems = kTile * (lde + ldd);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)n_frag * 256) +
                        (size_t)warp * kStages * buf_elems;

  const int tiles = (B + kTile - 1) / kTile;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  // the warp's i-th tile goes to buffer i % kStages; kStages - 1 are in flight
  auto load = [&](int i) {
    const int t = first + i * stride;
    if (t < tiles) {
      __nv_bfloat16* dst = bufs + (i % kStages) * buf_elems;
      const int rows = B - t * kTile;
      copy_rows<E>(dst, enc + (size_t)t * kTile * E, rows, lane);
      copy_rows<D>(dst + kTile * lde, denc + (size_t)t * kTile * D, rows, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int i = 0; i < kStages - 1; ++i) load(i);

  {  // stage the weights once per block
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < n_frag * 16; i += blockDim.x) dst[i] = frags[i];
  }
  __syncthreads();

  constexpr int F1 = 8 * KE, F2d = F1 + 8, F2g = F2d + 8 * KD, F3 = F2g + 8, F4 = F3 + 32;
  const int g = lane >> 2, t4 = lane & 3;
  for (int i = 0, tile = first; tile < tiles; ++i, tile += stride) {
    load(i + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    const __nv_bfloat16* x_enc = bufs + (i % kStages) * buf_elems;
    const __nv_bfloat16* x_dir = x_enc + kTile * lde;

    // sigma net, layer 0: enc [16, E] @ ws0 [E, 64]
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int ks = 0; ks < KE; ++ks) {
      uint32_t a[4];
      load_a(a, x_enc + ks * 16, lde, lane);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        mma2(acc[2 * p], acc[2 * p + 1], a, s_w[(ks * 8 + 2 * p) * 16 + lane]);
    }
    uint32_t h[4][4];
    relu_to_a(h, acc);

    // sigma net, layer 1: h [16, 64] @ ws1 [64, 16] (sigma + 15 geo)
    float sg[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma2(sg[0], sg[1], h[kk], s_w[(F1 + kk * 2) * 16 + lane]);
    // column 0 is sigma_raw (lanes with t4 == 0, rows g and g + 8): zero it
    // before the geo features become an operand
    const bool col0 = t4 == 0;
    const uint32_t geo[4] = {pack_bf16(col0 ? 0.f : sg[0][0], sg[0][1]),
                             pack_bf16(col0 ? 0.f : sg[0][2], sg[0][3]),
                             pack_bf16(sg[1][0], sg[1][1]), pack_bf16(sg[1][2], sg[1][3])};

    // colour net, layer 0: denc [16, D] @ wc0[:D] + geo16 @ Wgeo
    zero(acc);
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t a[4];
      load_a(a, x_dir + ks * 16, ldd, lane);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        mma2(acc[2 * p], acc[2 * p + 1], a, s_w[(F2d + ks * 8 + 2 * p) * 16 + lane]);
    }
    __syncwarp();  // every lane has read this buffer: a later load may refill it
#pragma unroll
    for (int p = 0; p < 4; ++p)
      mma2(acc[2 * p], acc[2 * p + 1], geo, s_w[(F2g + 2 * p) * 16 + lane]);
    uint32_t c[4][4];
    relu_to_a(c, acc);

    // colour net, layer 1: [16, 64] @ [64, 64]
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        mma2(acc[2 * p], acc[2 * p + 1], c[kk], s_w[(F3 + kk * 8 + 2 * p) * 16 + lane]);
    relu_to_a(c, acc);

    // colour net, layer 2: [16, 64] @ [64, 8] (C padded to 8)
    float o[4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma(o, c[kk], s_w1[(F4 + kk) * 32 + lane]);

    const int r0 = tile * kTile + g, r1 = r0 + 8;
    if (col0) {
      if (r0 < B) sigma[r0] = expf(sg[0][0]);
      if (r1 < B) sigma[r1] = expf(sg[0][2]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 2 * t4 + j;
      if (col < C) {
        if (r0 < B) rgb[(size_t)r0 * C + col] = 1.f / (1.f + expf(-o[j]));
        if (r1 < B) rgb[(size_t)r1 * C + col] = 1.f / (1.f + expf(-o[2 + j]));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int KE, int KD>
int launch_bf16(const void* enc, const void* denc, const void* frags, void* sigma, void* rgb,
                int B, int C, cudaStream_t stream) {
  auto kernel = head_bf16_kernel<KE, KD>;
  constexpr size_t smem = (8 * (KE + KD) + 52) * 256 +
      sizeof(__nv_bfloat16) * kWarps * kStages * kTile * (16 * (KE + KD) + 2 * kRowPad);
  // the persistent grid's size on the device, kept from the last call
  thread_local int last_dev = -1;
  thread_local long long cap = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev) {
    int err = set_smem((const void*)kernel, smem);
    if (err) return err;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cap = (long long)sms * per_sm;
    last_dev = dev;
  }
  const long long tiles = ((long long)B + kTile - 1) / kTile;
  const long long need = (tiles + kWarps - 1) / kWarps;
  kernel<<<(unsigned)(need < cap ? need : cap), kWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)enc, (const __nv_bfloat16*)denc, (const uint4*)frags,
      (float*)sigma, (float*)rgb, B, C);
  return (int)cudaGetLastError();
}

template <int KE>
int launch_bf16_kd(int KD, const void* enc, const void* denc, const void* frags, void* sigma,
                   void* rgb, int B, int C, cudaStream_t stream) {
  switch (KD) {
    case 1: return launch_bf16<KE, 1>(enc, denc, frags, sigma, rgb, B, C, stream);
    case 2: return launch_bf16<KE, 2>(enc, denc, frags, sigma, rgb, B, C, stream);
    case 4: return launch_bf16<KE, 4>(enc, denc, frags, sigma, rgb, B, C, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f32 operands; hidden_sigma / hidden_color must be 64 (the instantiated
// widths).  Returns a cudaError_t (0 on success).
extern "C" int fused_field_head_f32_launch(const void* enc, const void* denc, const void* ws0,
                                           const void* ws1, const void* wc0, const void* wc1,
                                           const void* wc2, void* sigma, void* rgb, int B,
                                           int E, int D, int G, int hidden_sigma,
                                           int hidden_color, int C, void* stream) {
  constexpr int HS = 64, HC = 64;
  if (hidden_sigma != HS || hidden_color != HC || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = sizeof(float) *
      ((size_t)E * HS + (size_t)HS * (1 + G) + (size_t)(D + G) * HC + (size_t)HC * HC +
       (size_t)HC * C);
  auto kernel = head_f32_kernel<HS, HC>;
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  const unsigned blocks = (unsigned)((B + kThreadsF32 - 1) / kThreadsF32);
  kernel<<<blocks, kThreadsF32, smem, (cudaStream_t)stream>>>(
      (const float*)enc, (const float*)denc, (const float*)ws0, (const float*)ws1,
      (const float*)wc0, (const float*)wc1, (const float*)wc2, (float*)sigma, (float*)rgb,
      B, E, D, G, C);
  return (int)cudaGetLastError();
}

// bf16: enc [B, 16 KE], denc [B, 16 KD] (16-byte aligned, zero-padded by the
// wrapper), KE and KD in {1, 2, 4}; frags = pack_head's fragments
// (8 (KE + KD) + 52 of 256 bytes); C in {1, 3}.  Returns a cudaError_t (0 on
// success).
extern "C" int fused_field_head_bf16_launch(const void* enc, const void* denc,
                                            const void* frags, void* sigma, void* rgb, int B,
                                            int KE, int KD, int C, void* stream) {
  if (B < 0 || C < 1 || C > 8 || ((uintptr_t)enc % 16) != 0 ||
      ((uintptr_t)denc % 16) != 0 || ((uintptr_t)frags % 16) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (KE) {
    case 1: return launch_bf16_kd<1>(KD, enc, denc, frags, sigma, rgb, B, C, s);
    case 2: return launch_bf16_kd<2>(KD, enc, denc, frags, sigma, rgb, B, C, s);
    case 4: return launch_bf16_kd<4>(KD, enc, denc, frags, sigma, rgb, B, C, s);
  }
  return (int)cudaErrorInvalidValue;
}
