// Occupancy march for Hopper (sm_90a): kernel M1, one thread per ray.
//
// Replaces the device loop of enerf_tpu/render/march.py:march_rays, a
// lax.while_loop of empty-space skips (:174) inside a lax.scan over the
// sample slots or the K-sample emission blocks (:208, :227); it is not a
// Pallas kernel.  Its plain version is enerf_torch/render/march.py:_march,
// which runs the same loops over the whole batch in PyTorch and asks the
// host after every skip iteration whether any ray is still active.  This
// kernel walks each ray in registers instead, so the march needs no host
// sync and a training step can be captured in a CUDA graph.
//
// Why per-ray termination is exact: in the plain version a ray takes part
// in a skip iteration only while it is active (live, t < far, not yet
// found); an inactive ray's t, found, dt and cell exit never change again
// within that skip loop, because `live` is fixed there and t only moves
// while active.  So the batch loop that runs until no ray is active, at
// most SKIP_ITERS times, gives each ray exactly what a loop of its own
// gives when it stops at its own first inactive iteration, at most
// SKIP_ITERS times.  The emission blocks (or sample slots) run for every
// ray, live or not, as in the plain version, which writes t + k dt_min for
// the slots of a dead ray too.
//
// Bit-equality with the plain version on the card: every operation below
// is the one the plain version's PyTorch kernel computes, in its order,
// rounded where it rounds.  nvcc contracts a * b + c into an FMA by
// default, which can move a floor(); so every product and sum is written
// with __fmul_rn / __fadd_rn / __fdiv_rn.  ATen divides by a Python scalar
// as a product with the scalar's float reciprocal (the host's 1.0f / b),
// so `/ dt_min` and `/ (H - 1)` are products with inv_dt_min and inv_hm1,
// which the wrapper computes in float32 the same way; a tensor divided by a
// tensor is a division.  log2f / exp2f / ceilf are the library functions
// PyTorch calls, not the fast intrinsics.  amin / amax / maximum / clamp
// propagate NaN as PyTorch's do (a ray direction with a zero component
// makes 0 * inf at a cell face).
//
// What bounds it: latency.  Each lookup is an 8-byte gather from the packed
// bitfield (256 KB a cascade: it stays in L2, read through __ldg) whose
// address depends on the previous lookup's result, a chain of up to
// ceil(S / K) * SKIP_ITERS lookups a ray.  The bytes it must move are its
// outputs ts, dts [N, S] f32, valid [N, S] bool and t_end [N], its inputs
// (rays_o, rays_d [N, 3], nears, fars, t0 [N]) and one read of the
// bitfield.  Its arithmetic, counted from lookup() and find_cell() below:
// 87 float operations a lookup (position 12, dt 3, |pos| max 5, the two
// mip levels 2 + 2 x 8, mip_bound 2, the cell 12, the DDA exit 33, the
// exit t 2) and 7 more for a skip, 94 in all, and 39 integer ones (the
// cell's clamps, the superblock's address, the bit), far below the card's
// rate.  The bytes bound is about 1 us at the main path's 4096 rays x 64
// samples; the dependent chain is what takes the time.
//
// Design, kept simple: one thread per ray, the whole walk in registers (no
// shared memory, no warp cooperation), 64 threads a block so that small
// batches still spread over the SMs.  Rows of the outputs are written by
// their ray's thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGrid = 128;            // occupancy grid cells per side (H)
constexpr int kSuper = 4;             // cells per superblock side
constexpr int kHS = kGrid / kSuper;   // superblocks per side
constexpr int kSkipIters = 64;        // empty-space jumps per emission, at most
constexpr int kThreads = 64;

struct MarchArgs {
  float dt_min;      // 2 sqrt(3) / max_steps, as float
  float dt_max;      // 2 sqrt(3) 2^(C-1) / H, as float
  float dt_gamma;
  float bound;
  float inv_dt_min;  // 1.0f / dt_min, float division (ATen's scalar divide)
  float inv_hm1;     // 1.0f / 127.0f, likewise
  int cascades;
  int num_samples;
  int emit_k;        // samples per lookup; 1 when dt_gamma != 0
  int gamma_zero;    // dt_gamma == 0 (as the plain version tests it, in double)
};

// PyTorch's NaN-propagating min / max (torch.minimum, amin, clamp).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// _mip_from_val: ceil(log2(max(v, 1e-30))), +1 where v >= 2^that, in
// [0, cascades - 1].
__device__ __forceinline__ int mip_from_val(float v, int cascades) {
  float e = ceilf(log2f(clamp_min(v, 1e-30f)));
  if (v >= exp2f(e)) e = __fadd_rn(e, 1.0f);
  e = clamp_max(clamp_min(e, 0.0f), (float)(cascades - 1));
  return (int)e;
}

struct Ray {
  float o[3], d[3], inv_d[3], sgn[3];
  float far;
};

// One lookup at t (the plain version's lookup()): the cell's occupancy, the
// step dt and the exit t of the cell (occupied superblock) or superblock
// (empty one).
__device__ __forceinline__ void lookup(const Ray& r, float t, const uint2* __restrict__ bits,
                                       const MarchArgs& a, bool* occ, float* dt, float* tt) {
  float pos[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    pos[k] = clamp_max(clamp_min(__fadd_rn(r.o[k], __fmul_rn(t, r.d[k])), -a.bound), a.bound);
  float dtv = clamp_max(clamp_min(__fmul_rn(t, a.dt_gamma), a.dt_min), a.dt_max);
  float mx = nan_max(nan_max(fabsf(pos[0]), fabsf(pos[1])), fabsf(pos[2]));
  int lvl_pos = mip_from_val(mx, a.cascades);
  int lvl_dt = mip_from_val(__fmul_rn(__fmul_rn(dtv, (float)kGrid), 0.5f), a.cascades);
  int lvl = lvl_pos > lvl_dt ? lvl_pos : lvl_dt;
  float mip_bound = clamp_max(exp2f((float)lvl), a.bound);
  int nc[3], sc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float q = __fadd_rn(__fdiv_rn(pos[k], mip_bound), 1.0f);
    q = __fmul_rn(__fmul_rn(0.5f, q), (float)kGrid);
    int c = (int)q;  // truncation, as .to(torch.int32)
    c = c < 0 ? 0 : (c > kGrid - 1 ? kGrid - 1 : c);
    nc[k] = c;
    sc[k] = c / kSuper;
  }
  const long long scell = (long long)lvl * (kHS * kHS * kHS) + sc[0] * (kHS * kHS) +
                          sc[1] * kHS + sc[2];
  const uint2 row = __ldg(bits + scell);
  const int b = (nc[0] - sc[0] * kSuper) * (kSuper * kSuper) +
                (nc[1] - sc[1] * kSuper) * kSuper + (nc[2] - sc[2] * kSuper);
  const unsigned word = b < 32 ? row.x : row.y;
  *occ = ((word >> (b & 31)) & 1u) != 0u;
  const bool occ_s = (row.x | row.y) != 0u;
  // DDA exit of the cell (block 1) or superblock (block 4), normalised by
  // H - 1 at both granularities (raymarching.cu:389-396)
  const float block = occ_s ? 1.0f : (float)kSuper;
  float nb_min = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float x = __fmul_rn((float)(occ_s ? nc[k] : sc[k]), block);
    x = __fadd_rn(x, 0.5f * block);
    x = __fadd_rn(x, __fmul_rn(r.sgn[k], 0.5f * block));
    x = __fmul_rn(x, a.inv_hm1);
    x = __fmul_rn(x, 2.0f);
    x = __fadd_rn(x, -1.0f);
    x = __fmul_rn(x, mip_bound);
    x = __fsub_rn(x, pos[k]);
    x = __fmul_rn(x, r.inv_d[k]);
    nb_min = k == 0 ? x : nan_min(nb_min, x);
  }
  *dt = dtv;
  *tt = __fadd_rn(t, clamp_min(nb_min, 0.0f));
}

// find_cell: empty-space skips until an occupied cell is found, the ray
// leaves [.., far) or SKIP_ITERS jumps are spent.  t advances in place.
__device__ __forceinline__ bool find_cell(const Ray& r, float* t, bool live,
                                          const uint2* __restrict__ bits, const MarchArgs& a,
                                          float* dt_found, float* tt_found) {
  bool found = false;
  float dtf = a.dt_min, ttf = *t, tv = *t;
  for (int it = 0; it < kSkipIters; ++it) {
    if (!(live && tv < r.far && !found)) break;
    bool occ;
    float dt, tt;
    lookup(r, tv, bits, a, &occ, &dt, &tt);
    if (occ) {
      found = true;
      dtf = dt;
      ttf = tt;
    } else if (a.gamma_zero) {
      // a whole number of dt_min steps, at least one, to the cell exit
      float n_skip = ceilf(__fmul_rn(clamp_min(__fsub_rn(tt, tv), 0.0f), a.inv_dt_min));
      tv = __fadd_rn(tv, __fmul_rn(clamp_min(n_skip, 1.0f), a.dt_min));
    } else {
      tv = nan_max(tt, __fadd_rn(tv, dt));
    }
  }
  *t = tv;
  *dt_found = dtf;
  *tt_found = ttf;
  return found;
}

__global__ void __launch_bounds__(kThreads)
march_rays_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                  const uint2* __restrict__ bits, const float* __restrict__ nears,
                  const float* __restrict__ fars, const float* __restrict__ t0,
                  float* __restrict__ ts, float* __restrict__ dts,
                  uint8_t* __restrict__ valid, float* __restrict__ t_end, int n, MarchArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = rays_o[3 * i + k];
    r.d[k] = rays_d[3 * i + k];
    r.inv_d[k] = __fdiv_rn(1.0f, r.d[k]);
    r.sgn[k] = sign_of(r.d[k]);
  }
  r.far = fars[i];
  bool live = nears[i] < 1e30f;
  float t = t0[i];
  const int S = a.num_samples;
  float* ts_row = ts + (long long)i * S;
  float* dts_row = dts + (long long)i * S;
  uint8_t* valid_row = valid + (long long)i * S;

  if (a.emit_k > 1) {
    // K samples a lookup while dt is constant: every dt_min inside the
    // occupied cell, up to its exit
    const int K = a.emit_k;
    const int n_blocks = (S + K - 1) / K;
    for (int blk = 0; blk < n_blocks; ++blk) {
      float tf = t, dtf, ttf;
      const bool found = find_cell(r, &tf, live, bits, a, &dtf, &ttf);
      const float n_cell =
          clamp_min(ceilf(__fmul_rn(clamp_min(__fsub_rn(ttf, tf), 0.0f), a.inv_dt_min)), 1.0f);
      for (int k = 0; k < K; ++k) {
        const int slot = blk * K + k;
        if (slot >= S) break;
        const float tk = __fadd_rn(tf, __fmul_rn((float)k, a.dt_min));
        const bool v = found && ((float)k < n_cell) && (tk < r.far);
        ts_row[slot] = tk;
        dts_row[slot] = v ? a.dt_min : 0.0f;
        valid_row[slot] = v ? 1 : 0;
      }
      t = found ? __fadd_rn(tf, __fmul_rn(clamp_max(n_cell, (float)K), a.dt_min)) : tf;
      live = live && (t < r.far);
    }
  } else {
    for (int s = 0; s < S; ++s) {
      float tf = t, dtf, ttf;
      const bool found = find_cell(r, &tf, live, bits, a, &dtf, &ttf);
      ts_row[s] = tf;
      dts_row[s] = found ? dtf : 0.0f;
      valid_row[s] = found ? 1 : 0;
      t = found ? __fadd_rn(tf, dtf) : tf;
      live = live && (t < r.far);
    }
  }
  t_end[i] = t;
}

}  // namespace

extern "C" int march_rays_launch(const void* rays_o, const void* rays_d, const void* bits,
                                 const void* nears, const void* fars, const void* t0, void* ts,
                                 void* dts, void* valid, void* t_end, int n, int num_samples,
                                 int emit_k, int gamma_zero, int cascades, float dt_min,
                                 float dt_max,
                                 float dt_gamma, float bound, float inv_dt_min, float inv_hm1,
                                 void* stream) {
  if (n < 0 || num_samples < 1 || emit_k < 1 || cascades < 1 || ((uintptr_t)bits % 8) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  MarchArgs a{dt_min,   dt_max,      dt_gamma, bound,  inv_dt_min,
              inv_hm1,  cascades,    num_samples, emit_k, gamma_zero};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  march_rays_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const uint2*)bits, (const float*)nears,
      (const float*)fars, (const float*)t0, (float*)ts, (float*)dts, (uint8_t*)valid,
      (float*)t_end, n, a);
  return (int)cudaGetLastError();
}
