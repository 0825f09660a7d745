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
// the slots of a dead ray too.  For the same reason a batch that holds the
// rays of two renders gives each ray what a batch of its render alone
// gives: the training step marches both renders of an event pair in one
// launch.
//
// Bit-equality with the plain version on the card: every rounded operation
// below is the one the plain version's PyTorch kernel computes, in its
// order.  nvcc contracts a * b + c into an FMA by default, which can move a
// floor(); so every product and sum is written with __fmul_rn / __fadd_rn /
// __fdiv_rn.  ATen divides by a Python scalar as a product with the
// scalar's float reciprocal (the host's 1.0f / b), so `/ dt_min` and
// `/ (H - 1)` are products with inv_dt_min and inv_hm1, which the wrapper
// computes in float32 the same way; a tensor divided by a tensor is a
// division.  ceilf is the library function PyTorch calls.  amin / amax /
// maximum / clamp propagate NaN as PyTorch's do (a ray direction with a
// zero component makes 0 * inf at a cell face).
//
// What bounds it: latency.  The march is a chain of dependent lookups a ray
// (each lookup's t is the previous one's skip), up to ceil(S / K) *
// SKIP_ITERS of them, and a few thousand rays leave most of the card idle,
// so the kernel lasts as long as its slowest warp's chain.  The bytes it
// must move (its rays, its [N, S] outputs, the bitfield once) take about
// 1 us.  So the design shortens the chain and each of its links, and
// changes no rounded result.  Measured on an H100 (700 W) at the main
// path's 4096 rays x 64 samples on a trained grid (longest ray 280
// lookups; 98% of the superblocks occupied), the nested-loop kernel of
// commit 580e741 took 0.57 ms:
//
//  - One flat loop a ray, one lookup an iteration: a block of K samples is
//    emitted in the iteration whose lookup finds its cell.  The old kernel
//    nested the skip loop inside the emission loop, so a warp waited at the
//    end of every emission block for its slowest ray's skips: a warp's chain
//    was the sum over blocks of its rays' longest skip runs (up to 840
//    lookups there), now its longest ray's (280).
//  - The mip level without log2f / exp2f: ceil(log2(v)), plus one where
//    v >= 2^that, is the float's exponent plus one for v >= 1 and 0
//    below (mip_level, held equal to mip_from_val on every non-negative
//    float for 1-4 cascades by mip_check_kernel).  With one cascade and
//    bound >= 1 (kUnit) the level is 0 and mip_bound 1.  With dt_gamma ==
//    0 the step's level is one constant for every finite t.  Where
//    mip_bound is 2^lvl (not clamped by bound) the division by it is a
//    product with 2^-lvl: both are the correctly rounded value of the same
//    real number.  In the old kernel these took 40% of the time.
//  - The DDA exit's cell-only part, ((c * block + block / 2 + sgn * block
//    / 2) * inv_hm1 * 2 - 1) * mip_bound, depends only on the integer cell
//    (128 cells, 32 superblocks), the ray's sign on the axis (-1, 0, 1)
//    and the level; a pre-pass computes it with the same roundings into a
//    table in shared memory (C x 3 x 160 floats), so a lookup reads both
//    candidate exits (cell and superblock) at once: 6% of the kernel.
//  - The superblock mask in shared memory: the pre-pass (one thread a
//    superblock, a warp ballot a 32-bit word) folds each 64-bit row of the
//    packed bitfield into one bit, 4 KB a cascade.  A lookup in an empty
//    superblock reads no global memory; one in an occupied superblock
//    reads its row once and keeps it in registers while the ray stays in
//    that superblock: 1% on the trained grid, whose superblocks are nearly
//    all occupied.
//  - No branches in a link: NaN-propagating min / max as FMNMX.NAN, the
//    cell coordinate without a division branch, a 4-sample block written
//    with one 16-byte store a row.  The compiler had turned each NaN test
//    and each axis's division into a branch of its own; this took the
//    kernel from 0.19 to 0.115 ms.
//
// Together 0.115 ms, and 0.115 ms for both renders of the step's event pair
// in one launch (8192 rays), against 1.02 ms for the old kernel's two
// launches.  What
// is left is the link's own chain, ~800 cycles an iteration: reading the
// row from L1 instead of L2 gains nothing (a second pass over warm rows
// takes as long as the first), nor does prefetching the row ahead on the
// ray, staging the outputs in shared memory or a warp-uniform loop.
//
// The arithmetic left a lookup, counted from lookup() and the loop below:
// position 6 (3 products, 3 sums), clamps 6, |pos| max 5, the cell 9 (a
// division or product, a sum and a product an axis), the DDA exit 8 (a
// difference and a product an axis, two mins), the exit t 2, the skip 7:
// 43 float operations, with ~30 integer ones (the cell's clamps, the
// superblock's address and bit, the level), far below the card's rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGrid = 128;            // occupancy grid cells per side (H)
constexpr int kSuper = 4;             // cells per superblock side
constexpr int kHS = kGrid / kSuper;   // superblocks per side
constexpr int kSuperCells = kHS * kHS * kHS;
constexpr int kMaskWords = kSuperCells / 32;   // a cascade's mask, 32-bit words
constexpr int kExitRow = kGrid + kHS;          // exit table entries a (level, sign)
constexpr int kExitLevel = 3 * kExitRow;       // a level's entries: signs -1, 0, 1
constexpr int kAuxWords = kMaskWords + kExitLevel;  // a cascade's pre-pass output
constexpr int kSkipIters = 64;        // empty-space jumps per emission, at most
constexpr int kMaxThreads = 64;
constexpr int kMaxK = 4;              // samples per lookup, at most (emit_k)

struct MarchArgs {
  float dt_min;      // 2 sqrt(3) / max_steps, as float
  float dt_max;      // 2 sqrt(3) 2^(C-1) / H, as float
  float dt_gamma;
  float bound;
  float inv_dt_min;  // 1.0f / dt_min, float division (ATen's scalar divide)
  int cascades;
  int num_samples;
  int emit_k;        // samples per lookup; 1 when dt_gamma != 0
  int gamma_zero;    // dt_gamma == 0 (as the plain version tests it, in double)
};

// PyTorch's NaN-propagating min / max (torch.minimum, amin, clamp), one
// instruction each (FMNMX.NAN): a NaN operand gives the canonical NaN.  The
// card's arithmetic makes only canonical NaNs (0 * inf at a cell face), so
// clamp(v) of a NaN v is v, as in PyTorch.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return nan_max(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return nan_min(v, hi); }
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// _mip_from_val as the plain version computes it: ceil(log2(max(v, 1e-30))),
// +1 where v >= 2^that, in [0, cascades - 1].  Kept as the definition that
// mip_level is checked against.
__device__ __forceinline__ int mip_from_val(float v, int cascades) {
  float e = ceilf(log2f(clamp_min(v, 1e-30f)));
  if (v >= exp2f(e)) e = __fadd_rn(e, 1.0f);
  e = clamp_max(clamp_min(e, 0.0f), (float)(cascades - 1));
  return (int)e;
}

// The same level from the float's bits: for v >= 1 (inf included) the
// smallest l with v < 2^l is the unbiased exponent plus one; below 1, and
// for NaN, 0.
__device__ __forceinline__ int mip_level(float v, int cascades) {
  if (!(v >= 1.0f)) return 0;
  const int e = (__float_as_int(v) >> 23) - 126;
  return e < cascades - 1 ? e : cascades - 1;
}

// The step dt at t (clamp(t * dt_gamma, dt_min, dt_max)).
__device__ __forceinline__ float step_dt(float t, const MarchArgs& a) {
  return clamp_max(clamp_min(__fmul_rn(t, a.dt_gamma), a.dt_min), a.dt_max);
}

// The DDA exit's cell-only part of entry j of a (level, sign) row: cell j
// (block 1) for j < 128, superblock j - 128 (block 4) above.
__device__ __forceinline__ float exit_part(int j, float sgn, float mip_bound, float inv_hm1) {
  const bool cell = j < kGrid;
  const float block = cell ? 1.0f : (float)kSuper;
  float x = __fmul_rn((float)(cell ? j : j - kGrid), block);
  x = __fadd_rn(x, 0.5f * block);
  x = __fadd_rn(x, __fmul_rn(sgn, 0.5f * block));
  x = __fmul_rn(x, inv_hm1);
  x = __fmul_rn(x, 2.0f);
  x = __fadd_rn(x, -1.0f);
  return __fmul_rn(x, mip_bound);
}

// Pre-pass: per cascade, the superblock mask (bit s of word w: superblock
// 32 w + s has an occupied cell) and the exit table, [level][sign + 1][j].
// One thread a superblock; threads below C * kExitLevel also write one
// table entry.
__global__ void __launch_bounds__(256)
march_prepass_kernel(const uint2* __restrict__ bits, unsigned* __restrict__ aux, int cascades,
                     float bound, float inv_hm1) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < cascades * kSuperCells) {  // a whole number of warps
    const uint2 row = bits[s];
    const unsigned word = __ballot_sync(0xffffffffu, (row.x | row.y) != 0u);
    if ((threadIdx.x & 31) == 0) aux[s >> 5] = word;
  }
  if (s < cascades * kExitLevel) {
    const int lvl = s / kExitLevel, r = s - lvl * kExitLevel;
    const int sign = r / kExitRow, j = r - sign * kExitRow;
    const float mip_bound = clamp_max(exp2f((float)lvl), bound);
    aux[cascades * kMaskWords + s] =
        __float_as_uint(exit_part(j, (float)(sign - 1), mip_bound, inv_hm1));
  }
}

struct Ray {
  float o[3], d[3], inv_d[3];
  int row[3];  // the ray's exit-table row offset on each axis: (sign + 1) * kExitRow
  float far;
};

// Per-launch constants of a lookup.
struct Level {
  int pow2_levels;  // levels l whose mip_bound is 2^l (2^l <= bound)
  float dt0;        // the step dt at any finite t when dt_gamma == 0
  int lvl_dt0;      // its level
};

// One lookup at t (the plain version's lookup()): the cell's occupancy,
// the step dt and the exit t of the cell (occupied superblock) or
// superblock (empty one).  `cached` / `crow`: the last row read.  kUnit:
// one cascade whose mip_bound is 1 (bound >= 1), so the level is 0 and the
// position is its own cell coordinate (pos / 1).
template <bool kUnit>
__device__ __forceinline__ void lookup(const Ray& r, float t, const uint2* __restrict__ bits,
                                       const unsigned* __restrict__ smask,
                                       const float* __restrict__ sexit, const MarchArgs& a,
                                       const Level& L, int& cached, uint2& crow, bool* occ,
                                       float* dt, float* tt) {
  float pos[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    pos[k] = clamp_max(clamp_min(__fadd_rn(r.o[k], __fmul_rn(t, r.d[k])), -a.bound), a.bound);
  float dtv;
  int lvl = 0;
  if (a.gamma_zero) {
    // t * 0 is +-0 for finite t, NaN otherwise
    const bool fin = isfinite(t);
    dtv = fin ? L.dt0 : __int_as_float(0x7fffffff);
    if (!kUnit) lvl = fin ? L.lvl_dt0 : 0;
  } else {
    dtv = step_dt(t, a);
    if (!kUnit) lvl = mip_level(__fmul_rn(__fmul_rn(dtv, (float)kGrid), 0.5f), a.cascades);
  }
  if (!kUnit) {
    const float mx = nan_max(nan_max(fabsf(pos[0]), fabsf(pos[1])), fabsf(pos[2]));
    const int lp = mip_level(mx, a.cascades);
    lvl = lp > lvl ? lp : lvl;
  }
  float q[3] = {pos[0], pos[1], pos[2]};  // pos / mip_bound
  if (!kUnit) {
    if (lvl < L.pow2_levels) {
      const float inv_mb = __int_as_float((127 - lvl) << 23);  // 2^-lvl
#pragma unroll
      for (int k = 0; k < 3; ++k) q[k] = __fmul_rn(pos[k], inv_mb);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) q[k] = __fdiv_rn(pos[k], a.bound);
    }
  }
  int nc[3], sc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float qk = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(q[k], 1.0f)), (float)kGrid);
    int c = (int)qk;  // truncation, as .to(torch.int32)
    c = c < 0 ? 0 : (c > kGrid - 1 ? kGrid - 1 : c);
    nc[k] = c;
    sc[k] = c >> 2;
  }
  // both candidate exits' table parts, read beside the mask word
  const float* ex = sexit + lvl * kExitLevel;
  float xc[3], xs[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xc[k] = ex[r.row[k] + nc[k]];
    xs[k] = ex[r.row[k] + kGrid + sc[k]];
  }
  const int scell = lvl * kSuperCells + sc[0] * (kHS * kHS) + sc[1] * kHS + sc[2];
  const bool occ_s = (smask[scell >> 5] >> (scell & 31)) & 1u;
  bool o = false;
  if (occ_s) {
    if (scell != cached) {
      crow = __ldg(bits + scell);
      cached = scell;
    }
    const int b = (nc[0] & 3) * (kSuper * kSuper) + (nc[1] & 3) * kSuper + (nc[2] & 3);
    const unsigned word = b < 32 ? crow.x : crow.y;
    o = ((word >> (b & 31)) & 1u) != 0u;
  }
  *occ = o;
  float nb_min = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float x = __fsub_rn(occ_s ? xc[k] : xs[k], pos[k]);
    x = __fmul_rn(x, r.inv_d[k]);
    nb_min = k == 0 ? x : nan_min(nb_min, x);
  }
  *dt = dtv;
  *tt = __fadd_rn(t, clamp_min(nb_min, 0.0f));
}

template <bool kUnit>
__global__ void __launch_bounds__(kMaxThreads)
march_rays_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                  const uint2* __restrict__ bits, const uint4* __restrict__ aux,
                  const float* __restrict__ nears, const float* __restrict__ fars,
                  const float* __restrict__ t0, float* __restrict__ ts, float* __restrict__ dts,
                  uint8_t* __restrict__ valid, float* __restrict__ t_end, int n, MarchArgs a) {
  extern __shared__ uint4 smem[];
  // the pre-pass output: mask words, then the exit table
  const int vecs = a.cascades * kAuxWords / 4;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) smem[v] = aux[v];
  const unsigned* smask = reinterpret_cast<const unsigned*>(smem);
  const float* sexit = reinterpret_cast<const float*>(smask + a.cascades * kMaskWords);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  Level L;
  float t = 0.0f;
  bool live = false;
  if (i < n) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.o[k] = rays_o[3 * i + k];
      r.d[k] = rays_d[3 * i + k];
      r.inv_d[k] = __fdiv_rn(1.0f, r.d[k]);
      r.row[k] = ((int)sign_of(r.d[k]) + 1) * kExitRow;
    }
    r.far = fars[i];
    live = nears[i] < 1e30f;
    t = t0[i];
    L.dt0 = step_dt(0.0f, a);
    L.lvl_dt0 = mip_level(__fmul_rn(__fmul_rn(L.dt0, (float)kGrid), 0.5f), a.cascades);
    int p = 0;
    while (p < a.cascades && exp2f((float)p) <= a.bound) ++p;
    L.pow2_levels = p;
  }
  __syncthreads();
  if (i >= n) return;

  const int S = a.num_samples;
  const int K = a.emit_k;
  const int n_blocks = (S + K - 1) / K;
  // 4 samples a lookup and a whole number of blocks a row: each block's
  // slots are 16-byte aligned (the outputs are fresh allocations)
  const bool whole = K == kMaxK && S % kMaxK == 0;
  float* ts_row = ts + (long long)i * S;
  float* dts_row = dts + (long long)i * S;
  uint8_t* valid_row = valid + (long long)i * S;
  int cached = -1;
  uint2 crow = make_uint2(0u, 0u);

  // One lookup an iteration.  t: the block's start (the plain version's
  // outer t); tv: find_cell's t; it: the block's lookups so far.  A block
  // is emitted in the iteration that finds its cell, or once the ray is
  // inactive (dead, past far, or SKIP_ITERS lookups spent).
  float tv = t;
  int it = 0;
  for (int blk = 0; blk < n_blocks;) {
    bool found = false, emit = true;
    float dtf = a.dt_min, ttf = t;
    if (live && tv < r.far && it < kSkipIters) {
      bool occ;
      float dt, tt;
      lookup<kUnit>(r, tv, bits, smask, sexit, a, L, cached, crow, &occ, &dt, &tt);
      ++it;
      if (occ) {
        found = true;
        dtf = dt;
        ttf = tt;
      } else {
        if (a.gamma_zero) {
          // a whole number of dt_min steps, at least one, to the cell exit
          const float n_skip = ceilf(__fmul_rn(clamp_min(__fsub_rn(tt, tv), 0.0f), a.inv_dt_min));
          tv = __fadd_rn(tv, __fmul_rn(clamp_min(n_skip, 1.0f), a.dt_min));
        } else {
          tv = nan_max(tt, __fadd_rn(tv, dt));
        }
        emit = !(tv < r.far && it < kSkipIters);
      }
    }
    if (!emit) continue;
    const float tf = tv;
    if (K > 1) {
      // K samples a lookup while dt is constant: every dt_min inside the
      // occupied cell, up to its exit
      const float n_cell =
          clamp_min(ceilf(__fmul_rn(clamp_min(__fsub_rn(ttf, tf), 0.0f), a.inv_dt_min)), 1.0f);
      float tk[kMaxK];
      bool v[kMaxK];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        tk[k] = __fadd_rn(tf, __fmul_rn((float)k, a.dt_min));
        v[k] = found && ((float)k < n_cell) && (tk[k] < r.far);
      }
      if (whole) {  // the block's 4 slots in one 16-byte store a row
        const int slot = blk * kMaxK;
        *reinterpret_cast<float4*>(ts_row + slot) = make_float4(tk[0], tk[1], tk[2], tk[3]);
        *reinterpret_cast<float4*>(dts_row + slot) =
            make_float4(v[0] ? a.dt_min : 0.0f, v[1] ? a.dt_min : 0.0f,
                        v[2] ? a.dt_min : 0.0f, v[3] ? a.dt_min : 0.0f);
        *reinterpret_cast<uchar4*>(valid_row + slot) = make_uchar4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          const int slot = blk * K + k;
          if (k < K && slot < S) {
            ts_row[slot] = tk[k];
            dts_row[slot] = v[k] ? a.dt_min : 0.0f;
            valid_row[slot] = v[k] ? 1 : 0;
          }
        }
      }
      t = found ? __fadd_rn(tf, __fmul_rn(clamp_max(n_cell, (float)K), a.dt_min)) : tf;
    } else {
      ts_row[blk] = tf;
      dts_row[blk] = found ? dtf : 0.0f;
      valid_row[blk] = found ? 1 : 0;
      t = found ? __fadd_rn(tf, dtf) : tf;
    }
    live = live && (t < r.far);
    tv = t;
    it = 0;
    ++blk;
  }
  t_end[i] = t;
}

// mip_level against mip_from_val on every non-negative float (bits 0 to
// 2^31 - 1: zero, subnormals, normals, inf and every NaN) for 1-4
// cascades; exp2f(l) == 2^l for l = 0..3; and x * 2^-l against
// __fdiv_rn(x, 2^l) on every float for l = 1..3 (equal bits, or both
// NaN).  Counts the mismatches of each check.
__global__ void mip_check_kernel(unsigned long long* __restrict__ mismatches) {
  unsigned long long bad_level = 0, bad_div = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < 0x80000000u; u += stride) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float x = __uint_as_float(u | (half ? 0x80000000u : 0u));
      if (!half) {
#pragma unroll
        for (int c = 1; c <= 4; ++c) bad_level += mip_from_val(x, c) != mip_level(x, c);
      }
#pragma unroll
      for (int l = 1; l <= 3; ++l) {
        const float p = __fmul_rn(x, __int_as_float((127 - l) << 23));
        const float q = __fdiv_rn(x, (float)(1 << l));
        bad_div += !((isnan(p) && isnan(q)) || __float_as_uint(p) == __float_as_uint(q));
      }
    }
  }
  if (bad_level) atomicAdd(mismatches, bad_level);
  if (bad_div) atomicAdd(mismatches + 1, bad_div);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long bad_exp = 0;
    for (int l = 0; l <= 3; ++l) bad_exp += exp2f((float)l) != (float)(1 << l);
    atomicAdd(mismatches + 2, bad_exp);
  }
}

}  // namespace

extern "C" int march_prepass_launch(const void* bits, void* aux, int cascades, float bound,
                                    float inv_hm1, void* stream) {
  if (cascades < 1 || cascades > 4 || ((uintptr_t)bits % 8) != 0 || ((uintptr_t)aux % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = cascades * kSuperCells;
  march_prepass_kernel<<<(threads + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const uint2*)bits, (unsigned*)aux, cascades, bound, inv_hm1);
  return (int)cudaGetLastError();
}

extern "C" int march_rays_launch(const void* rays_o, const void* rays_d, const void* bits,
                                 const void* aux, const void* nears, const void* fars,
                                 const void* t0, void* ts, void* dts, void* valid, void* t_end,
                                 int n, int num_samples, int emit_k, int gamma_zero, int cascades,
                                 int threads, float dt_min, float dt_max, float dt_gamma,
                                 float bound, float inv_dt_min, void* stream) {
  if (n < 0 || num_samples < 1 || emit_k < 1 || emit_k > kMaxK || cascades < 1 || cascades > 4 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      ((uintptr_t)bits % 8) != 0 || ((uintptr_t)aux % 16) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  MarchArgs a{dt_min, dt_max, dt_gamma, bound, inv_dt_min, cascades, num_samples, emit_k,
              gamma_zero};
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const size_t smem = (size_t)cascades * kAuxWords * 4;  // <= 24 KB: no opt-in needed
  if (cascades == 1 && bound >= 1.0f)
    march_rays_kernel<true><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, (const uint2*)bits, (const uint4*)aux,
        (const float*)nears, (const float*)fars, (const float*)t0, (float*)ts, (float*)dts,
        (uint8_t*)valid, (float*)t_end, n, a);
  else
    march_rays_kernel<false><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, (const uint2*)bits, (const uint4*)aux,
        (const float*)nears, (const float*)fars, (const float*)t0, (float*)ts, (float*)dts,
        (uint8_t*)valid, (float*)t_end, n, a);
  return (int)cudaGetLastError();
}

extern "C" int mip_check_launch(void* mismatches, void* stream) {
  mip_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((unsigned long long*)mismatches);
  return (int)cudaGetLastError();
}
