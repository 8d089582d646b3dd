// One whole MPPI, SMPPI or KMPPI iteration for one plant, the batched MPPI
// iteration for N plants, the two kernels of the legacy rollout route, and
// the two ops-level kernels (the sampling front-end and the row-major
// round-1 solve), written by hand for Hopper (sm_90a).
//
// Replaces the eight TPU kernels of pytorch_mppi_tpu/ops/pallas_rollout.py:
//   MPPI     make_transposed_fused_solve    (pallas_rollout.py:512)
//   SMPPI    make_transposed_smppi_solve    (pallas_rollout.py:755)
//   KMPPI    make_transposed_kmppi_solve    (pallas_rollout.py:940)
//   Round-1  make_fused_solve               (pallas_rollout.py:1527)
// as one kernel template, mppi_fused_partial<Model, N, kGlobal, V>, which
// merges its own partials (the round-1 solve is kMPPI with the runtime flag
// `rowmajor`), and
//   make_transposed_batched_solve  (pallas_rollout.py:1118) as
//                          batched_partial<Model, N, kGlobal> + flash_merge,
//   make_fused_rollout     (pallas_rollout.py:75)   as fused_rollout<Model, N>
//   fused_weighted_update  (pallas_rollout.py:172)  as weighted_partial<S>, which
//                          merges its own partials
//   make_fused_sampler     (pallas_rollout.py:1350) as fused_sampler (diagonal op)
//                          and fused_sampler_op<TR> (full op).
//
// The iteration.  For K samples kernel A computes: the normals of the R drawn
// rows (from injected int32 bits or from Philox4x32-10), the antithetic sign,
// the noise transform (diagonal scale or full (R, R) operator), then per variant
//   MPPI  (R = D = T*nu): U + noise, the null-action row, the elite rows
//         (samples elite_off + j take row j of an (E, D) operand), the clamp;
//   SMPPI (R = D): the rate clamp, the integration as + rate*dt, the null row,
//         the action clamp, the noise back-computed through both clamps as
//         (pa - as)/dt - U, and the smoothness cost w*sum ||u_scale*diff||^2;
//   KMPPI (R = Dp = nsp*nu): theta + noise clamped at the support points, each
//         full-horizon row interpolated in the kernel as W[d, :] . pts (fp32
//         FMAs, no TF32), the null row and the trajectory clamp;
// the action cost of the rectified noise, the T-step rollout of a device
// model with u_scale, and the streaming softmax statistics of the update
// (rate-space noise for SMPPI, support-point noise for KMPPI).  The batched
// iteration (R = D, N plants) draws the same noise once for all plants (it
// depends on the sample's source column only), or reads it from a final
// (D, ld) noise operand, and applies MPPI's clamp, with no null-action row,
// for each plant.  The contract is the JAX one: (delta (R,), m, s, cost)
// with the nominal + delta / s; for N plants delta (R, N), (m, s) (2, N) and
// cost (N, K), one softmax per plant.
//
// Design.  The TPU kernel walks its K blocks in order and carries (m, s, acc)
// in scratch; GPU blocks run at the same time, so each block writes its own
// (m_b, s_b, acc_b) partial and the partials are merged:
//   A. mppi_fused_partial: S = 32, 64 or 128 samples a block (chosen at launch
//      by ops/fused_solve.tile_samples from K and the card's SM count), 128
//      threads.  Thread t owns sample t % S and every (BLOCK / S)-th row of
//      the block's (D, S) tiles, so the draw (a Philox call for four rows of
//      one sample, or the sample's bits, coalesced over the samples), the
//      transform, the clamps and the action cost run over all threads, each
//      with R * S / 128 (row, sample) pairs.  A full operator (op @ z) and
//      KMPPI's interpolation (W @ pts) are register-tiled products: a
//      thread keeps ROW_TILE rows of one sample in registers and reads each
//      operator element, shared by its warp, through the read-only cache
//      (fp32 FMAs, no TF32).  SMPPI stores its rate-space noise
//      (v - as)/dt - U when it computes it, so the update divides nothing.
//      The rollout is one thread per sample (threads t < S) on register
//      arrays of N = 2, 8 or 32, chosen at launch from max(nx, nu); with
//      nx = nu = 2 as constants on the N = 2 arrays, which keeps the device
//      model's constants in registers.  m_b and s_b are warp-shuffle
//      reductions; acc_b[r] = sum_s w_s upd[r, s] splits over groups of
//      threads over rows and samples.  The last block to finish (a ticket
//      from an int32 counter, after a __threadfence) merges every partial
//      into delta and (m, s) and sets the counter back to 0: one launch a
//      call.  Samples at and beyond K draw zeros and weigh exactly 0.
//   B. flash_merge (the batched iteration): one
//      block per plant merges that plant's partials, m = max m_b,
//      s = sum s_b e^(m_b - m), delta[r] = sum acc_b[r] e^(m_b - m), with each
//      scale e^(m_b - m) taken once and the sums split over the block's
//      threads (merge_partials, which kernel A's last block also runs).
// The tiles live in shared memory (row stride S + 1, so that the column
// accesses of a warp and the row reads of the update are free of bank
// conflicts) when they fit in the 227 KB a block may use; otherwise (kGlobal)
// in a global scratch of one (D, S) slice per block and tile, which stays in
// the 50 MB L2.  The noise never reaches device memory unless the caller
// asks for the perturbed actions (emit_perturbed, written coalesced over k)
// or passes it as the batched operand.
//
// The batched kernel, batched_partial.  The noise is the same for every
// plant, so a block takes 128 samples for a group of P plants (chosen at
// launch by ops/fused_solve.plant_group) on a one-dimensional grid of
// nblocks * ceil(N / P) blocks, any N.  It stages the final noise of its
// samples once (drawn and transformed, or copied from the operand 16 bytes a
// load) in an (R, BLOCK + 4) tile, then for each plant of the group rolls
// each sample out in registers (the plant's U, lo, hi and action-cost column
// as one float4 a row, the next plant's fetched with cp.async meanwhile),
// reduces m_b and s_b with warp shuffles, and has all 128 threads recompute
// the clamped noise for the update (groups of threads over rows and over
// samples, the tile read four floats at a time).  Nothing specific to a
// plant stays in the tile, so one draw serves P plants.  Where nx = nu = 2
// (the N = 2 arrays) the rollout is compiled with those sizes as constants,
// which keeps the device model's constants in registers and its loops free of
// branches: that halves the instructions of a rollout step.
//
// What bounds it on an H100 SXM.  At the flagship shape (K = 10,000, T = 30,
// nu = 2, seed mode) kernel A reads and writes about 41 KB (the cost row and
// the small operands), which takes about 0.012 us at 3.35 TB/s.  Its float32
// work is about 60 normals (Philox + Giles' erfinv, about 55 operations each)
// and 30 model steps per sample, some 4e7 operations, about 0.6 us at 67
// TFLOP/s (KMPPI adds D*Dp = 1,800 FMAs of interpolation per sample).  So it
// is bound by latency: the launch, each block's chain of dependent passes
// (draw, transform, rollout, reductions, update) and the last block's merge;
// the design shortens the chain by splitting every pass but the rollout over
// all threads, and fills the 132 SMs with blocks of fewer samples.  The
// batched iteration at N = 1,024, K = 16,384 needs about 1.9e10 operations (0.28 ms) in either mode: the per-plant clamp,
// action cost, rollout and update; the shared draw, counted once a source
// column, adds 5.6e7; the 64 MB of costs it writes take 0.02 ms.  With the
// draw shared, the kernel is bound by issuing the per-plant instructions:
// the rollout step, the recomputed clamp of the update and the block's
// reductions.
// chip_smoke.py computes the exact bounds from the run's shapes.
//
// The legacy route.  fused_rollout: bound by the bytes of the (K, T*nu)
// scaled actions (2.4 MB at the flagship, 0.7 us), so by latency at that
// size: the launch, one trip to device memory for a block's rows and a
// 30-step chain a sample.  The design: blocks of S = 32 samples
// (tile_samples, 313 blocks at K = 10,000), whose rows, one contiguous span,
// all 128 threads stage in shared memory with 16-byte cp.async copies, every
// copy in flight at once, before one thread a sample rolls its row out of
// shared memory (rows padded so that those reads are free of bank conflicts).
// weighted_partial<S> (fused_weighted_update): bound by reading the (K, D)
// noise once (2.4 MB at the flagship, 0.7 us), so by latency at that size:
// the launch, the block's chain (weights, reductions, the weighted sum) and
// the merge of the blocks' partials.  The design: one launch a call; blocks
// of S = 32 samples (tile_samples, as kernel A: 313 blocks at K = 10,000
// fill the 132 SMs) with shuffle reductions; the weighted sum on all 128
// threads, groups of threads over columns (16-byte loads a row) and over
// samples, so that a thread's chain is S / groups FMAs.  The merge sets the
// time: one block of 128 threads merging 313 partials with merge_partials
// made the kernel slower on the card than the two launches it replaces (the
// merge's L2 loads wait on one another, and its time grows with the
// partials), so the partials merge in two levels of about sqrt(nblocks)
// each (the last block of each group of blocks, then the last of those),
// each level one pass with the loads of eight partials in flight a thread
// (weighted_merge, over 16-byte rows).
//
// The ops-level kernels, which no controller routes to (as in JAX; they
// take K on rows, the (K, D) layout).  The sampler (make_fused_sampler): per
// element a draw (Philox, Giles' erfinv), the transform, the clamp and the
// action cost; bound by the bytes of the (K, D) output and, in bits mode,
// of the bits (4.9 MB at the flagship, 1.5 us), so by latency and issue.
// fused_sampler (a diagonal op): a thread per (source row, four elements),
// a row's groups on consecutive lanes (16 lanes at D = 60, two rows a
// warp), one Philox call or one 16-byte load of bits for four normals,
// 16-byte stores, the cost a segmented shuffle sum, and under antithetic
// sampling one draw for both rows of a pair; 256 threads a block, so
// K = 10,000 takes one wave of 625 blocks.  fused_sampler_op<TR> (a full op,
// z @ op: D^2 FMAs a row, so bound by operations at D = 300): the block's
// normals in shared memory, op streamed in panels through shared memory, a
// register tile of TR rows by four columns a thread, the mirror row as
// mu - z @ op.
// The round-1 solve (rowmajor): kernel A's kMPPI path with three runtime
// differences, so it adds no instantiation: the block stages its S rows of
// the (K_pad, D) bits through the tile with coalesced loads; the noise is
// chol @ z_t + mu per timestep (T nu^2 FMAs a sample, not the D^2 of the
// TPU's kron(I_T, chol^T)); mu, lo and hi are per-step (nu,) vectors.  No
// antithetic sign.
//
// Kernel A and the batched kernel add the final-state terminal cost of
// ops/kernel_models.quadratic_terminal when p.terminal is set (a runtime
// branch: no instantiation of its own); the legacy rollout and the round-1
// solve take none, as their TPU kernels take none.
//
// Left for later: the rollout still takes one thread a sample, so during it
// a block of S = 32 samples keeps three of its four warps idle; two samples
// a thread in the batched rollout; a last-block merge for the batched
// kernel; merge_partials' dependent L2 loads (kernel A's last block,
// flash_merge), which weighted_merge's one pass avoids.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each entry
// returns cudaGetLastError() after its launches.  The file builds whole, or
// as fourteen translation units selected by -DFUSED_MPPI_PART=0..13 (0-4, 11,
// 12 and 13: the single-plant variants and the rollout kernel of each device
// model and register size, 13 the residual MLP's; 5: kernel B, the weighted
// update, the sampler and the entry points; 6-10: the batched kernel of each
// device model and register size), which ops/_build.py compiles in parallel
// and links.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FUSED_MPPI_PART
#define FUSED_MPPI_PART -1  // the whole library in one translation unit
#endif
#define FUSED_MPPI_HAS(k) (FUSED_MPPI_PART == -1 || FUSED_MPPI_PART == (k))

namespace fused_mppi {

constexpr int BLOCK = 128;  // threads of a block; samples of a block of batched_partial
constexpr int MAXN = 32;  // largest nx or nu of a device model
constexpr int MERGE_THREADS = 256;

// kRollout selects fused_rollout through the same launchers
enum Variant { kMPPI = 0, kSMPPI = 1, kKMPPI = 2, kBatched = 3, kRollout = 4 };

struct Params {
  const float* consts;
  int K, T, nx, nu, D, R, nblocks;  // R: rows drawn and updated (D, or Dp for KMPPI)
  int S;  // kernel A: samples of a block (32, 64 or 128)
  int num_plants;  // kBatched: N; 1 otherwise
  int plant_group;  // kBatched: P, the plants of one block of batched_partial
  const int* bits;  // (R, bits_cols) int32, or null in seed mode
  int bits_cols;
  unsigned key0, key1;  // the Philox key in seed mode, unless `key` is set
  const unsigned* key;  // kernel A and kBatched: the key's two words in device
                        // memory (written before a CUDA graph replays the
                        // launch), or null for key0/key1
  int pair_block, antithetic, null_action, abs_cost, full_op;
  int rowmajor;  // kMPPI as the round-1 solve: (K_pad, D) bits, op the (nu, nu)
                 // Cholesky factor, mu/lo/hi (nu,) per step
  const float* x0;  // (nx, K), or (nx, N) for kBatched, with the strides below
  long long x0_row_stride, x0_col_stride;
  const float* U;  // (D,) the nominal sequence (SMPPI: action rates); kBatched:
                   // (D, N) with strides u_rs, u_ps; kRollout: (K, D) scaled actions
  long long u_rs, u_ps;
  const float* base;  // (R,) SMPPI: the action sequence; KMPPI: theta; MPPI: U
  const float* op;  // (R,) diagonal or (R, R) row-major
  const float* mu;  // (R,)
  const float* lo;  // (R,) bounds of the drawn rows (SMPPI: rate bounds)
  const float* hi;
  const float* alo;  // (D,) SMPPI: action bounds; KMPPI: trajectory bounds
  const float* ahi;
  const float* a;  // (D,) action-cost vector; kBatched: (D, N), strides a_rs, a_ps
  long long a_rs, a_ps;
  const float* W;  // (D, R) KMPPI: kron(interp_full, I_nu)
  const float* noise;  // kBatched operand mode: (R, noise_ld) final noise, or null
  long long noise_ld;
  const float* lam;  // device scalars
  const float* w_seq;
  const float* dt;
  float u_scale;
  float* cost;  // (K,), or (N, K) for kBatched
  float* partial;  // (N, nblocks, R + 2): m_b, s_b, acc_b[0..R)
  float* pert;  // (D, K) or null
  float* scratch;  // kGlobal: (launched blocks, tiles, D, S) (batched: (.., R, BLOCK))
  int* counter;  // kernel A: the blocks that finished, 0 between launches
  float* delta;  // kernel A: (R,) the merged update
  float* ms;  // kernel A: (2,) m and s
  const float* terminal;  // kernel A and kBatched: the quadratic terminal cost's
                          // constants (goal (nx), w_state, w_action), or null for none
  int chunk_steps;  // kRollout: steps of a staged chunk of the actions
  int vec4;  // kRollout: the actions are staged 16 bytes a copy
  const float* elites;  // kMPPI: (num_elites, D) row-major, or null: sample
                        // elite_off + j takes row j before the clamp
  int num_elites, elite_off;
  const int* gate;  // kernel A: the null-action gate, one int32 in device memory
                    // (sample 0 is the null row only where it is not 0), or null
                    // for the null row of every launch
  int k_offset;  // kernel A: the global index of sample 0, for one shard of the
                 // samples; the draw of sample k is that of global sample k_offset + k
};

// --- reductions -------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The max (kMax) or sum of v over the block, returned to every thread: a
// shuffle within each warp, then one pass over the warps' results in `red`
// (blockDim.x / 32 floats).  Every thread of the block must call it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < warps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is free again
  return r;
}

// --- random numbers -------------------------------------------------------

// Philox4x32-10 (Salmon et al. 2011, Random123): ten rounds, key bumped
// between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The Philox key of a launch in seed mode: read once by each thread from
// device memory where p.key is set (one address for the whole grid, so one
// load a warp from L1), else the words passed by value.  A captured launch
// keeps its arguments, so a CUDA graph that must draw new noise at each
// replay takes its key by pointer.
__device__ __forceinline__ uint2 philox_key(const unsigned* key, unsigned key0, unsigned key1) {
  return key ? make_uint2(__ldg(key), __ldg(key + 1)) : make_uint2(key0, key1);
}

// Whether sample k of kernel A is the null row: sample 0 with sample_null_action,
// and where the launch has a gate (one shard of the samples), only when the
// int32 at p.gate is not 0.  The gate is read when the kernel runs, as the key.
__device__ __forceinline__ bool null_row(const Params& p, int k) {
  return p.null_action && k == 0 && (!p.gate || __ldg(p.gate) != 0);
}

// Giles' single-precision erfinv ("Approximating the erfinv function", GPU
// Computing Gems, 2011), the same polynomial XLA uses for float32 erf_inv.
__device__ __forceinline__ float erfinv_giles(float x) {
  float w = -log1pf(-x * x);
  float p;
  if (w < 5.0f) {
    w = w - 2.5f;
    p = 2.81022636e-08f;
    p = 3.43273939e-07f + p * w;
    p = -3.5233877e-06f + p * w;
    p = -4.39150654e-06f + p * w;
    p = 0.00021858087f + p * w;
    p = -0.00125372503f + p * w;
    p = -0.00417768164f + p * w;
    p = 0.246640727f + p * w;
    p = 1.50140941f + p * w;
  } else {
    w = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = 0.000100950558f + p * w;
    p = 0.00134934322f + p * w;
    p = -0.00367342844f + p * w;
    p = 0.00573950773f + p * w;
    p = -0.0076224613f + p * w;
    p = 0.00943887047f + p * w;
    p = 1.00167406f + p * w;
    p = 2.83297682f + p * w;
  }
  return p * x;
}

// _bits_to_normal (pallas_rollout.py:1501): the 23 high bits, shifted
// LOGICALLY, become a float in [1, 2); u = f - 1 + 2^-24 lies in (0, 1).
__device__ __forceinline__ float bits_to_normal(unsigned b) {
  const float f = __uint_as_float((b >> 9) | 0x3F800000u);
  const float u = (f - 1.0f) + 5.9604644775390625e-08f;
  return 1.41421356237309515f * erfinv_giles(2.0f * u - 1.0f);
}

// --- device models (ops/kernel_models.py) ---------------------------------
// State x and action u are register arrays of N; entries at and beyond nx
// (nu) are not read.

// x' = x + u B^T; consts = B (nx, nu) row-major, goal (nx).
template <int N>
__device__ __forceinline__ void linear_delta(const float* B, float* x, const float* u, int nx,
                                             int nu) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < nx) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < nu) acc += u[j] * B[i * nu + j];
      x[i] = x[i] + acc;
    }
  }
}

// |goal - x'|^2
struct LinearQuadratic {
  template <int N>
  __device__ static void step(const float* c, float* x, const float* u, int nx, int nu) {
    linear_delta<N>(c, x, u, nx, nu);
  }
  template <int N>
  __device__ static float cost(const float* c, const float* x, const float*, int nx, int nu) {
    const float* goal = c + nx * nu;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < nx) {
        const float d = goal[i] - x[i];
        s += d * d;
      }
    }
    return s;
  }
};

// models/toy2d.py: x' = x + u B^T; cost |goal - x'|^2 + r |u|^2 (LQRCost with
// Q = I, R = r I) + c0 exp(-(c - x')^T Qh (c - x')) (HillCost).  consts = B
// (nx, nu), goal (nx), r, Qh (nx, nx), c (nx), c0.
struct Toy2D {
  template <int N>
  __device__ static void step(const float* c, float* x, const float* u, int nx, int nu) {
    linear_delta<N>(c, x, u, nx, nu);
  }
  template <int N>
  __device__ static float cost(const float* c, const float* x, const float* u, int nx, int nu) {
    const float* goal = c + nx * nu;
    const float r = goal[nx];
    const float* Qh = goal + nx + 1;
    const float* center = Qh + nx * nx;
    const float c0 = center[nx];
    float lqr = 0.0f, uu = 0.0f, hill = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < nx) {
        const float d = goal[i] - x[i];
        lqr += d * d;
        const float di = center[i] - x[i];
        float row = 0.0f;
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (j < nx) row += Qh[i * nx + j] * (center[j] - x[j]);
        hill += di * row;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < nu) uu += u[j] * u[j];
    return (lqr + r * uu) + c0 * expf(-hill);
  }
};

// gym Pendulum-v1 (models/pendulum.py): g = 10, m = l = 1, dt = 0.05, the
// action clipped to +-2 and the speed to +-8 inside the dynamics.
struct Pendulum {
  __device__ static float angle_normalize(float x) {
    // floored modulo, as Python's % (fmodf keeps the dividend's sign)
    const float two_pi = 6.28318548f;
    float r = fmodf(x + 3.14159274f, two_pi);
    if (r < 0.0f) r += two_pi;
    return r - 3.14159274f;
  }
  template <int N>
  __device__ static void step(const float*, float* x, const float* u, int, int) {
    const float th = x[0], thdot = x[1];
    const float uc = fminf(fmaxf(u[0], -2.0f), 2.0f);
    float nthdot = thdot + (15.0f * sinf(th) + 3.0f * uc) * 0.05f;
    nthdot = fminf(fmaxf(nthdot, -8.0f), 8.0f);
    x[0] = th + nthdot * 0.05f;
    x[1] = nthdot;
  }
  template <int N>
  __device__ static float cost(const float*, const float* x, const float*, int, int) {
    const float an = angle_normalize(x[0]);
    return an * an + 0.1f * (x[1] * x[1]);
  }
};

// The learned residual model (ops/kernel_models.residual_mlp_model, the JAX
// package's models/mlp.make_residual_dynamics with its weights closed in):
// the action clipped, the wrapped state dimensions wrapped, the features
// (each encoded dimension as sin, cos), tanh hidden layers and a linear last
// layer, x' = x + MLP(features), the wrapped dimensions wrapped again, then
// the running cost on x': the gym pendulum's or |goal - x'|^2.  For nx, nu
// <= 2 (the N = 2 arrays).  consts: a header of MLP_HEAD floats (the layers
// L, the L + 1 widths, clip flag, lo, hi, the wrap and encode masks as bits,
// the cost (0 pendulum, 1 quadratic), the goal), then per layer W (n_in rows
// of p floats) and b (p floats), p = n_out rounded up to MLP_GROUP with
// zeros, so that every row starts on 16 bytes.
//
// At most MLP_MAX_LAYERS layers of at most MLP_MAX_WIDTH units (every MLP
// the JAX package and its tests build is [3|4, 32, 32, 2] or [4, 16, 2]).
// A thread evaluates its sample's network alone: the activations of the
// layer in and the layer out in a local array of 2 * MLP_MAX_WIDTH floats
// (indexed at run time, so local memory, which stays in L1: 512 bytes a
// rolling thread), MLP_GROUP outputs at a time in registers, each input
// read once for the group and its weights as two 16-byte loads through the
// read-only cache, at the same address for every thread of the warp.  The
// sums run in input order with fmaf from 0, then add the bias, as x W + b;
// tanhf is CUDA's accurate one (no -use_fast_math, no tanh.approx).
//
// What bounds it: operations.  At the demo's shape ([3, 32, 32, 2], K =
// 10,000, T = 30) a sample's step is about 2,500 (1,184 multiply-adds, 64
// tanh), 7.6e8 in all, 0.012 ms at the H100's 67 TFLOP/s of float32; its
// bytes (at most the rollout's 1.2 MB of actions) take 0.0004 ms.  Kernel A and the rollout took about 0.26 ms there
// on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): a block's
// rollout runs on one warp, so the card holds some 313 rolling warps for
// its 528 schedulers, and each waits on its own loads and FMA chains.
// Splitting a sample's layer over the block's threads is the redesign
// left for later.
constexpr int MLP_HEAD = 16;
constexpr int MLP_MAX_WIDTH = 64;
constexpr int MLP_MAX_LAYERS = 4;
constexpr int MLP_GROUP = 8;

struct ResidualMLP {
  template <int N>
  __device__ static void step(const float* c, float* x, const float* u, int nx, int nu) {
    const int layers = (int)c[0], wrap = (int)c[9], encode = (int)c[10];
    const bool clip = c[6] != 0.0f;
    float h[2 * MLP_MAX_WIDTH];
    float xs[N] = {};
    int f = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < nx) {
        xs[i] = (wrap >> i) & 1 ? Pendulum::angle_normalize(x[i]) : x[i];
        if ((encode >> i) & 1) {
          h[f++] = sinf(xs[i]);
          h[f++] = cosf(xs[i]);
        } else {
          h[f++] = xs[i];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < nu) h[f++] = clip ? fminf(fmaxf(u[j], c[7]), c[8]) : u[j];
    const float* w = c + MLP_HEAD;
    int in = 0;  // the layer's inputs at h[in], its outputs at h[MLP_MAX_WIDTH - in]
    for (int l = 0; l < layers; ++l) {
      const int n_in = (int)c[1 + l], n_out = (int)c[2 + l];
      const int p = (n_out + MLP_GROUP - 1) / MLP_GROUP * MLP_GROUP;
      const float* b = w + n_in * p;
      const int out = MLP_MAX_WIDTH - in;
      for (int j = 0; j < p; j += MLP_GROUP) {
        float acc[MLP_GROUP];
#pragma unroll
        for (int q = 0; q < MLP_GROUP; ++q) acc[q] = 0.0f;
        for (int i = 0; i < n_in; ++i) {
          const float a = h[in + i];
          const float4* row = reinterpret_cast<const float4*>(w + i * p + j);
#pragma unroll
          for (int v = 0; v < MLP_GROUP / 4; ++v) {
            const float4 wv = __ldg(row + v);
            acc[4 * v] = fmaf(a, wv.x, acc[4 * v]);
            acc[4 * v + 1] = fmaf(a, wv.y, acc[4 * v + 1]);
            acc[4 * v + 2] = fmaf(a, wv.z, acc[4 * v + 2]);
            acc[4 * v + 3] = fmaf(a, wv.w, acc[4 * v + 3]);
          }
        }
#pragma unroll
        for (int q = 0; q < MLP_GROUP; ++q) {
          const float z = acc[q] + __ldg(b + j + q);
          h[out + j + q] = l + 1 < layers ? tanhf(z) : z;
        }
      }
      in = out;
      w = b + p;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < nx) {
        const float v = xs[i] + h[in + i];
        x[i] = (wrap >> i) & 1 ? Pendulum::angle_normalize(v) : v;
      }
    }
  }
  template <int N>
  __device__ static float cost(const float* c, const float* x, const float* u, int nx, int nu) {
    if (c[11] == 0.0f) return Pendulum::cost<N>(c, x, u, nx, nu);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < nx) {
        const float d = c[12 + i] - x[i];
        s += d * d;
      }
    }
    return s;
  }
};

// The final-state terminal cost (ops/kernel_models.quadratic_terminal):
// w_state |x_T - goal|^2 + w_action |u_T|^2 on the final state and the last
// u_scale-scaled action, as JAX's _tp_rollout_total (pallas_rollout.py:413-442)
// adds it; c = goal (nx), w_state, w_action.  Kernel A and the batched kernel
// add it when p.terminal is set, so it needs no instantiation of its own.
template <int N>
__device__ __forceinline__ float quadratic_terminal(const float* c, const float* x, const float* u,
                                                    int nx, int nu) {
  float sx = 0.0f, su = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < nx) {
      const float d = x[i] - c[i];
      sx += d * d;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < nu) su += u[j] * u[j];
  return c[nx] * sx + c[nx + 1] * su;
}

constexpr int MERGE_LOADS = 16;  // partials a thread of merge_partials reads at once

// Merges `nblocks` partials (m_b, s_b, acc_b[0..R)) with the block's threads
// into column `plant` of delta (R, plants) and ms (2, plants): m = max m_b;
// each partial's scale e^(m_b - m) once, into `scale`, `chunk` partials at a
// time; s = sum s_b e^(m_b - m); for delta, G groups of `rows` threads: thread
// d of group g sums acc_b[d] times the scales over b = g, g + G, ... (reading
// the partials coalesced across d), and group 0 adds the G sums.  `part`
// holds blockDim.x floats and `red` blockDim.x / 32.  The partials are read
// from L2 (another block of the same launch may have written them).  Every
// thread of the block must call it.
__device__ __forceinline__ void merge_partials(const float* partial, int nblocks, int R,
                                               float* delta, float* ms, int plant, int plants,
                                               float* scale, int chunk, float* part, float* red) {
  const int threads = blockDim.x, tid = threadIdx.x, stride = R + 2;
  const int rows = R < threads ? R : threads;
  const int G = threads / rows, g = tid / rows, dl = tid - g * rows;
  float m = -INFINITY;
  for (int b = tid; b < nblocks; b += threads) m = fmaxf(m, __ldcg(partial + (size_t)b * stride));
  m = block_reduce<true>(m, red);
  float s = 0.0f;
  for (int c0 = 0; c0 < nblocks; c0 += chunk) {
    const int n = nblocks - c0 < chunk ? nblocks - c0 : chunk;
    const float* part_c = partial + (size_t)c0 * stride;
    if (c0 > 0) __syncthreads();  // the previous chunk's scales are read
    for (int b = tid; b < n; b += threads) {
      const float sc = expf(__ldcg(part_c + (size_t)b * stride) - m);
      scale[b] = sc;
      s += __ldcg(part_c + (size_t)b * stride + 1) * sc;
    }
    __syncthreads();
    for (int d0 = 0; d0 < R; d0 += rows) {
      const int d = d0 + dl;
      float acc = 0.0f;
      if (g < G && d < R) {
        // MERGE_LOADS independent sums keep as many L2 loads in flight
        const float* col = part_c + 2 + d;
        float sums[MERGE_LOADS];
#pragma unroll
        for (int u = 0; u < MERGE_LOADS; ++u) sums[u] = 0.0f;
        int b = g;
        for (; b + (MERGE_LOADS - 1) * G < n; b += MERGE_LOADS * G) {
#pragma unroll
          for (int u = 0; u < MERGE_LOADS; ++u)
            sums[u] = fmaf(__ldcg(col + (size_t)(b + u * G) * stride), scale[b + u * G], sums[u]);
        }
        for (; b < n; b += G) sums[0] = fmaf(__ldcg(col + (size_t)b * stride), scale[b], sums[0]);
#pragma unroll
        for (int u = 0; u < MERGE_LOADS; ++u) acc += sums[u];
      }
      part[tid] = acc;
      __syncthreads();
      if (g == 0 && d < R) {
        float sum = c0 > 0 ? delta[(size_t)d * plants + plant] : 0.0f;
        for (int h = 0; h < G; ++h) sum += part[h * rows + dl];
        delta[(size_t)d * plants + plant] = sum;
      }
      __syncthreads();
    }
  }
  s = block_reduce<false>(s, red);
  if (tid == 0) {
    ms[plant] = m;
    ms[plants + plant] = s;
  }
}

// --- kernel A ---------------------------------------------------------------

// Sample k's R drawn rows, the antithetic sign times the normal, into z[0],
// z[ldt], ... from the injected bits or from Philox.  Antithetic pairing
// inside each pairing block (pallas_rollout.py:403-404): sample j of block b
// takes source column b*bh + j, or the mirrored draw of j - bh.  The draw
// depends on the source column only, so the plants of a batch share it
// (mppi.py:837-838).
__device__ __forceinline__ void source_of(const Params& p, int k, int& src, float& sgn) {
  k += p.k_offset;
  src = k;
  sgn = 1.0f;
  if (p.antithetic) {
    const int b = k / p.pair_block, j = k % p.pair_block, bh = p.pair_block / 2;
    src = b * bh + (j < bh ? j : j - bh);
    if (j >= bh) sgn = -1.0f;
  }
}

__device__ __forceinline__ void draw_column(const Params& p, uint2 key, int k, float* z,
                                            int ldt) {
  const int R = p.R;
  int src;
  float sgn;
  source_of(p, k, src, sgn);
  if (p.bits) {
    for (int d = 0; d < R; ++d)
      z[d * ldt] = sgn * bits_to_normal((unsigned)p.bits[(size_t)d * p.bits_cols + src]);
  } else {
    for (int g = 0; 4 * g < R; ++g) {
      const uint4 r = philox4x32_10(make_uint4((unsigned)src, (unsigned)g, 0u, 0u), key.x, key.y);
      const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (4 * g + w < R) z[(4 * g + w) * ldt] = sgn * bits_to_normal(words[w]);
    }
  }
}

constexpr int ROW_TILE = 8;  // rows of a thread's register tile in tile_product
constexpr int MERGE_CHUNK_A = 512;  // block scales kernel A's merge holds at a time

// Kernel A stages the row vectors it reads in shared memory, NVEC of D floats:
enum RowVector { kU, kA, kOp, kMu, kLo, kHi, kBase, kAlo, kAhi, NVEC };

// Floats of kernel A's dynamic shared memory before its operator panel and
// its row vectors: the reduction slots (32), the softmax weights (BLOCK), the
// threads' partial sums (BLOCK) and the merge's block scales.
constexpr int PARTIAL_HEAD = 32 + 2 * BLOCK + MERGE_CHUNK_A;

// Kernel A's (D, S) tiles: MPPI with a diagonal scale keeps everything in
// one; a full operator (and the round-1 solve), SMPPI and KMPPI take two.
__host__ __device__ constexpr int partial_tiles(int variant, int full_op) {
  return variant == kMPPI && !full_op ? 1 : 2;
}

// Loads kStep consecutive floats (one 8- or 16-byte shared-memory load where
// kStep is 2 or 4).
template <int kStep>
__device__ __forceinline__ void load_step(const float* m, float* v) {
  if constexpr (kStep == 4) {
    const float4 q = *reinterpret_cast<const float4*>(m);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (kStep == 2) {
    const float2 q = *reinterpret_cast<const float2*>(m);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *m;
  }
}

// A panel of tile_product: ROW_TILE rows for each of the BLOCK / S threads
// of a sample, PANEL_COLS columns.
constexpr int PANEL_COLS = 160;
__host__ __device__ constexpr int panel_rows(int S) { return BLOCK / S * ROW_TILE; }

// Floats of kernel A's operator panel: where it computes a product (a full
// operator, or KMPPI's interpolation), panel_rows(S) rows of up to
// PANEL_COLS of the R columns, rounded up to 16 bytes.
__host__ __device__ constexpr size_t panel_floats(int variant, int full_op, int R, int S) {
  return full_op || variant == kKMPPI
             ? ((size_t)panel_rows(S) * (R < PANEL_COLS ? R : PANEL_COLS) + 3) / 4 * 4
             : 0;
}

// acc[q] += sum_e panel[g0 + q*G, e] in[e, s] over the panel's `cols`
// columns (row stride `cols`), kStep columns a load.
template <int kStep>
__device__ __forceinline__ void panel_accumulate(const float* panel, int prows, int cols,
                                                 const float* in, int ldt, int S,
                                                 float (&acc)[ROW_TILE]) {
  const int s = threadIdx.x % S, G = BLOCK / S, g0 = threadIdx.x / S;
  const float* mrow[ROW_TILE];
#pragma unroll
  for (int q = 0; q < ROW_TILE; ++q) {
    const int r = g0 + q * G;
    mrow[q] = panel + (r < prows ? r : 0) * cols;  // a row past the panel is not written
  }
  for (int e = 0; e < cols; e += kStep) {
    float z[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j) z[j] = in[(e + j) * ldt + s];
#pragma unroll
    for (int q = 0; q < ROW_TILE; ++q) {
      float m[kStep];
      load_step<kStep>(mrow[q] + e, m);
#pragma unroll
      for (int j = 0; j < kStep; ++j) acc[q] = fmaf(m[j], z[j], acc[q]);
    }
  }
}

// out[d, s] = sum_e M[d, e] in[e, s] (+ add[d]) for d < rows and the block's
// S samples, fp32 FMAs in the order of e.  M (row-major, rows x cols) is
// streamed through shared memory in panels of panel_rows(S) rows and
// PANEL_COLS columns, each copied by all threads (16-byte loads where the
// rows allow, all in flight together), then read as broadcasts.  Thread t
// takes sample s = t % S and the panel's rows t / S, t / S + G, ...
// (G = BLOCK / S), ROW_TILE of them in registers, so that each in[e, s] read
// from the tile feeds ROW_TILE FMAs.  A thread writes only the (row, sample)
// pairs that the other passes of kernel A give it.  Every thread of the block
// must call it.
__device__ __forceinline__ void tile_product(const float* __restrict__ M, int rows, int cols,
                                             const float* in, float* out, int ldt,
                                             const float* add, int S, float* panel) {
  const int tid = threadIdx.x, G = BLOCK / S, g0 = tid / S, s = tid % S, per = panel_rows(S);
  const bool vec4 = cols % 4 == 0 && reinterpret_cast<uintptr_t>(M) % 16 == 0;
  for (int p0 = 0; p0 < rows; p0 += per) {
    const int prows = rows - p0 < per ? rows - p0 : per;
    float acc[ROW_TILE];
#pragma unroll
    for (int q = 0; q < ROW_TILE; ++q) acc[q] = 0.0f;
    for (int e0 = 0; e0 < cols; e0 += PANEL_COLS) {
      const int pc = cols - e0 < PANEL_COLS ? cols - e0 : PANEL_COLS;
      const float* src = M + (size_t)p0 * cols + e0;
      // whole rows are contiguous; a panel of part of each row walks its
      // (row, column) pairs without dividing
      const int w = vec4 ? 4 : 1, units = pc / w;  // loads a panel row
      if (pc == cols) {
        for (int i = tid; i < prows * units; i += BLOCK) {
          if (vec4)
            reinterpret_cast<float4*>(panel)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
          else
            panel[i] = __ldg(src + i);
        }
      } else {
        int r = tid / units, c = tid - r * units;
        for (int i = tid; i < prows * units; i += BLOCK) {
          if (vec4)
            reinterpret_cast<float4*>(panel)[i] =
                __ldg(reinterpret_cast<const float4*>(src + (size_t)r * cols) + c);
          else
            panel[i] = __ldg(src + (size_t)r * cols + c);
          for (c += BLOCK; c >= units; c -= units) ++r;
        }
      }
      __syncthreads();
      const float* in_e = in + e0 * ldt;
      if (cols % 4 == 0)
        panel_accumulate<4>(panel, prows, pc, in_e, ldt, S, acc);
      else if (cols % 2 == 0)
        panel_accumulate<2>(panel, prows, pc, in_e, ldt, S, acc);
      else
        panel_accumulate<1>(panel, prows, pc, in_e, ldt, S, acc);
      __syncthreads();  // the panel is read before the next one is copied
    }
#pragma unroll
    for (int q = 0; q < ROW_TILE; ++q) {
      const int r = g0 + q * G, d = p0 + r;
      if (r < prows) out[d * ldt + s] = add ? acc[q] + add[d] : acc[q];
    }
  }
}

// Sample k's cost: `pc`, the action cost of its rectified noise, plus the
// T-step rollout of the device model over its actions (column `col` of a
// tile with row stride ldt) from its column of x0; SMPPI adds the
// smoothness cost on the action rows.  Called with nx = nu = N as constants,
// the model's loops and constant offsets are fixed when it is compiled.
template <class Model, int N, int V>
__device__ __forceinline__ float sample_cost(const Params& p, const float* col, int ldt, int k,
                                             float pc, int nx, int nu) {
  float x[N], u[N], prev[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = i < nx ? p.x0[i * p.x0_row_stride + (long long)k * p.x0_col_stride] : 0.0f;
    prev[i] = 0.0f;
  }
  float total = 0.0f, smooth = 0.0f;
  for (int t = 0; t < p.T; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float act = 0.0f;
      if (j < nu) {
        act = col[(t * nu + j) * ldt];
        if (V == kSMPPI) {
          // smoothness on the previous action row (mppi.py:558-562)
          if (t > 0) {
            float df = act - prev[j];
            if (p.u_scale != 1.0f) df *= p.u_scale;
            smooth += df * df;
          }
          prev[j] = act;
        }
      }
      u[j] = act * p.u_scale;
    }
    Model::template step<N>(p.consts, x, u, nx, nu);
    total += Model::template cost<N>(p.consts, x, u, nx, nu);
  }
  if (p.terminal) total += quadratic_terminal<N>(p.terminal, x, u, nx, nu);
  return (V == kSMPPI ? pc + *p.w_seq * smooth : pc) + total;
}

// Kernel A: one MPPI, SMPPI or KMPPI iteration (or the round-1 solve, kMPPI
// with `rowmajor`) over the S = p.S samples [k0, k0 + S) of block b, k0 = b*S,
// with BLOCK threads.  Thread t owns sample s = t % S and the rows t / S,
// t / S + G, ... (G = BLOCK / S) of the block's (D, S) tiles in every pass
// but the rollout:
//   1. the draw: the R rows of normals of the S samples (a Philox call for
//      four rows of one sample, or the sample's bits), the antithetic sign;
//   2. the transform: the diagonal scale in place, or op @ z + mu as a tiled
//      product into the second tile (the round-1 solve: chol @ z_t + mu);
//   3. the variant's clamps, the null row (MPPI: the elite rows), the perturbed output, and the
//      action cost of the rectified noise, summed over the thread's rows;
//      SMPPI stores the actions in one tile and its rate-space noise
//      (v - as)/dt - U in the other; KMPPI clamps the support points and
//      interpolates them as a tiled product W @ pts into the second tile;
//   4. the rollout, one thread per sample (threads t < S), which adds the
//      G partial action costs of its sample in a fixed order;
//   5. m_b and s_b by warp shuffles;
//   6. acc_b[r] = sum_s w_s upd[r, s] (upd: v - U, the stored rate-space
//      noise, or pts - theta) by groups of threads over rows and samples;
//   7. the partial goes to (nblocks, R + 2); the last block to finish (a
//      ticket from p.counter) merges every partial into delta and (m, s)
//      and sets the counter back to 0.
// Samples at and beyond K draw zeros, weigh exactly 0 and write nothing.
// The launch bounds ask for two blocks an SM (the flagship's 313 blocks take
// two or three an SM; a D = 300 tile allows two), which lets ptxas keep more
// of the products' operands in registers.  With BLOCK alone, ptxas gave the
// nx = 2, nu = 3 MPPI instantiation fewer registers once the terminal cost
// was added, and its D = 300 full-operator call took 1.13x as long
// (tools/batched_host_ab.py on an H100; PERF.md has the times).
template <class Model, int N, bool kGlobal, int V>
__global__ void __launch_bounds__(BLOCK, 2) mppi_fused_partial(Params p) {
  extern __shared__ float smem[];
  __shared__ int ticket;
  const int D = p.D, R = p.R, S = p.S, G = BLOCK / S, tid = threadIdx.x;
  const int ldt = kGlobal ? S : S + 1;  // row stride of the tiles
  const int s = tid % S, g0 = tid / S;  // the thread's sample and first row
  const int k0 = blockIdx.x * S, k = k0 + s;
  const bool live = k < p.K;
  const bool rowmajor = V == kMPPI && p.rowmajor;
  float* red = smem;  // 32 reduction slots
  float* ws = red + 32;  // S softmax weights
  float* part = ws + BLOCK;  // BLOCK partial sums: the action costs, then the update's
  float* scale = part + BLOCK;  // MERGE_CHUNK_A
  float* panel = smem + PARTIAL_HEAD;  // the products' operator panel, 16-byte aligned
  float* vec = panel + panel_floats(V, p.full_op, R, S);  // (NVEC, D) row vectors
  float* ta = kGlobal ? p.scratch + (size_t)blockIdx.x * partial_tiles(V, p.full_op) * D * S
                      : vec + (size_t)NVEC * D;
  float* tb = ta + (size_t)D * ldt;
  const float *vU = vec + kU * D, *vA = vec + kA * D, *vOp = vec + kOp * D,
              *vMu = vec + kMu * D, *vLo = vec + kLo * D, *vHi = vec + kHi * D,
              *vBase = vec + kBase * D, *vAlo = vec + kAlo * D, *vAhi = vec + kAhi * D;

  // 0. the row vectors, one load each, all in flight together (the round-1
  // solve's per-step mu, lo and hi repeated over the steps)
  for (int d = tid; d < D; d += BLOCK) {
    const int dv = rowmajor ? d % p.nu : d;
    vec[kU * D + d] = p.U[d];
    vec[kA * D + d] = p.a[d];
    if (d < R) {
      if (!p.full_op) vec[kOp * D + d] = p.op[d];
      vec[kMu * D + d] = p.mu[dv];
      vec[kLo * D + d] = p.lo[dv];
      vec[kHi * D + d] = p.hi[dv];
      if (V != kMPPI) vec[kBase * D + d] = p.base[d];
    }
    if (V != kMPPI) {
      vec[kAlo * D + d] = p.alo[d];
      vec[kAhi * D + d] = p.ahi[d];
    }
  }

  // 1. the draw, into ta
  if (rowmajor && p.bits) {
    // the block's S rows of the (K_pad, D) bits are contiguous: read them
    // coalesced and store them transposed into the tile
    const int* rows = p.bits + (size_t)k0 * D;
    for (int i = tid; i < S * D; i += BLOCK) {
      const int r = i / D;
      ta[(i - r * D) * ldt + r] = k0 + r < p.K ? bits_to_normal((unsigned)rows[i]) : 0.0f;
    }
  } else {
    int src;
    float sgn;
    source_of(p, k, src, sgn);
    if (p.bits) {
      for (int d = g0; d < R; d += G)
        ta[d * ldt + s] =
            live ? sgn * bits_to_normal((unsigned)p.bits[(size_t)d * p.bits_cols + src]) : 0.0f;
    } else {
      const uint2 key = philox_key(p.key, p.key0, p.key1);
      for (int q = g0; 4 * q < R; q += G) {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (live) {
          const uint4 r =
              philox4x32_10(make_uint4((unsigned)src, (unsigned)q, 0u, 0u), key.x, key.y);
          v[0] = sgn * bits_to_normal(r.x);
          v[1] = sgn * bits_to_normal(r.y);
          v[2] = sgn * bits_to_normal(r.z);
          v[3] = sgn * bits_to_normal(r.w);
        }
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (4 * q + w < R) ta[(4 * q + w) * ldt + s] = v[w];
      }
    }
  }
  __syncthreads();

  // 2. the noise n, in nt
  float* nt = ta;
  if (rowmajor) {
    // chol @ z_t + mu for timestep t (pallas_rollout.py:1627-1630)
    const int nu = p.nu;
    for (int d = g0; d < D; d += G) {
      const int t = d / nu, dv = d - t * nu;
      const float* crow = p.op + dv * nu;
      const float* zt = ta + (size_t)t * nu * ldt + s;
      float acc = 0.0f;
      for (int j = 0; j < nu; ++j) acc += crow[j] * zt[j * ldt];
      tb[d * ldt + s] = acc + vMu[d];
    }
    nt = tb;
  } else if (p.full_op) {
    tile_product(p.op, R, R, ta, tb, ldt, vMu, S, panel);
    nt = tb;
  } else {
#pragma unroll 4
    for (int d = g0; d < R; d += G) ta[d * ldt + s] = ta[d * ldt + s] * vOp[d] + vMu[d];
  }
  float* other = nt == ta ? tb : ta;
  if (nt == tb) __syncthreads();  // the products have read ta before it is written

  // 3. the variant's rows and the action cost of the rectified noise; vt
  // holds the actions the rollout reads
  float pc = 0.0f;
  float* vt = nt;
  if (V == kKMPPI) {
    // support points, clamped (mppi.py:657-664), then each full-horizon
    // row W[d, :] . pts, the null row and the trajectory clamp
#pragma unroll 4
    for (int d = g0; d < R; d += G)
      nt[d * ldt + s] = fminf(fmaxf(vBase[d] + nt[d * ldt + s], vLo[d]), vHi[d]);
    __syncthreads();
    tile_product(p.W, D, R, nt, other, ldt, nullptr, S, panel);
#pragma unroll 4
    for (int d = g0; d < D; d += G) {
      float act = null_row(p, k) ? 0.0f : other[d * ldt + s];
      act = fminf(fmaxf(act, vAlo[d]), vAhi[d]);
      if (p.pert && live) p.pert[(size_t)d * p.K + k] = act;
      const float r = act - vU[d];
      pc += (p.abs_cost ? fabsf(r) : r) * vA[d];
      other[d * ldt + s] = act;
    }
    vt = other;
  } else if (V == kSMPPI) {
    // rate clamp, integrate, null row, action clamp (mppi.py:539-552); the
    // actions go to the other tile, the noise through both clamps stays in nt
    const float dt = *p.dt;
#pragma unroll 4
    for (int d = g0; d < R; d += G) {
      const float u0 = vU[d], as = vBase[d];
      const float rate = fminf(fmaxf(u0 + nt[d * ldt + s], vLo[d]), vHi[d]);
      float v = __fadd_rn(as, __fmul_rn(rate, dt));  // two roundings, as as + rate*dt
      if (null_row(p, k)) v = 0.0f;
      v = fminf(fmaxf(v, vAlo[d]), vAhi[d]);
      if (p.pert && live) p.pert[(size_t)d * p.K + k] = v;
      const float r = (v - as) / dt - u0;  // mppi.py:552
      pc += (p.abs_cost ? fabsf(r) : r) * vA[d];
      other[d * ldt + s] = v;
      nt[d * ldt + s] = r;
    }
    vt = other;
  } else {
    // the elite row of a sample in [elite_off, elite_off + num_elites), by
    // its global index k (the window spans blocks of S samples); it takes
    // the place of U + noise before the clamp, the draw kept
    const float* erow = nullptr;
    if (p.num_elites) {
      const int j = k - p.elite_off;
      if (j >= 0 && j < p.num_elites) erow = p.elites + (size_t)j * D;
    }
#pragma unroll 4
    for (int d = g0; d < R; d += G) {
      const float u0 = vU[d];
      float v = u0 + nt[d * ldt + s];
      if (null_row(p, k)) v = 0.0f;
      if (erow) v = __ldg(erow + d);
      v = fminf(fmaxf(v, vLo[d]), vHi[d]);
      if (p.pert && live) p.pert[(size_t)d * p.K + k] = v;
      const float r = v - u0;  // rectified noise (mppi.py:383-385)
      pc += (p.abs_cost ? fabsf(r) : r) * vA[d];
      nt[d * ldt + s] = v;
    }
  }
  part[tid] = pc;
  __syncthreads();

  // 4. the rollout, one thread per sample
  float logit = -INFINITY;
  if (tid < S && live) {
    float pcs = part[tid];
    for (int j = 1; j < G; ++j) pcs += part[j * S + tid];
    // the N = 2 arrays also hold a rollout with nx = nu = 2 as constants
    bool exact = false;
    if constexpr (N == 2) exact = p.nx == 2 && p.nu == 2;
    const float c = exact ? sample_cost<Model, N, V>(p, vt + tid, ldt, k, pcs, N, N)
                          : sample_cost<Model, N, V>(p, vt + tid, ldt, k, pcs, p.nx, p.nu);
    p.cost[k] = c;
    logit = -c / *p.lam;
  }

  // 5. the block's softmax statistics
  const float m_b = block_reduce<true>(logit, red);
  const float w = (tid < S && live && m_b > -INFINITY) ? expf(logit - m_b) : 0.0f;
  if (tid < S) ws[tid] = w;  // published by the reduction's barrier
  const float s_b = block_reduce<false>(w, red);
  float* out = p.partial + (size_t)blockIdx.x * (R + 2);
  if (tid == 0) {
    out[0] = m_b;
    out[1] = s_b;
  }

  // 6. the update: GU groups of `rows` threads (a multiple of 32) take a row
  // each and S / GU samples
  const int rows = ((R + 31) / 32) * 32 < BLOCK ? ((R + 31) / 32) * 32 : BLOCK;
  const int GU = BLOCK / rows, gu = tid / rows, dl = tid - gu * rows, span = S / GU;
  for (int d0 = 0; d0 < R; d0 += rows) {
    const int d = d0 + dl;
    float acc = 0.0f;
    if (d < R) {
      const float* row = nt + d * ldt + gu * span;
      const float* wg = ws + gu * span;
      if (V == kSMPPI) {
        for (int i = 0; i < span; ++i) acc = fmaf(wg[i], row[i], acc);
      } else {
        const float b0 = V == kMPPI ? vU[d] : vBase[d];
        for (int i = 0; i < span; ++i) acc = fmaf(wg[i], row[i] - b0, acc);
      }
    }
    part[tid] = acc;
    __syncthreads();
    if (gu == 0 && d < R) {
      float sum = part[dl];
      for (int h = 1; h < GU; ++h) sum += part[h * rows + dl];
      out[2 + d] = sum;
    }
    __syncthreads();  // part is read before it is written again
  }

  // 7. the last block to finish merges the partials
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(p.counter, 1);
  __syncthreads();
  if (ticket != p.nblocks - 1) return;
  __threadfence();
  merge_partials(p.partial, p.nblocks, R, p.delta, p.ms, 0, 1, scale, MERGE_CHUNK_A, part, red);
  if (tid == 0) *p.counter = 0;  // ready for the next launch
}

// --- the batched iteration -------------------------------------------------------

// Floats of batched_partial's dynamic shared memory before its tiles: the
// softmax weights and the update's partial sums (BLOCK each), the reduction
// slots (32), and two buffers of R float4s (U, lo, hi, a) for the current
// and the next plant.  Its shared tiles have rows of BATCHED_LDT floats, 16
// bytes aligned, which the update reads four floats at a time without bank
// conflicts.
__host__ __device__ constexpr size_t batched_head(int R) { return 2 * BLOCK + 32 + 8 * (size_t)R; }
constexpr int BATCHED_LDT = BLOCK + 4;

// A 4-byte copy from global to shared memory that completes in the
// background (cp.async) until async_wait; a plain copy where there is none.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

// Waits for this thread's copy_async copies.
__device__ __forceinline__ void async_wait() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// A 16-byte copy_async (both addresses 16-byte aligned), bypassing L1.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

// Closes this thread's group of copy_async copies issued since the last one.
__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most `n` of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void async_wait_group() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
#endif
}

// Plant `plant`'s cost of the sample in column `col` of the noise tile: the
// clamp of U + n against lo and hi, the action cost of the rectified noise,
// and the T-step rollout from the plant's x0.  Called with nx = nu = N as
// constants, the device model's loops and constant offsets are fixed when it
// is compiled, so its constants stay in registers across the steps.
template <class Model, int N, int LDT>
__device__ __forceinline__ float batched_cost(const Params& p, const float4* cur, const float* col,
                                              int plant, int nx, int nu) {
  float x[N], u[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = i < nx ? p.x0[i * p.x0_row_stride + plant * p.x0_col_stride] : 0.0f;
  float pc = 0.0f, total = 0.0f;  // action cost of the rectified noise, running cost
  for (int t = 0; t < p.T; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float act = 0.0f;
      if (j < nu) {
        const int d = t * nu + j;
        const float4 c = cur[d];  // U, lo, hi, a
        act = fminf(fmaxf(c.x + col[d * LDT], c.y), c.z);
        const float r = act - c.x;  // rectified noise (mppi.py:383-385)
        pc += (p.abs_cost ? fabsf(r) : r) * c.w;
      }
      u[j] = act * p.u_scale;
    }
    Model::template step<N>(p.consts, x, u, nx, nu);
    total += Model::template cost<N>(p.consts, x, u, nx, nu);
  }
  if (p.terminal) total += quadratic_terminal<N>(p.terminal, x, u, nx, nu);
  return pc + total;
}

// make_transposed_batched_solve's kernel.  Block b of the grid takes the
// BLOCK samples of K block kb = b / groups and the plants [g*P, g*P + P) of
// group g = b % groups (P = p.plant_group, groups = ceil(N / P)).  It stages
// the final noise n[d, k] of its samples, which no plant changes, once in an
// (R, LDT) tile: drawn and transformed, or copied from the (R, noise_ld)
// operand.  Then for each plant of its group (whose U and action-cost
// columns were fetched in the background during the previous plant), thread
// k clamps U_n + n[:, k], charges the action cost of the rectified noise,
// rolls the model out from the plant's x0 in registers and writes
// cost[n, k]; the block reduces m_b and s_b with warp shuffles; and for
// acc_b[d] = sum_k w_k (clamp(U_n[d] + n[d, k]) - U_n[d]), recomputed with
// the first pass's float operations, G groups of `rows` threads take a row
// each and BLOCK / G samples, and group 0 adds the G sums into
// partial[n, kb].
template <class Model, int N, bool kGlobal>
__global__ void __launch_bounds__(BLOCK) batched_partial(Params p) {
  constexpr int LDT = kGlobal ? BLOCK : BATCHED_LDT;  // row stride of the tiles
  extern __shared__ float smem[];
  const int R = p.R, tid = threadIdx.x;
  const int groups = (p.num_plants + p.plant_group - 1) / p.plant_group;
  const int kb = blockIdx.x / groups, group = blockIdx.x % groups;
  const int k0 = kb * BLOCK, k = k0 + tid;
  const bool live = k < p.K;
  float* ws = smem;  // BLOCK softmax weights
  float* part = ws + BLOCK;  // BLOCK partial sums of the update
  float* red = part + BLOCK;  // 32 reduction slots
  float4* pk = reinterpret_cast<float4*>(red + 32);  // (2, R): U, lo, hi, a of a plant
  float* nt = kGlobal ? p.scratch + (size_t)blockIdx.x * (p.full_op ? 2 : 1) * R * BLOCK
                      : smem + batched_head(R);  // (R, LDT) final noise
  float* zs = nt + (size_t)R * LDT;  // (R, LDT) raw normals, full op only
  // the update's layout: G groups of `rows` threads (a multiple of 32)
  const int rows = ((R + 31) / 32) * 32 < BLOCK ? ((R + 31) / 32) * 32 : BLOCK;
  const int G = BLOCK / rows, g = tid / rows, dl = tid - g * rows, span = BLOCK / G;

  const int first = group * p.plant_group;
  const int last = first + p.plant_group < p.num_plants ? first + p.plant_group : p.num_plants;
  const auto fetch = [&](int plant, float4* buf) {
    for (int d = tid; d < R; d += BLOCK) {
      float* e = reinterpret_cast<float*>(buf + d);
      copy_async(e, p.U + d * p.u_rs + plant * p.u_ps);
      copy_async(e + 1, p.lo + d);
      copy_async(e + 2, p.hi + d);
      copy_async(e + 3, p.a + d * p.a_rs + plant * p.a_ps);
    }
  };
  fetch(first, pk);
  const uint2 key = philox_key(p.key, p.key0, p.key1);

  if (p.noise) {
    // the operand's (R, BLOCK) slice, 16 bytes a load where the rows allow;
    // columns at and beyond K are 0
    const float* src = p.noise + k0;
    const int cols = p.K - k0 < BLOCK ? p.K - k0 : BLOCK;
    if (p.noise_ld % 4 == 0 && reinterpret_cast<uintptr_t>(p.noise) % 16 == 0) {
      for (int i = tid; i < R * (BLOCK / 4); i += BLOCK) {
        const int d = i / (BLOCK / 4), c = 4 * (i % (BLOCK / 4));
        const float* row = src + (size_t)d * p.noise_ld + c;
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (c + 4 <= cols) {
          q = *reinterpret_cast<const float4*>(row);
        } else {
          float* v = &q.x;
          for (int j = 0; c + j < cols; ++j) v[j] = row[j];
        }
        *reinterpret_cast<float4*>(nt + d * LDT + c) = q;
      }
    } else {
      for (int i = tid; i < R * BLOCK; i += BLOCK) {
        const int d = i / BLOCK, c = i % BLOCK;
        nt[d * LDT + c] = c < cols ? src[(size_t)d * p.noise_ld + c] : 0.0f;
      }
    }
  } else if (!p.full_op) {
    if (live) {
      draw_column(p, key, k, nt + tid, LDT);
      for (int d = 0; d < R; ++d) nt[d * LDT + tid] = nt[d * LDT + tid] * p.op[d] + p.mu[d];
    } else {
      for (int d = 0; d < R; ++d) nt[d * LDT + tid] = 0.0f;
    }
  } else {
    // op @ z + mu on the thread's own column
    if (live) draw_column(p, key, k, zs + tid, LDT);
    for (int d = 0; d < R; ++d) {
      float n = 0.0f;
      if (live) {
        float acc = 0.0f;
        const float* row = p.op + (size_t)d * R;
        for (int e = 0; e < R; ++e) acc += row[e] * zs[e * LDT + tid];
        n = acc + p.mu[d];
      }
      nt[d * LDT + tid] = n;
    }
  }

  const float lam = *p.lam;
  // the N = 2 arrays also hold a rollout with nx = nu = 2 as constants (the
  // linear and toy2d plants); the larger arrays compile only the generic one
  bool exact = false;
  if constexpr (N == 2) exact = p.nx == 2 && p.nu == 2;
  for (int plant = first; plant < last; ++plant) {
    const float4* cur = pk + ((plant - first) & 1) * R;
    async_wait();
    __syncthreads();  // the tile and this plant's columns are in; the previous update is done
    if (plant + 1 < last) fetch(plant + 1, pk + ((plant - first + 1) & 1) * R);
    float logit = -INFINITY;
    if (live) {
      const float c = exact ? batched_cost<Model, N, LDT>(p, cur, nt + tid, plant, N, N)
                            : batched_cost<Model, N, LDT>(p, cur, nt + tid, plant, p.nx, p.nu);
      p.cost[(size_t)plant * p.K + k] = c;
      logit = -c / lam;
    }
    const float m_b = block_reduce<true>(logit, red);
    const float w = (live && m_b > -INFINITY) ? expf(logit - m_b) : 0.0f;
    ws[tid] = w;  // published by the reduction's barrier
    const float s_b = block_reduce<false>(w, red);
    float* out = p.partial + ((size_t)plant * p.nblocks + kb) * (R + 2);
    if (tid == 0) {
      out[0] = m_b;
      out[1] = s_b;
    }
    for (int d0 = 0; d0 < R; d0 += rows) {
      const int d = d0 + dl;
      float acc = 0.0f;
      if (g < G && d < R) {
        const float4 c = cur[d];
        const float4* row = reinterpret_cast<const float4*>(nt + d * LDT + g * span);
        const float4* wg = reinterpret_cast<const float4*>(ws + g * span);
        for (int i = 0; i < span / 4; ++i) {
          const float4 n = row[i], w = wg[i];
          acc = fmaf(w.x, fminf(fmaxf(c.x + n.x, c.y), c.z) - c.x, acc);
          acc = fmaf(w.y, fminf(fmaxf(c.x + n.y, c.y), c.z) - c.x, acc);
          acc = fmaf(w.z, fminf(fmaxf(c.x + n.z, c.y), c.z) - c.x, acc);
          acc = fmaf(w.w, fminf(fmaxf(c.x + n.w, c.y), c.z) - c.x, acc);
        }
      }
      part[tid] = acc;
      __syncthreads();
      if (g == 0 && d < R) {
        float sum = part[dl];
        for (int h = 1; h < G; ++h) sum += part[h * rows + dl];
        out[2 + d] = sum;
      }
      if (d0 + rows < R) __syncthreads();  // part is read before the next rows
    }
  }
}

// --- the legacy route's rollout ------------------------------------------------

// Floats of a row of the rollout's staged tile for `cols` columns: cols
// rounded up to q float4s, q odd.  A thread reads its own row four floats at
// a time; a 16-byte shared load is served eight lanes at once, and lane s of
// those eight hits the 16-byte bank group (s * q + g) mod 8 for the row's
// float4 g, all eight distinct when q is odd: the reads of step t are free of
// bank conflicts.  At D = 60 the row is its 60 floats (q = 15), and the
// block's rows stay one contiguous span; a scalar read at that stride would
// be a 4-way conflict (gcd(60, 32) = 4).  At D = 15 the row takes 20 floats.
__host__ __device__ constexpr int rollout_ldr(int cols) { return (((cols + 3) / 4) | 1) * 4; }

// The rollout stages at most ROLLOUT_SMEM bytes a block (no opt-in to more
// than 48 KB, so that several blocks share an SM).
constexpr int ROLLOUT_SMEM = 48 * 1024;

// `steps` steps of one sample from its staged row: the actions of step t are
// columns t * nu .. t * nu + nu - 1, read as the float4 that holds each (one
// load a float4 where nu is a multiple of 4, or where the compiler merges the
// steps of one float4).  The running cost is taken after each step.
template <class Model, int N>
__device__ __forceinline__ float rollout_steps(const Params& p, const float* row, int steps,
                                               float* x, float* u, float total, int nx, int nu) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < nu) {
        const int e = t * nu + j, w = e & 3;
        const float4 q = row4[e >> 2];
        u[j] = w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
      }
    }
    Model::template step<N>(p.consts, x, u, nx, nu);
    total += Model::template cost<N>(p.consts, x, u, nx, nu);
  }
  return total;
}

// make_fused_rollout's kernel: block b takes the S = p.S samples
// [k0, k0 + S), k0 = b * S, with BLOCK threads.  The block's rows of the
// (K, D) scaled actions are one contiguous span; all BLOCK threads stage it in
// shared memory with cp.async, every copy in flight at once (16 bytes a copy
// where p.vec4: D a multiple of 4 and the base 16-byte aligned; else 4 bytes a
// copy), rows of rollout_ldr floats.  Rows at and beyond K are not read.  A
// tile larger than ROLLOUT_SMEM goes through in chunks of p.chunk_steps steps,
// two buffers, the next chunk landing while the block rolls out the current
// one.  Meanwhile thread s < S reads its sample's x0 (one broadcast when x0 is
// shared, stride 0); then it rolls the model out on register arrays of N,
// the running cost taken after each step, and writes cost[k0 + s]
// (coalesced).
template <class Model, int N>
__global__ void __launch_bounds__(BLOCK) fused_rollout(Params p) {
  extern __shared__ float smem[];
  const int S = p.S, D = p.D, nu = p.nu, nx = p.nx, tid = threadIdx.x;
  const int k0 = blockIdx.x * S, k = k0 + tid;
  const int rows = p.K - k0 < S ? p.K - k0 : S;  // the block's live rows
  const int Ts = p.chunk_steps, nch = (p.T + Ts - 1) / Ts, cols_max = Ts * nu;
  const int ldr = rollout_ldr(cols_max);
  const float* span = p.U + (size_t)k0 * D;

  // chunk c (columns c * Ts * nu onwards) into buffer c % 2, as one group
  const auto stage = [&](int c) {
    float* buf = smem + (size_t)(c & 1) * S * ldr;
    const int c0 = c * cols_max, cols = D - c0 < cols_max ? D - c0 : cols_max;
    if (p.vec4) {
      const int units = cols / 4;
      for (int i = tid; i < rows * units; i += BLOCK) {
        const int r = i / units, g = i - r * units;
        copy_async16(buf + r * ldr + 4 * g, span + (size_t)r * D + c0 + 4 * g);
      }
    } else {
      for (int i = tid; i < rows * cols; i += BLOCK) {
        const int r = i / cols, col = i - r * cols;
        copy_async(buf + r * ldr + col, span + (size_t)r * D + c0 + col);
      }
    }
    async_commit();
  };
  stage(0);
  if (nch > 1) stage(1);

  const bool live = tid < rows;
  float x[N], u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = live && i < nx ? p.x0[i * p.x0_row_stride + (long long)k * p.x0_col_stride] : 0.0f;
    u[i] = 0.0f;
  }
  // the N = 2 arrays also hold a rollout with nx = nu = 2 as constants
  bool exact = false;
  if constexpr (N == 2) exact = nx == 2 && nu == 2;
  float total = 0.0f;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch)
      async_wait_group<1>();
    else
      async_wait_group<0>();
    __syncthreads();  // chunk c has landed, whichever thread copied it
    if (live) {
      const float* row = smem + (size_t)(c & 1) * S * ldr + (size_t)tid * ldr;
      const int steps = p.T - c * Ts < Ts ? p.T - c * Ts : Ts;
      total = exact ? rollout_steps<Model, N>(p, row, steps, x, u, total, N, N)
                    : rollout_steps<Model, N>(p, row, steps, x, u, total, nx, nu);
    }
    if (c + 2 < nch) {
      __syncthreads();  // buffer c % 2 is read before chunk c + 2 lands in it
      stage(c + 2);
    }
  }
  if (live) p.cost[k] = total;
}

// --- kernel B and the legacy route's weighted update -----------------------------

#if FUSED_MPPI_HAS(5)
constexpr int MERGE_CHUNK = 4096;  // block scales held in shared memory at a time

// Kernel B of the batched iteration: one block per plant; plant
// n = blockIdx.x merges its nblocks partials into column n of delta
// (R, plants) and of ms (2, plants) (merge_partials, MERGE_CHUNK block
// scales at a time).
__global__ void __launch_bounds__(MERGE_THREADS)
    flash_merge(const float* partial, int nblocks, int R, float* delta, float* ms) {
  __shared__ float scale[MERGE_CHUNK];
  __shared__ float part[MERGE_THREADS];
  __shared__ float red[MERGE_THREADS / 32];
  const int plant = blockIdx.x, plants = gridDim.x;
  merge_partials(partial + (size_t)plant * nblocks * (R + 2), nblocks, R, delta, ms, plant, plants,
                 scale, MERGE_CHUNK, part, red);
}

constexpr int WEIGHTED_LOADS = 8;  // partials a thread of weighted_merge loads at once
constexpr int WEIGHTED_COUNTERS = 8193;  // the weighted update's tickets: 1 + at most 8,192 groups

// Floats of one partial of the weighted update: m_b, s_b, two unused, then
// acc_b[0..D) padded to four, so that every row starts on 16 bytes.
__host__ __device__ constexpr int weighted_stride(int D) { return 4 + (D + 3) / 4 * 4; }

// sum_i ws[i] col[i * ld] over i = first, first + step, ... < rows, for one
// column (x) or, where vec4, four (x, y, z, w) read as one 16-byte load; fp32
// FMAs in the order of i.
__device__ __forceinline__ float4 weighted_column(const float* __restrict__ col, long long ld,
                                                  int first, int rows, int step,
                                                  const float* ws, bool vec4) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec4) {
#pragma unroll 4
    for (int i = first; i < rows; i += step) {
      const float4 n = __ldg(reinterpret_cast<const float4*>(col + (size_t)i * ld));
      const float w = ws[i];
      acc.x = fmaf(w, n.x, acc.x);
      acc.y = fmaf(w, n.y, acc.y);
      acc.z = fmaf(w, n.z, acc.z);
      acc.w = fmaf(w, n.w, acc.w);
    }
  } else {
#pragma unroll 4
    for (int i = first; i < rows; i += step) acc.x = fmaf(ws[i], __ldg(col + (size_t)i * ld), acc.x);
  }
  return acc;
}

// Merges n partials (rows of weighted_stride(D) floats) at src into dst[0..D),
// *m_out and *s_out with the block's threads, in one pass over them: thread
// (g, c) takes column unit c (four columns) and the partials g, g + G, ...
// (G = threads / units groups), loading m_b, s_b and the four columns of
// WEIGHTED_LOADS partials together (no load waits on another) and keeping
// an online (m_g, s_g, acc_g) against the largest m_b it has seen; the
// groups' results meet in shared memory and are added in the order of g,
// each scaled by e^(m_g - m).  Deterministic: fixed orders, no atomics.
// `part` holds blockDim.x float4s, `gm` and `gs` blockDim.x floats each.
// Every thread of the block must call it.
__device__ void weighted_merge(const float* src, int n, int D, float* dst, float* m_out,
                               float* s_out, float4* part, float* gm, float* gs) {
  const int tid = threadIdx.x, NT = blockDim.x, units = (D + 3) / 4;
  const int cols = units < NT ? units : NT, G = NT / cols, g = tid / cols, cl = tid - g * cols;
  const int PS4 = weighted_stride(D) / 4;
  const float4* rows = reinterpret_cast<const float4*>(src);
  for (int u0 = 0; u0 < units; u0 += cols) {
    const int c = u0 + cl;
    const bool active = g < G && c < units;
    float m = -INFINITY, s = 0.0f;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int b0 = g; active && b0 < n; b0 += WEIGHTED_LOADS * G) {
      float4 head[WEIGHTED_LOADS], col[WEIGHTED_LOADS];
#pragma unroll
      for (int u = 0; u < WEIGHTED_LOADS; ++u) {
        const int b = b0 + u * G;
        head[u] = make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
        col[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b < n) {
          head[u] = __ldcg(rows + (size_t)b * PS4);
          col[u] = __ldcg(rows + (size_t)b * PS4 + 1 + c);
        }
      }
      float mb = m;
#pragma unroll
      for (int u = 0; u < WEIGHTED_LOADS; ++u) mb = fmaxf(mb, head[u].x);
      if (mb == -INFINITY) continue;  // nothing weighs yet
      const float r = expf(m - mb);  // 0 while m is -inf
      s *= r;
      acc.x *= r;
      acc.y *= r;
      acc.z *= r;
      acc.w *= r;
#pragma unroll
      for (int u = 0; u < WEIGHTED_LOADS; ++u) {
        const float e = expf(head[u].x - mb);
        s = fmaf(head[u].y, e, s);
        acc.x = fmaf(col[u].x, e, acc.x);
        acc.y = fmaf(col[u].y, e, acc.y);
        acc.z = fmaf(col[u].z, e, acc.z);
        acc.w = fmaf(col[u].w, e, acc.w);
      }
      m = mb;
    }
    part[tid] = acc;
    if (cl == 0) {
      gm[g] = m;
      gs[g] = s;
    }
    __syncthreads();
    float mt = -INFINITY;
    for (int h = 0; h < G; ++h) mt = fmaxf(mt, gm[h]);
    if (g == 0 && c < units) {
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int h = 0; h < G; ++h) {
        const float e = gm[h] > -INFINITY ? expf(gm[h] - mt) : 0.0f;
        const float4 a = part[h * cols + cl];
        sum.x = fmaf(a.x, e, sum.x);
        sum.y = fmaf(a.y, e, sum.y);
        sum.z = fmaf(a.z, e, sum.z);
        sum.w = fmaf(a.w, e, sum.w);
      }
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * c + j < D) dst[4 * c + j] = v[j];
    }
    if (u0 == 0 && tid == 0) {
      float st = 0.0f;
      for (int h = 0; h < G; ++h)
        if (gm[h] > -INFINITY) st = fmaf(gs[h], expf(gm[h] - mt), st);
      *m_out = mt;
      *s_out = st;
    }
    __syncthreads();  // part, gm and gs are read before the next columns
  }
}

// fused_weighted_update's kernel, S = 32, 64 or 128 samples a block of BLOCK
// threads.  Block b takes samples [k0, k0 + S), k0 = b*S:
//   1. the softmax weights of its samples against its own largest logit;
//      m_b and s_b by warp shuffles (block_reduce);
//   2. acc_b[d] = sum_i w_i noise[k0 + i, d] (row stride ld) on all threads:
//      thread t takes column unit c = t % units (four columns, one 16-byte
//      load a row, where vec4; else one column) and the samples g, g + G,
//      ... (g = t / units, G = BLOCK / units groups); the groups' sums meet
//      in shared memory and are added in the order of g;
//   3. the partial (m_b, s_b, acc_b) goes to partial[b]; the merge takes two
//      levels of tickets (after a __threadfence each): the last block of each
//      group of `group` consecutive blocks merges the group's partials into
//      gpart[group index] (weighted_merge), and the last of those merges the
//      groups into out = (pert[0..D), m, s); each sets its counter back to 0
//      (counter[1 + group index], then counter[0]): one launch a call.
// Samples at and beyond K weigh exactly 0 and are not read.
template <int S>
__global__ void __launch_bounds__(BLOCK)
    weighted_partial(const float* __restrict__ cost, const float* __restrict__ noise,
                     long long ld, int K, int D, int vec4, const float* lam, int group,
                     float* partial, float* gpart, int* counter, float* out) {
  __shared__ float red[32], ws[S], gm[BLOCK], gs[BLOCK];
  __shared__ float4 part[BLOCK];
  __shared__ int ticket;
  const int tid = threadIdx.x, k0 = blockIdx.x * S, nblocks = gridDim.x, PS = weighted_stride(D);
  const int rows = K - k0 < S ? K - k0 : S;
  const bool live = tid < rows;
  const float logit = live ? -__ldg(cost + k0 + tid) / *lam : -INFINITY;
  const float m_b = block_reduce<true>(logit, red);
  const float w = (live && m_b > -INFINITY) ? expf(logit - m_b) : 0.0f;
  if (tid < S) ws[tid] = w;
  const float s_b = block_reduce<false>(w, red);  // its barriers publish ws
  float* row = partial + (size_t)blockIdx.x * PS;
  if (tid == 0) {
    row[0] = m_b;
    row[1] = s_b;
  }
  float* acc_b = row + 4;
  const int width = vec4 ? 4 : 1, units = (D + width - 1) / width;
  const float* block_rows = noise + (size_t)k0 * ld;
  if (units > BLOCK) {
    // rows wider than the block: each thread sums whole columns
    for (int c = tid; c < units; c += BLOCK) {
      const float4 acc = weighted_column(block_rows + (size_t)c * width, ld, 0, rows, 1, ws, vec4);
      float* dst = acc_b + c * width;
      dst[0] = acc.x;
      if (vec4) {
        dst[1] = acc.y;
        dst[2] = acc.z;
        dst[3] = acc.w;
      }
    }
  } else {
    const int G = BLOCK / units, g = tid / units, c = tid - g * units;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < G) acc = weighted_column(block_rows + (size_t)c * width, ld, g, rows, G, ws, vec4);
    part[tid] = acc;
    __syncthreads();
    const float* pf = reinterpret_cast<const float*>(part);
    for (int d = tid; d < D; d += BLOCK) {
      const int cu = d / width, j = d - cu * width;
      float sum = pf[4 * cu + j];
      for (int h = 1; h < G; ++h) sum += pf[4 * (h * units + cu) + j];
      acc_b[d] = sum;
    }
  }

  // level 1: the last block of the group merges the group's partials
  const int grp = blockIdx.x / group, first = grp * group;
  const int size = nblocks - first < group ? nblocks - first : group;
  const int groups = (nblocks + group - 1) / group;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(counter + 1 + grp, 1);
  __syncthreads();
  if (ticket != size - 1) return;
  __threadfence();
  float* grow = groups == 1 ? nullptr : gpart + (size_t)grp * PS;
  weighted_merge(partial + (size_t)first * PS, size, D, grow ? grow + 4 : out,
                 grow ? grow : out + D, grow ? grow + 1 : out + D + 1, part, gm, gs);
  if (tid == 0) counter[1 + grp] = 0;  // ready for the next launch
  if (groups == 1) return;
  // level 2: the last group to be merged merges the groups
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != groups - 1) return;
  __threadfence();
  weighted_merge(gpart, groups, D, out, out + D, out + D + 1, part, gm, gs);
  if (tid == 0) *counter = 0;
}

// --- the sampling front-end ------------------------------------------------------

constexpr int SAMPLER_THREADS = 256;  // threads of a block of the sampler's kernels

struct SamplerParams {
  int K, D, nsrc;  // nsrc: the source rows drawn
  const int* bits;  // (rows, D) int32, or null in seed mode
  unsigned key0, key1;
  int block_k, antithetic, null_action, abs_cost;
  int rows;  // source rows of a block
  int lanes;  // fused_sampler: threads of a row (its groups of four, padded)
  int panel;  // fused_sampler_op: op rows of a panel
  int vec4;  // D % 4 == 0 and every pointer 16-byte aligned: 16-byte loads and stores
  const float* U;  // (D,) the nominal sequence
  const float* op;  // (D,) diagonal scale, or (D, D) row-major applied as z @ op
  const float* mu;  // (D,)
  const float* lo;
  const float* hi;
  const float* a;  // (D,) action-cost vector
  float* pert;  // (K, D)
  float* cost;  // (K,)
};

// The output rows of source row src: k1 and, under antithetic sampling, its
// mirror k2 (else K).  Row j of K block b draws source row b*bh + j for
// j < bh = block_k / 2, and row j + bh the negated draw (the JAX kernel's
// pairing).
__device__ __forceinline__ void sampler_rows(const SamplerParams& p, int src, int& k1, int& k2) {
  if (p.antithetic) {
    const int bh = p.block_k / 2, b = src / bh;
    k1 = b * p.block_k + (src - b * bh);
    k2 = k1 + bh;
  } else {
    k1 = src;
    k2 = p.K;
  }
}

// Elements d0 .. d0 + 3 of v (zeros past D): one 16-byte load where vec4.
__device__ __forceinline__ void load4(const float* v, int d0, int D, int vec4, float (&out)[4]) {
  if (vec4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(v + d0));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) out[w] = d0 + w < D ? __ldg(v + d0 + w) : 0.0f;
  }
}

// The normals of elements 4g .. 4g + 3 of source row src: element d is the
// bits' (src, d) (one 16-byte load where vec4), or word d % 4 of Philox
// counter (src, d / 4, 0, 0) (one call).
__device__ __forceinline__ void draw4(const SamplerParams& p, int src, int g, float (&z)[4]) {
  const int d0 = 4 * g;
  unsigned w[4];
  if (p.bits) {
    const int* row = p.bits + (size_t)src * p.D + d0;
    if (p.vec4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(row));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = d0 + j < p.D ? (unsigned)__ldg(row + j) : 0u;
    }
  } else {
    const uint4 r = philox4x32_10(make_uint4((unsigned)src, (unsigned)g, 0u, 0u), p.key0, p.key1);
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) z[j] = bits_to_normal(w[j]);
}

// Row k's elements d0 .. d0 + 3 from their noise n: U + n (0 on the null row
// k = 0), the clamp, the store (one 16-byte store where vec4); returns their
// share of the action cost of the rectified noise.
__device__ __forceinline__ float sampler_store(const SamplerParams& p, int k, int d0,
                                               const float (&n)[4], const float (&u)[4],
                                               const float (&lo)[4], const float (&hi)[4],
                                               const float (&a)[4]) {
  float v[4], pc = 0.0f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    v[w] = u[w] + n[w];
    if (p.null_action && k == 0) v[w] = 0.0f;
    v[w] = fminf(fmaxf(v[w], lo[w]), hi[w]);
    if (d0 + w < p.D) {
      const float r = v[w] - u[w];  // rectified noise (mppi.py:383-385)
      pc += (p.abs_cost ? fabsf(r) : r) * a[w];
    }
  }
  float* out = p.pert + (size_t)k * p.D + d0;
  if (p.vec4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (d0 + w < p.D) out[w] = v[w];
  }
  return pc;
}

// The action cost of each of the block's rows from its shares in
// csum[(o * rows + r) * n + i] (o = 0 for k1, 1 for the mirror k2), added in
// the order of i.
__device__ __forceinline__ void sampler_costs(const SamplerParams& p, const float* csum, int n) {
  for (int r = threadIdx.x; r < p.rows; r += blockDim.x) {
    const int src = blockIdx.x * p.rows + r;
    int k1, k2;
    sampler_rows(p, src, k1, k2);
    if (src >= p.nsrc || k1 >= p.K) continue;
    float c1 = 0.0f, c2 = 0.0f;
    for (int i = 0; i < n; ++i) {
      c1 += csum[r * n + i];
      c2 += csum[(p.rows + r) * n + i];
    }
    p.cost[k1] = c1;
    if (k2 < p.K) p.cost[k2] = c2;
  }
}

// make_fused_sampler's kernel with a diagonal op.  Thread (r, g) of a block
// takes source row src = blockIdx.x * rows + r and its elements 4g .. 4g + 3
// (a row's groups on consecutive lanes, padded to a power of two up to 32,
// else to a multiple of 32): it draws the four normals once, computes
// n = z op + mu, U + n, the null row and the clamp, stores the four outputs
// and keeps their share of the action cost; under antithetic sampling it
// writes the mirror row from -z too.  A row's cost is a shuffle sum over its
// lanes; where a row spans warps, the warps' sums meet in shared memory and
// are added in a fixed order.
__global__ void __launch_bounds__(SAMPLER_THREADS, 5) fused_sampler(SamplerParams p) {
  extern __shared__ float smem[];  // (2, rows, lanes / 32) where lanes > 32
  const int L = p.lanes, G4 = (p.D + 3) / 4, wpr = (L + 31) / 32, seg = L < 32 ? L : 32;
  for (int i = threadIdx.x; i < p.rows * L; i += blockDim.x) {
    const int r = i / L, g = i - r * L, src = blockIdx.x * p.rows + r;
    int k1, k2;
    sampler_rows(p, src, k1, k2);
    const bool row_live = src < p.nsrc && k1 < p.K;
    float pc1 = 0.0f, pc2 = 0.0f;
    if (row_live && g < G4) {
      const int d0 = 4 * g;
      float z[4], op[4], mu[4], u[4], lo[4], hi[4], a[4], n[4];
      draw4(p, src, g, z);
      load4(p.op, d0, p.D, p.vec4, op);
      load4(p.mu, d0, p.D, p.vec4, mu);
      load4(p.U, d0, p.D, p.vec4, u);
      load4(p.lo, d0, p.D, p.vec4, lo);
      load4(p.hi, d0, p.D, p.vec4, hi);
      load4(p.a, d0, p.D, p.vec4, a);
#pragma unroll
      for (int w = 0; w < 4; ++w) n[w] = z[w] * op[w] + mu[w];
      pc1 = sampler_store(p, k1, d0, n, u, lo, hi, a);
      if (k2 < p.K) {
#pragma unroll
        for (int w = 0; w < 4; ++w) n[w] = -z[w] * op[w] + mu[w];
        pc2 = sampler_store(p, k2, d0, n, u, lo, hi, a);
      }
    }
    for (int off = seg / 2; off > 0; off >>= 1) {
      pc1 += __shfl_xor_sync(0xffffffffu, pc1, off);
      pc2 += __shfl_xor_sync(0xffffffffu, pc2, off);
    }
    if (L <= 32) {
      if (g == 0 && row_live) {
        p.cost[k1] = pc1;
        if (k2 < p.K) p.cost[k2] = pc2;
      }
    } else if (g % 32 == 0) {
      smem[r * wpr + g / 32] = pc1;
      smem[(p.rows + r) * wpr + g / 32] = pc2;
    }
  }
  if (L > 32) {
    __syncthreads();
    sampler_costs(p, smem, wpr);
  }
}

// make_fused_sampler's kernel with a full (D, D) op, applied as z @ op.
// Block b takes source rows [b*rows, b*rows + rows), rows = Q * TR.  It draws
// their normals into an (rows, DP) tile (DP = 4 ceil(D / 4); a thread per
// (row, group of four)), then computes z @ op as a register-tiled product:
// thread (q, c) takes column group c (four columns) and rows q, q + Q, ...
// (TR of them; Q = threads / groups), reading op through shared memory in
// panels of p.panel rows, staged by all threads with 16-byte loads; four
// panel rows at a time, each float4 of z read from the tile feeds 16 FMAs
// (fp32, no TF32; each sum in the order of the op's rows).  The thread then
// finishes its rows' four elements (n = z @ op + mu, and mu - z @ op on the
// mirror row: (-z) @ op = -(z @ op) exactly) as fused_sampler does; the
// shares of a row's cost meet in shared memory and are added in the order
// of c.
template <int TR>
__global__ void __launch_bounds__(SAMPLER_THREADS) fused_sampler_op(SamplerParams p) {
  extern __shared__ float smem[];
  const int D = p.D, G4 = (D + 3) / 4, DP = 4 * G4, RB = p.rows, NT = blockDim.x;
  const int tid = threadIdx.x, src0 = blockIdx.x * RB;
  float* zt = smem;  // (RB, DP) the normals
  float* panel = zt + (size_t)RB * DP;  // (p.panel, DP) rows of op
  float* csum = panel + (size_t)p.panel * DP;  // (2, RB, G4) the cost shares
  for (int i = tid; i < RB * G4; i += NT) {
    const int r = i / G4, g = i - r * G4, src = src0 + r;
    int k1, k2;
    sampler_rows(p, src, k1, k2);
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (src < p.nsrc && k1 < p.K) draw4(p, src, g, z);
    *reinterpret_cast<float4*>(zt + (size_t)r * DP + 4 * g) = make_float4(z[0], z[1], z[2], z[3]);
  }
  const int Q = G4 < NT ? NT / G4 : 1, passes = (G4 + NT - 1) / NT;
  const int q = G4 < NT ? tid / G4 : 0;
  for (int cp = 0; cp < passes; ++cp) {
    const int c = G4 < NT ? tid - q * G4 : tid + cp * NT;
    const bool active = q < Q && c < G4;
    float acc[TR][4];
#pragma unroll
    for (int t = 0; t < TR; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    for (int j0 = 0; j0 < D; j0 += p.panel) {
      const int pj = D - j0 < p.panel ? D - j0 : p.panel;
      __syncthreads();  // the tile is written and the previous panel read
      for (int e = tid; e < pj * G4; e += NT) {
        const int jj = e / G4, cc = e - jj * G4;
        float v[4];
        load4(p.op + (size_t)(j0 + jj) * D, 4 * cc, D, p.vec4, v);
        *reinterpret_cast<float4*>(panel + jj * DP + 4 * cc) = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      if (active) {
        const float* zq = zt + (size_t)q * DP + j0;
        int jj = 0;
        if (j0 % 4 == 0) {
          // four op rows at a time: each row's four normals as one
          // 16-byte load, so a float4 of z feeds 16 FMAs
          for (; jj + 4 <= pj; jj += 4) {
            float4 o[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              o[u] = *reinterpret_cast<const float4*>(panel + (jj + u) * DP + 4 * c);
#pragma unroll
            for (int t = 0; t < TR; ++t) {
              const float4 z = *reinterpret_cast<const float4*>(zq + (size_t)t * Q * DP + jj);
              const float zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                acc[t][0] = fmaf(zs[u], o[u].x, acc[t][0]);
                acc[t][1] = fmaf(zs[u], o[u].y, acc[t][1]);
                acc[t][2] = fmaf(zs[u], o[u].z, acc[t][2]);
                acc[t][3] = fmaf(zs[u], o[u].w, acc[t][3]);
              }
            }
          }
        }
        for (; jj < pj; ++jj) {
          const float4 o = *reinterpret_cast<const float4*>(panel + jj * DP + 4 * c);
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            const float zj = zq[(size_t)t * Q * DP + jj];
            acc[t][0] = fmaf(zj, o.x, acc[t][0]);
            acc[t][1] = fmaf(zj, o.y, acc[t][1]);
            acc[t][2] = fmaf(zj, o.z, acc[t][2]);
            acc[t][3] = fmaf(zj, o.w, acc[t][3]);
          }
        }
      }
    }
    if (active) {
      const int d0 = 4 * c;
      float mu[4], u[4], lo[4], hi[4], a[4], n[4];
      load4(p.mu, d0, D, p.vec4, mu);
      load4(p.U, d0, D, p.vec4, u);
      load4(p.lo, d0, D, p.vec4, lo);
      load4(p.hi, d0, D, p.vec4, hi);
      load4(p.a, d0, D, p.vec4, a);
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const int r = q + t * Q, src = src0 + r;
        int k1, k2;
        sampler_rows(p, src, k1, k2);
        if (src >= p.nsrc || k1 >= p.K) continue;
#pragma unroll
        for (int w = 0; w < 4; ++w) n[w] = acc[t][w] + mu[w];
        csum[r * G4 + c] = sampler_store(p, k1, d0, n, u, lo, hi, a);
        if (k2 < p.K) {
#pragma unroll
          for (int w = 0; w < 4; ++w) n[w] = mu[w] - acc[t][w];
          csum[(RB + r) * G4 + c] = sampler_store(p, k2, d0, n, u, lo, hi, a);
        }
      }
    }
  }
  __syncthreads();
  sampler_costs(p, csum, G4);
}
#endif

template <class Model, int N, bool kGlobal, int V>
cudaError_t launch_partial(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mppi_fused_partial<Model, N, kGlobal, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  mppi_fused_partial<Model, N, kGlobal, V><<<p.nblocks, BLOCK, smem, stream>>>(p);  // merges too
  return cudaGetLastError();
}

template <class Model, int N, bool kGlobal>
cudaError_t launch_variant(const Params& p, int variant, size_t smem, cudaStream_t s) {
  switch (variant) {
    case kMPPI: return launch_partial<Model, N, kGlobal, kMPPI>(p, smem, s);
    case kSMPPI: return launch_partial<Model, N, kGlobal, kSMPPI>(p, smem, s);
    case kKMPPI: return launch_partial<Model, N, kGlobal, kKMPPI>(p, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// parts 0-4, 11-13: the single-plant variants and the rollout kernel
template <class Model, int N>
cudaError_t launch_tiles(const Params& p, int variant, size_t smem, cudaStream_t s) {
  if (variant == kRollout) {
    fused_rollout<Model, N><<<p.nblocks, BLOCK, smem, s>>>(p);
    return cudaGetLastError();
  }
  return p.scratch ? launch_variant<Model, N, true>(p, variant, smem, s)
                   : launch_variant<Model, N, false>(p, variant, smem, s);
}

template <class Model, int N, bool kGlobal>
cudaError_t launch_batched_partial(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        batched_partial<Model, N, kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks =
      (long long)p.nblocks * ((p.num_plants + p.plant_group - 1) / p.plant_group);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  batched_partial<Model, N, kGlobal><<<(unsigned)blocks, BLOCK, smem, stream>>>(p);
  return cudaGetLastError();
}

// parts 6-10: the batched variant
template <class Model, int N>
cudaError_t launch_batched(const Params& p, int variant, size_t smem, cudaStream_t s) {
  if (variant != kBatched) return cudaErrorInvalidValue;
  return p.scratch ? launch_batched_partial<Model, N, true>(p, smem, s)
                   : launch_batched_partial<Model, N, false>(p, smem, s);
}

// One launcher per device model, register size and part; the other parts
// see its declaration.
using Launcher = cudaError_t (*)(const Params&, int, size_t, cudaStream_t);

#if FUSED_MPPI_HAS(0)
cudaError_t launch_lq8(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<LinearQuadratic, 8>(p, v, smem, s);
}
#else
cudaError_t launch_lq8(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(1)
cudaError_t launch_lq32(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<LinearQuadratic, MAXN>(p, v, smem, s);
}
#else
cudaError_t launch_lq32(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(2)
cudaError_t launch_toy8(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<Toy2D, 8>(p, v, smem, s);
}
#else
cudaError_t launch_toy8(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(3)
cudaError_t launch_toy32(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<Toy2D, MAXN>(p, v, smem, s);
}
#else
cudaError_t launch_toy32(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(4)
cudaError_t launch_pendulum2(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<Pendulum, 2>(p, v, smem, s);
}
#else
cudaError_t launch_pendulum2(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(11)
cudaError_t launch_lq2(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<LinearQuadratic, 2>(p, v, smem, s);
}
#else
cudaError_t launch_lq2(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(12)
cudaError_t launch_toy2(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<Toy2D, 2>(p, v, smem, s);
}
#else
cudaError_t launch_toy2(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(13)
cudaError_t launch_mlp2(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<ResidualMLP, 2>(p, v, smem, s);
}
#else
cudaError_t launch_mlp2(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(6)
cudaError_t batched_lq2(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_batched<LinearQuadratic, 2>(p, v, smem, s);
}
cudaError_t batched_lq8(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_batched<LinearQuadratic, 8>(p, v, smem, s);
}
#else
cudaError_t batched_lq2(const Params&, int, size_t, cudaStream_t);
cudaError_t batched_lq8(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(7)
cudaError_t batched_lq32(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_batched<LinearQuadratic, MAXN>(p, v, smem, s);
}
#else
cudaError_t batched_lq32(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(8)
cudaError_t batched_toy2(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_batched<Toy2D, 2>(p, v, smem, s);
}
cudaError_t batched_toy8(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_batched<Toy2D, 8>(p, v, smem, s);
}
#else
cudaError_t batched_toy2(const Params&, int, size_t, cudaStream_t);
cudaError_t batched_toy8(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(9)
cudaError_t batched_toy32(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_batched<Toy2D, MAXN>(p, v, smem, s);
}
#else
cudaError_t batched_toy32(const Params&, int, size_t, cudaStream_t);
#endif
#if FUSED_MPPI_HAS(10)
cudaError_t batched_pendulum2(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_batched<Pendulum, 2>(p, v, smem, s);
}
#else
cudaError_t batched_pendulum2(const Params&, int, size_t, cudaStream_t);
#endif

}  // namespace fused_mppi

#if FUSED_MPPI_HAS(5)
using namespace fused_mppi;

namespace {

// The launcher of a variant for a device model (by id) and its register size
// (2, 8 or MAXN), or null.  The residual MLP has no batched instantiation.
Launcher find_launcher(int variant, int model_id, int nx, int nu) {
  const int n = nx > nu ? nx : nu;
  const Launcher single[4][3] = {{launch_lq2, launch_lq8, launch_lq32},
                                 {launch_pendulum2, nullptr, nullptr},
                                 {launch_toy2, launch_toy8, launch_toy32},
                                 {launch_mlp2, nullptr, nullptr}};
  const Launcher batched[4][3] = {{batched_lq2, batched_lq8, batched_lq32},
                                  {batched_pendulum2, nullptr, nullptr},
                                  {batched_toy2, batched_toy8, batched_toy32},
                                  {nullptr, nullptr, nullptr}};
  if (model_id < 0 || model_id > 3 || n > MAXN) return nullptr;
  return (variant == kBatched ? batched : single)[model_id][n <= 2 ? 0 : n <= 8 ? 1 : 2];
}

// Kernel A for a single-plant variant (it merges its own partials), or
// batched_partial then kernel B into delta and ms.
cudaError_t launch_solve(const Params& p, int variant, int model_id, size_t smem,
                         cudaStream_t stream) {
  const Launcher launch = find_launcher(variant, model_id, p.nx, p.nu);
  if (!launch) return cudaErrorInvalidValue;
  const cudaError_t e = launch(p, variant, smem, stream);
  if (e != cudaSuccess || variant != kBatched) return e;
  flash_merge<<<p.num_plants, MERGE_THREADS, 0, stream>>>(p.partial, p.nblocks, p.R, p.delta,
                                                          p.ms);
  return cudaGetLastError();
}

// Dynamic shared memory of kernel A with S samples a block, or of
// batched_partial for kBatched, with the tiles in shared memory or
// (`global`) in a global scratch.
size_t kernel_smem(int variant, int D, int R, int full_op, int S, bool global) {
  if (variant == kBatched) {
    const size_t tiles = global ? 0 : (full_op ? 2 : 1) * (size_t)R * BATCHED_LDT;
    return (batched_head(R) + tiles) * sizeof(float);
  }
  const size_t tiles = global ? 0 : partial_tiles(variant, full_op) * (size_t)D * (S + 1);
  return (PARTIAL_HEAD + panel_floats(variant, full_op, R, S) + (size_t)NVEC * D + tiles) *
         sizeof(float);
}

bool valid_tile(int S) { return S == 32 || S == 64 || S == BLOCK; }

}  // namespace

extern "C" {

int fused_mppi_block() { return BLOCK; }

int fused_mppi_max_n() { return MAXN; }

// ResidualMLP's layout and bounds: 0 the header's floats, 1 the widest
// layer, 2 the most layers, 3 the outputs of a group (ops/kernel_models.py
// checks them)
int fused_mppi_mlp_limit(int which) {
  const int limits[4] = {MLP_HEAD, MLP_MAX_WIDTH, MLP_MAX_LAYERS, MLP_GROUP};
  return which >= 0 && which < 4 ? limits[which] : -1;
}

// Dynamic shared memory of kernel A with S samples a block (batched_partial
// for kBatched) with the tiles in shared memory (the wrapper checks it
// against the card's 227 KB, and otherwise passes a global scratch).
long long fused_mppi_smem_bytes(int variant, int D, int R, int full_op, int S) {
  return (long long)kernel_smem(variant, D, R, full_op, S, false);
}

const char* fused_mppi_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Launches kernel A with `tile_k` samples a block, which merges its partials
// itself with the zeroed int32 `counter` (two launches with one counter must
// not run at once), or for kBatched batched_partial then kernel B, on
// `stream`; returns cudaGetLastError().  In seed mode the Philox key is
// `key0`/`key1`, or the two words at the device pointer `key` where it is
// not null (read when the kernels run, so that a CUDA graph of the launch
// draws with the key written before each replay).  `scratch` is null for the
// shared-memory tiles, else (launched blocks, tiles, D, tile_k) for kernel A,
// (launched blocks, tiles, R, BLOCK) for kBatched.  kBatched takes
// `num_plants` plants in groups of `plant_group` a block, U and a as (D, N)
// with the strides (u_rs, u_ps) and (a_rs, a_ps), and in operand mode the
// final noise (R, noise_ld); the other variants take one plant.  `terminal`
// holds the quadratic terminal cost's constants (goal (nx), w_state,
// w_action), or is null for no terminal cost.  kMPPI takes `num_elites`
// elite rows (num_elites, D) row-major in `elites`, for the samples from
// `elite_off` on (0 and null without elite reuse).  For one shard of the
// samples (kernel A only), `gate` points at an int32 that must not be 0 for
// sample 0 to be the null row (null: always, as without sharding), and
// sample k draws the noise of global sample `k_offset` + k.
int fused_mppi_launch(int device, void* stream, int variant, int model_id, const float* consts,
                      int K, int T, int nx, int nu, int R,
                      const int* bits, int bits_cols, unsigned key0, unsigned key1,
                      const unsigned* key, int pair_block, int antithetic, int null_action,
                      int abs_cost,
                      const float* x0, long long x0_row_stride, long long x0_col_stride,
                      const float* U, const float* base, const float* op, int full_op,
                      const float* mu, const float* lo, const float* hi, const float* alo,
                      const float* ahi, const float* a, const float* W, const float* lam,
                      const float* w_seq, const float* dt, float u_scale, float* cost,
                      float* partial, float* delta, float* ms, float* pert, float* scratch,
                      int num_plants, long long u_rs, long long u_ps, long long a_rs,
                      long long a_ps, const float* noise, long long noise_ld, int plant_group,
                      int tile_k, int* counter, const float* terminal, const float* elites,
                      int num_elites, int elite_off, const int* gate, int k_offset) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{};
  p.consts = consts;
  p.K = K;
  p.T = T;
  p.nx = nx;
  p.nu = nu;
  p.D = T * nu;
  p.R = R;
  p.S = variant == kBatched ? BLOCK : tile_k;
  p.nblocks = (K + p.S - 1) / p.S;
  p.num_plants = num_plants;
  p.plant_group = plant_group;
  p.bits = bits;
  p.bits_cols = bits_cols;
  p.key0 = key0;
  p.key1 = key1;
  p.key = key;
  p.pair_block = pair_block;
  p.antithetic = antithetic;
  p.null_action = null_action;
  p.abs_cost = abs_cost;
  p.full_op = full_op;
  p.x0 = x0;
  p.x0_row_stride = x0_row_stride;
  p.x0_col_stride = x0_col_stride;
  p.U = U;
  p.u_rs = u_rs;
  p.u_ps = u_ps;
  p.base = base;
  p.op = op;
  p.mu = mu;
  p.lo = lo;
  p.hi = hi;
  p.alo = alo;
  p.ahi = ahi;
  p.a = a;
  p.a_rs = a_rs;
  p.a_ps = a_ps;
  p.W = W;
  p.noise = noise;
  p.noise_ld = noise_ld;
  p.lam = lam;
  p.w_seq = w_seq;
  p.dt = dt;
  p.u_scale = u_scale;
  p.cost = cost;
  p.partial = partial;
  p.pert = pert;
  p.scratch = scratch;
  p.counter = counter;
  p.delta = delta;
  p.ms = ms;
  p.terminal = terminal;
  p.elites = elites;
  p.num_elites = num_elites;
  p.elite_off = elite_off;
  p.gate = gate;
  p.k_offset = k_offset;
  const size_t smem = kernel_smem(variant, p.D, R, full_op, p.S, scratch != nullptr);
  if (variant < kMPPI || variant > kBatched || num_plants < 1 ||
      (variant == kBatched ? plant_group < 1 : num_plants != 1 || !valid_tile(tile_k) || !counter))
    return (int)cudaErrorInvalidValue;
  if (num_elites < 0 || elite_off < 0 || (num_elites > 0 && (variant != kMPPI || !elites)))
    return (int)cudaErrorInvalidValue;
  if (k_offset < 0 || ((gate || k_offset) && variant == kBatched)) return (int)cudaErrorInvalidValue;
  return (int)launch_solve(p, variant, model_id, smem, (cudaStream_t)stream);
}

// make_fused_solve (the round-1 solve) on `stream`: kernel A's kMPPI path with
// `rowmajor`, `tile_k` samples a block, merged in the kernel with `counter`.
// bits (K_pad, D) row-major int32, or null with a Philox key; x0 (nx,) with
// stride x0_stride; U and a (D,); chol (nu, nu) row-major; mu, lo, hi (nu,).
// `scratch` as for fused_mppi_launch (two tiles).
int fused_mppi_rowmajor_solve(int device, void* stream, int model_id, const float* consts, int K,
                              int T, int nx, int nu, const int* bits, unsigned key0,
                              unsigned key1, int null_action, int abs_cost, const float* x0,
                              long long x0_stride, const float* U, const float* chol,
                              const float* mu, const float* lo, const float* hi, const float* a,
                              const float* lam, float u_scale, float* cost, float* partial,
                              float* delta, float* ms, float* scratch, int tile_k,
                              int* counter) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{};
  p.consts = consts;
  p.K = K;
  p.T = T;
  p.nx = nx;
  p.nu = nu;
  p.D = p.R = T * nu;
  p.S = tile_k;
  p.nblocks = (K + tile_k - 1) / tile_k;
  p.num_plants = 1;
  p.bits = bits;
  p.key0 = key0;
  p.key1 = key1;
  p.null_action = null_action;
  p.abs_cost = abs_cost;
  p.full_op = 1;  // the raw normals keep a tile of their own
  p.rowmajor = 1;
  p.x0 = x0;
  p.x0_row_stride = x0_stride;
  p.U = p.base = U;
  p.op = chol;
  p.mu = mu;
  p.lo = lo;
  p.hi = hi;
  p.a = a;
  p.lam = lam;
  p.u_scale = u_scale;
  p.cost = cost;
  p.partial = partial;
  p.scratch = scratch;
  p.counter = counter;
  p.delta = delta;
  p.ms = ms;
  if (!valid_tile(tile_k) || !counter) return (int)cudaErrorInvalidValue;
  const size_t smem = kernel_smem(kMPPI, p.D, p.R, 1, tile_k, scratch != nullptr);
  return (int)launch_solve(p, kMPPI, model_id, smem, (cudaStream_t)stream);
}

// The sampler's geometry for D and the op's kind, into geo: {rows (source
// rows a block), lanes (fused_sampler's threads a row) or TR
// (fused_sampler_op's register rows a thread), panel (fused_sampler_op's op
// rows a panel), threads a block, dynamic shared bytes}.  Returns 0, or
// cudaErrorInvalidValue when the full-op tiles do not fit in the 227 KB a
// block may use.  ops/rowmajor.sampler_geometry computes the same.
int fused_mppi_sampler_geometry(int D, int full_op, long long* geo) {
  const long long max_smem = 232448, NT = SAMPLER_THREADS, G4 = (D + 3) / 4;
  if (D < 1) return (int)cudaErrorInvalidValue;
  if (!full_op) {
    long long lanes = 1;
    while (lanes < G4 && lanes < 32) lanes *= 2;
    if (G4 > 32) lanes = (G4 + 31) / 32 * 32;
    const long long rows = lanes <= NT ? NT / lanes : 1;
    geo[0] = rows;
    geo[1] = lanes;
    geo[2] = 0;
    geo[3] = lanes <= NT ? rows * lanes : NT;
    geo[4] = lanes > 32 ? 2 * rows * (lanes / 32) * (long long)sizeof(float) : 0;
    return 0;
  }
  const long long Q = G4 < NT ? NT / G4 : 1, TR = Q >= 32 ? 1 : Q >= 16 ? 2 : Q >= 8 ? 4 : 12;
  const long long rows = Q * TR, DP = 4 * G4;
  for (long long panel = 16; panel >= 1; panel /= 2) {
    const long long smem = (rows * DP + panel * DP + 2 * rows * G4) * (long long)sizeof(float);
    if (smem <= max_smem) {
      geo[0] = rows;
      geo[1] = TR;
      geo[2] = panel;
      geo[3] = NT;
      geo[4] = smem;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// make_fused_sampler's kernel on `stream`: perturbed (K, D) and cost (K,)
// from bits (rows, D) int32 or a Philox key, with a diagonal op (D,)
// (fused_sampler) or a full one (D, D) (fused_sampler_op).  Returns
// cudaErrorInvalidValue for a shape that does not fit
// (fused_mppi_sampler_geometry) or an odd pairing block.
int fused_mppi_sampler(int device, void* stream, int K, int D, const int* bits, unsigned key0,
                       unsigned key1, int block_k, int antithetic, int null_action, int abs_cost,
                       int full_op, const float* U, const float* op, const float* mu,
                       const float* lo, const float* hi, const float* a, float* pert,
                       float* cost) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  long long geo[5];
  if (K < 1 || (antithetic && (block_k < 2 || block_k % 2)) ||
      fused_mppi_sampler_geometry(D, full_op, geo) != 0)
    return (int)cudaErrorInvalidValue;
  SamplerParams p{};
  p.K = K;
  p.D = D;
  p.nsrc = K;
  if (antithetic) {  // the source rows that reach a row below K
    const int bh = block_k / 2, full = K / block_k, rem = K - full * block_k;
    p.nsrc = full * bh + (rem < bh ? rem : bh);
  }
  p.bits = bits;
  p.key0 = key0;
  p.key1 = key1;
  p.block_k = block_k;
  p.antithetic = antithetic;
  p.null_action = null_action;
  p.abs_cost = abs_cost;
  p.rows = (int)geo[0];
  p.lanes = full_op ? 0 : (int)geo[1];
  p.panel = (int)geo[2];
  const void* ptrs[] = {bits, U, op, mu, lo, hi, a, pert};
  p.vec4 = D % 4 == 0;
  for (const void* q : ptrs) p.vec4 = p.vec4 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  p.U = U;
  p.op = op;
  p.mu = mu;
  p.lo = lo;
  p.hi = hi;
  p.a = a;
  p.pert = pert;
  p.cost = cost;
  const int blocks = (p.nsrc + p.rows - 1) / p.rows, threads = (int)geo[3];
  const size_t smem = (size_t)geo[4];
  cudaStream_t s = (cudaStream_t)stream;
  if (!full_op) {
    fused_sampler<<<blocks, threads, smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  void (*kernel)(SamplerParams) = geo[1] == 1   ? fused_sampler_op<1>
                                  : geo[1] == 2 ? fused_sampler_op<2>
                                  : geo[1] == 4 ? fused_sampler_op<4>
                                                : fused_sampler_op<12>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The legacy rollout's geometry for T steps of nu actions and S samples a
// block, into geo: {steps a chunk, floats a staged row, buffers, dynamic
// shared bytes}.  The whole tile in one buffer when S rows of rollout_ldr(D)
// floats fit ROLLOUT_SMEM; else two buffers of the most steps that fit, a
// multiple of m = 4 / gcd(nu, 4) steps so that every chunk starts on 16
// bytes (m = 1, and 4-byte copies, where m steps do not fit or T <= m).
// ops/legacy.rollout_geometry computes the same.
int fused_mppi_rollout_geometry(int T, int nu, int S, long long* geo) {
  if (T < 1 || nu < 1 || S < 1) return (int)cudaErrorInvalidValue;
  long long steps = T, bufs = 1;
  if ((long long)S * rollout_ldr(T * nu) * 4 > ROLLOUT_SMEM) {
    int m = nu % 4 == 0 ? 1 : nu % 2 == 0 ? 2 : 4;
    if (m >= T || 2LL * S * rollout_ldr(m * nu) * 4 > ROLLOUT_SMEM) m = 1;  // scalar copies
    bufs = 2;
    steps = m;
    while (steps + m < T && 2LL * S * rollout_ldr((int)(steps + m) * nu) * 4 <= ROLLOUT_SMEM)
      steps += m;
  }
  geo[0] = steps;
  geo[1] = rollout_ldr((int)steps * nu);
  geo[2] = bufs;
  geo[3] = bufs * S * geo[1] * (long long)sizeof(float);
  return 0;
}

// make_fused_rollout's kernel on `stream`, `tile_k` samples a block: cost
// (K,) of the (K, T*nu) scaled actions u (row-major) from x0 (nx, K) with
// the given strides.
int fused_mppi_rollout(int device, void* stream, int model_id, const float* consts, int K, int T,
                       int nx, int nu, const float* x0, long long x0_row_stride,
                       long long x0_col_stride, const float* u, float* cost, int tile_k) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  long long geo[4];
  if (K < 1 || !valid_tile(tile_k) || fused_mppi_rollout_geometry(T, nu, tile_k, geo) != 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.consts = consts;
  p.K = K;
  p.T = T;
  p.nx = nx;
  p.nu = nu;
  p.D = T * nu;
  p.S = tile_k;
  p.nblocks = (K + tile_k - 1) / tile_k;
  p.num_plants = 1;
  p.x0 = x0;
  p.x0_row_stride = x0_row_stride;
  p.x0_col_stride = x0_col_stride;
  p.U = u;
  p.cost = cost;
  p.chunk_steps = (int)geo[0];
  p.vec4 = p.D % 4 == 0 && (geo[0] * nu) % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const Launcher launch = find_launcher(kRollout, model_id, nx, nu);
  if (!launch) return (int)cudaErrorInvalidValue;
  return (int)launch(p, kRollout, (size_t)geo[3], (cudaStream_t)stream);
}

// The weighted update's group of blocks for its first merge level: the
// smallest g >= 8 with g * g >= nblocks, so that both levels merge about
// sqrt(nblocks) partials (ops/legacy.weighted_group computes the same).
int fused_mppi_weighted_group(int nblocks) {
  long long g = 8;
  while (g * g < nblocks) ++g;
  return (int)g;
}

// fused_weighted_update on `stream`: weighted_partial<tile_k> over the
// (K, D) noise (row stride ld), its partials in partial (nblocks, stride) and
// its groups' in gpart (groups, stride) (stride = weighted_stride(D), groups
// of fused_mppi_weighted_group(nblocks) blocks), merged in the kernel into
// out = (pert (D,), m, s) with the zeroed int32 `counter` of
// WEIGHTED_COUNTERS ints (two launches with one counter must not run at
// once).
int fused_mppi_weighted_update(int device, void* stream, int K, int D, int tile_k,
                               const float* cost, const float* noise, long long ld,
                               const float* lam, float* partial, float* gpart, int* counter,
                               float* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K < 1 || D < 1 || ld < D || !valid_tile(tile_k) || !counter)
    return (int)cudaErrorInvalidValue;
  const int nblocks = (K + tile_k - 1) / tile_k, group = fused_mppi_weighted_group(nblocks);
  if (1 + (nblocks + group - 1) / group > WEIGHTED_COUNTERS) return (int)cudaErrorInvalidValue;
  const int vec4 = D % 4 == 0 && ld % 4 == 0 && reinterpret_cast<uintptr_t>(noise) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  void (*kernel)(const float*, const float*, long long, int, int, int, const float*, int, float*,
                 float*, int*, float*) = tile_k == 32   ? weighted_partial<32>
                                         : tile_k == 64 ? weighted_partial<64>
                                                        : weighted_partial<BLOCK>;
  kernel<<<nblocks, BLOCK, 0, s>>>(cost, noise, ld, K, D, vec4, lam, group, partial, gpart,
                                   counter, out);
  return (int)cudaGetLastError();
}

int fused_mppi_weighted_counters() { return WEIGHTED_COUNTERS; }

}  // extern "C"
#endif
