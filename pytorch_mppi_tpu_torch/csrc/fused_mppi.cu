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
// as one kernel template, mppi_fused_partial<Model, N, kGlobal, V>, followed by
// flash_merge (the round-1 solve is kMPPI with the runtime flag `rowmajor`), and
//   make_transposed_batched_solve  (pallas_rollout.py:1118) as
//                          batched_partial<Model, N, kGlobal> + flash_merge,
//   make_fused_rollout     (pallas_rollout.py:75)   as fused_rollout<Model, N>
//   fused_weighted_update  (pallas_rollout.py:172)  as weighted_partial + flash_merge
//   make_fused_sampler     (pallas_rollout.py:1350) as fused_sampler.
//
// The iteration.  For K samples kernel A computes: the normals of the R drawn
// rows (from injected int32 bits or from Philox4x32-10), the antithetic sign,
// the noise transform (diagonal scale or full (R, R) operator), then per variant
//   MPPI  (R = D = T*nu): U + noise, the null-action row, the clamp;
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
// in scratch; GPU blocks run at the same time.  So the work is two kernels:
//   A. mppi_fused_partial: one thread per sample, BLOCK samples per block.  A
//      thread keeps its R drawn rows in a (R, BLOCK) tile (a second tile holds
//      the raw normals for a full operator), rolls the model out in
//      registers, and writes cost[k].  The block then reduces its own max
//      m_b, sum s_b and acc_b[r] = sum_k w_k n_k[r] and writes them to a
//      (nblocks, R + 2) scratch.  Threads with k >= K take no part
//      (_tp_mask_phantom).
//   B. flash_merge: one block per plant merges that plant's partials,
//      m = max m_b, s = sum s_b e^(m_b - m), delta[r] = sum acc_b[r] e^(m_b - m),
//      with each scale e^(m_b - m) taken once and the sums split over the
//      block's threads (no serial loop over the partials).
// The tiles live in shared memory (row stride BLOCK + 1, so the column writes
// and the row reads of the update are free of bank conflicts) when they fit
// in the 227 KB a block may use; otherwise (kGlobal) in a global scratch of
// one (R, BLOCK) slice per block, which stays in the 50 MB L2.  The TPU
// kernel shrinks its block instead.  The device models keep state and action
// in register arrays of N = 8 or N = 32 (for the batched kernel also N = 2),
// chosen at launch from max(nx, nu).  The noise never reaches device memory
// unless the caller asks for the perturbed actions (emit_perturbed) or passes
// it as the batched operand.
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
// is bound by launch latency and by how few of the 132 SMs its 79 blocks of
// 128 threads fill.  The batched iteration at N = 1,024, K = 16,384 needs
// about 1.9e10 operations (0.28 ms) in either mode: the per-plant clamp,
// action cost, rollout and update; the shared draw, counted once a source
// column, adds 5.6e7; the 64 MB of costs it writes take 0.02 ms.  With the
// draw shared, the kernel is bound by issuing the per-plant instructions:
// the rollout step, the recomputed clamp of the update and the block's
// reductions.
// chip_smoke.py computes the exact bounds from the run's shapes.
//
// The legacy route.  fused_rollout: one thread per sample reads its row of
// the (K, T*nu) scaled actions and rolls the model out from its x0 row; it is
// bound by the bytes of those actions (2.4 MB at the flagship, 0.7 us).
// weighted_partial: one thread per sample takes the softmax weight of its
// cost, then the block's threads, one noise column each, sum their 128 rows
// of the (K, D) noise (fp32 FMAs, the JAX dot's Precision.HIGHEST); bound by
// reading the noise once (2.4 MB, 0.7 us).  flash_merge merges the blocks.
//
// The ops-level kernels, which no controller routes to (as in JAX; they
// take K on rows, the (K, D) layout).  fused_sampler: one warp per sample
// row.  The warp stages its row's normals in shared memory (from the
// (K_pad[/2], D) int32 bits, lanes over d, or from Philox, lanes over
// counters), then lane d computes n_d = z_d op_d + mu_d, or sum_j z_j
// op[j, d] + mu_d for a full (D, D) op (row j of op is coalesced across the
// lanes; the op stays in L2, 360 KB at D = 300), the null row, the clamp,
// and writes perturbed[k, d]: coalesced reads of bits and writes of the
// output, which bound it (4.9 MB at the flagship, 1.5 us at 3.35 TB/s).  The
// action cost is a warp-shuffle sum.  The round-1 solve (rowmajor): kernel
// A's kMPPI path with three runtime differences, so it adds no
// instantiation: the block stages its 128 rows of the (K_pad, D) bits
// through the tile with coalesced loads; the noise is chol @ z_t + mu per
// timestep (T nu^2 FMAs a sample, not the D^2 of the TPU's kron(I_T,
// chol^T)); mu, lo and hi are per-step (nu,) vectors.  No antithetic sign.
//
// Left for later: kernel A's single-plant variants keep their shared-memory
// tree reductions, their serial update loop and their N = 8 register arrays
// (the batched kernel's changes, not yet carried over); two samples a thread
// in the batched rollout; one pass with a last-block merge in place of
// kernel B.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each entry
// returns cudaGetLastError() after its launches.  The file builds whole, or
// as eleven translation units selected by -DFUSED_MPPI_PART=0..10 (0-4: the
// single-plant variants and the rollout kernel of each device model and
// register size; 5: kernel B, the weighted update, the sampler and the entry
// points; 6-10: the batched kernel of each device model and register size),
// which ops/_build.py compiles in parallel and links.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FUSED_MPPI_PART
#define FUSED_MPPI_PART -1  // the whole library in one translation unit
#endif
#define FUSED_MPPI_HAS(k) (FUSED_MPPI_PART == -1 || FUSED_MPPI_PART == (k))

namespace fused_mppi {

constexpr int BLOCK = 128;  // samples (threads) per block of kernel A
constexpr int MAXN = 32;  // largest nx or nu of a device model
constexpr int MERGE_THREADS = 256;

// kRollout selects fused_rollout through the same launchers
enum Variant { kMPPI = 0, kSMPPI = 1, kKMPPI = 2, kBatched = 3, kRollout = 4 };

struct Params {
  const float* consts;
  int K, T, nx, nu, D, R, nblocks;  // R: rows drawn and updated (D, or Dp for KMPPI)
  int num_plants;  // kBatched: N; 1 otherwise
  int plant_group;  // kBatched: P, the plants of one block of batched_partial
  const int* bits;  // (R, bits_cols) int32, or null in seed mode
  int bits_cols;
  unsigned key0, key1;
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
  float* scratch;  // kGlobal: (launched blocks, tiles, R, BLOCK)
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

// --- kernel A ---------------------------------------------------------------

// Sample k's R drawn rows, the antithetic sign times the normal, into z[0],
// z[ldt], ... from the injected bits or from Philox.  Antithetic pairing
// inside each pairing block (pallas_rollout.py:403-404): sample j of block b
// takes source column b*bh + j, or the mirrored draw of j - bh.  The draw
// depends on the source column only, so the plants of a batch share it
// (mppi.py:837-838).
__device__ __forceinline__ void draw_column(const Params& p, int k, float* z, int ldt) {
  const int R = p.R;
  int src = k;
  float sgn = 1.0f;
  if (p.antithetic) {
    const int b = k / p.pair_block, j = k % p.pair_block, bh = p.pair_block / 2;
    src = b * bh + (j < bh ? j : j - bh);
    if (j >= bh) sgn = -1.0f;
  }
  if (p.bits) {
    for (int d = 0; d < R; ++d)
      z[d * ldt] = sgn * bits_to_normal((unsigned)p.bits[(size_t)d * p.bits_cols + src]);
  } else {
    for (int g = 0; 4 * g < R; ++g) {
      const uint4 r = philox4x32_10(make_uint4((unsigned)src, (unsigned)g, 0u, 0u), p.key0, p.key1);
      const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (4 * g + w < R) z[(4 * g + w) * ldt] = sgn * bits_to_normal(words[w]);
    }
  }
}

template <class Model, int N, bool kGlobal, int V>
__global__ void __launch_bounds__(BLOCK) mppi_fused_partial(Params p) {
  constexpr int LDT = kGlobal ? BLOCK : BLOCK + 1;  // row stride of the tiles
  constexpr bool kUpdateU = V == kMPPI;  // rows are U + noise, clamped
  extern __shared__ float smem[];
  const int D = p.D, R = p.R;
  const size_t blk = blockIdx.x;  // partials and scratch slot
  float* red = smem;  // BLOCK
  float* ws = red + BLOCK;  // BLOCK softmax weights
  float* Ws = ws + BLOCK;  // (D, R) KMPPI interpolation, shared path only
  constexpr bool kSharedW = V == kKMPPI && !kGlobal;
  float* ps = kGlobal ? p.scratch + blk * (p.full_op ? 2 : 1) * R * BLOCK
                      : Ws + (kSharedW ? (size_t)D * R : 0);  // (R, LDT) drawn rows
  float* zs = ps + (size_t)R * LDT;  // (R, LDT) raw normals, full op only
  const float* W = kSharedW ? Ws : p.W;
  if (kSharedW) {
    for (int i = threadIdx.x; i < D * R; i += BLOCK) Ws[i] = p.W[i];
    __syncthreads();
  }

  const int tid = threadIdx.x;
  const int k = blockIdx.x * BLOCK + tid;
  const bool live = k < p.K;
  const bool rowmajor = V == kMPPI && p.rowmajor;
  float* zdst = p.full_op ? zs : ps;
  float logit = -INFINITY;

  if (rowmajor && p.bits) {
    // the block's BLOCK rows of the (K_pad, D) bits are contiguous: read them
    // coalesced and store them transposed into the tile (K_pad covers every
    // row of the last block)
    const int* rows = p.bits + (size_t)blockIdx.x * BLOCK * D;
    for (int i = tid; i < BLOCK * D; i += BLOCK) {
      const int r = i / D;
      zdst[(i - r * D) * LDT + r] = bits_to_normal((unsigned)rows[i]);
    }
    __syncthreads();
  }

  if (live) {
    if (!(rowmajor && p.bits)) draw_column(p, k, zdst + tid, LDT);  // else staged above

    const float dt = V == kSMPPI ? *p.dt : 1.0f;
    float pc = 0.0f;  // action cost of the rectified noise
    for (int d = 0; d < R; ++d) {
      // the per-step vectors of the round-1 solve are indexed by the action
      const int dv = rowmajor ? d % p.nu : d;
      float n;
      if (rowmajor) {
        // chol @ z_t + mu for timestep t (pallas_rollout.py:1627-1630)
        const int t = d / p.nu;
        const float* crow = p.op + dv * p.nu;
        const float* zt = zs + (size_t)t * p.nu * LDT + tid;
        float acc = 0.0f;
        for (int j = 0; j < p.nu; ++j) acc += crow[j] * zt[j * LDT];
        n = acc + p.mu[dv];
      } else if (p.full_op) {
        float acc = 0.0f;
        const float* row = p.op + (size_t)d * R;
        for (int e = 0; e < R; ++e) acc += row[e] * zs[e * LDT + tid];
        n = acc + p.mu[d];
      } else {
        n = ps[d * LDT + tid] * p.op[d] + p.mu[d];
      }
      float v;
      if (kUpdateU) {
        const float u0 = p.U[d];
        v = u0 + n;
        if (V == kMPPI && p.null_action && k == 0) v = 0.0f;
        v = fminf(fmaxf(v, p.lo[dv]), p.hi[dv]);
        if (p.pert) p.pert[(size_t)d * p.K + k] = v;
        const float r = v - u0;  // rectified noise (mppi.py:383-385)
        pc += (p.abs_cost ? fabsf(r) : r) * p.a[d];
      } else if (V == kSMPPI) {
        // rate clamp, integrate, null row, action clamp (mppi.py:539-552)
        const float u0 = p.U[d], as = p.base[d];
        const float rate = fminf(fmaxf(u0 + n, p.lo[d]), p.hi[d]);
        v = __fadd_rn(as, __fmul_rn(rate, dt));  // two roundings, as as + rate*dt
        if (p.null_action && k == 0) v = 0.0f;
        v = fminf(fmaxf(v, p.alo[d]), p.ahi[d]);
        if (p.pert) p.pert[(size_t)d * p.K + k] = v;
        const float r = (v - as) / dt - u0;  // noise through both clamps (mppi.py:552)
        pc += (p.abs_cost ? fabsf(r) : r) * p.a[d];
      } else {
        // support points, clamped (mppi.py:657-664)
        v = fminf(fmaxf(p.base[d] + n, p.lo[d]), p.hi[d]);
      }
      ps[d * LDT + tid] = v;
    }

    // initial state: the sample's column of x0
    float x[N], u[N], prev[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = i < p.nx ? p.x0[i * p.x0_row_stride + (long long)k * p.x0_col_stride] : 0.0f;
      prev[i] = 0.0f;
    }
    float total = 0.0f, smooth = 0.0f;
    for (int t = 0; t < p.T; ++t) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float act = 0.0f;
        if (j < p.nu) {
          const int d = t * p.nu + j;
          if (V == kKMPPI) {
            // the full-horizon row d: W[d, :] . pts, then the null row and
            // the trajectory clamp; its rectified noise is charged here
            float acc = 0.0f;
            const float* wrow = W + (size_t)d * R;
            for (int e = 0; e < R; ++e) acc = fmaf(wrow[e], ps[e * LDT + tid], acc);
            act = (p.null_action && k == 0) ? 0.0f : acc;
            act = fminf(fmaxf(act, p.alo[d]), p.ahi[d]);
            if (p.pert) p.pert[(size_t)d * p.K + k] = act;
            const float r = act - p.U[d];
            pc += (p.abs_cost ? fabsf(r) : r) * p.a[d];
          } else {
            act = ps[d * LDT + tid];
          }
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
      Model::template step<N>(p.consts, x, u, p.nx, p.nu);
      total += Model::template cost<N>(p.consts, x, u, p.nx, p.nu);
    }
    const float c = (V == kSMPPI ? pc + *p.w_seq * smooth : pc) + total;
    p.cost[k] = c;
    logit = -c / *p.lam;
  } else {
    // phantom sample: the rows of a zero update keep the sum finite
    for (int d = 0; d < R; ++d) ps[d * LDT + tid] = kUpdateU ? p.U[d] : p.base[d];
  }

  // block max of the logits
  red[tid] = logit;
  __syncthreads();
  for (int h = BLOCK / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = fmaxf(red[tid], red[tid + h]);
    __syncthreads();
  }
  const float m_b = red[0];
  __syncthreads();
  const float w = (live && m_b > -INFINITY) ? expf(logit - m_b) : 0.0f;
  ws[tid] = w;
  red[tid] = w;
  __syncthreads();
  for (int h = BLOCK / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  float* out = p.partial + blk * (R + 2);
  if (tid == 0) {
    out[0] = m_b;
    out[1] = red[0];
  }
  const float dt = V == kSMPPI ? *p.dt : 1.0f;
  for (int d = tid; d < R; d += BLOCK) {
    const float* row = ps + d * LDT;
    float acc = 0.0f;
    if (V == kSMPPI) {
      // the update accumulates the rate-space noise
      const float as = p.base[d], u0 = p.U[d];
      for (int i = 0; i < BLOCK; ++i) acc += ws[i] * ((row[i] - as) / dt - u0);
    } else {
      const float b0 = kUpdateU ? p.U[d] : p.base[d];
      for (int i = 0; i < BLOCK; ++i) acc += ws[i] * (row[i] - b0);
    }
    out[2 + d] = acc;
  }
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
      draw_column(p, k, nt + tid, LDT);
      for (int d = 0; d < R; ++d) nt[d * LDT + tid] = nt[d * LDT + tid] * p.op[d] + p.mu[d];
    } else {
      for (int d = 0; d < R; ++d) nt[d * LDT + tid] = 0.0f;
    }
  } else {
    // op @ z + mu on the thread's own column
    if (live) draw_column(p, k, zs + tid, LDT);
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

// make_fused_rollout's kernel: sample k = blockIdx.x * BLOCK + threadIdx.x
// rolls the model out from its column of x0 over its row of the (K, T*nu)
// scaled actions p.U and writes its summed running cost; the cost is taken
// after each step.  Samples at and beyond K are not launched work.
template <class Model, int N>
__global__ void __launch_bounds__(BLOCK) fused_rollout(Params p) {
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  if (k >= p.K) return;
  const float* row = p.U + (size_t)k * p.D;
  float x[N], u[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = i < p.nx ? p.x0[i * p.x0_row_stride + (long long)k * p.x0_col_stride] : 0.0f;
  float total = 0.0f;
  for (int t = 0; t < p.T; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) u[j] = j < p.nu ? row[t * p.nu + j] : 0.0f;
    Model::template step<N>(p.consts, x, u, p.nx, p.nu);
    total += Model::template cost<N>(p.consts, x, u, p.nx, p.nu);
  }
  p.cost[k] = total;
}

// --- kernel B and the legacy route's weighted update -----------------------------

#if FUSED_MPPI_HAS(5)
constexpr int MERGE_CHUNK = 4096;  // block scales held in shared memory at a time

// One block per plant: plant n = blockIdx.x merges its nblocks partials and
// writes column n of delta (R, plants) and of ms (2, plants).  The threads
// reduce m = max m_b over the blocks; each block's scale e^(m_b - m) is taken
// once, into shared memory, a chunk of MERGE_CHUNK blocks at a time; the
// threads reduce s = sum s_b e^(m_b - m).  For delta the threads form G
// groups of `rows` threads: thread d of group g sums acc_b[d] times the
// scales over the blocks b = g, g + G, ... (reading the partials coalesced
// across d), and group 0 adds the G sums.
__global__ void __launch_bounds__(MERGE_THREADS)
    flash_merge(const float* partial, int nblocks, int R, float* delta, float* ms) {
  __shared__ float scale[MERGE_CHUNK];
  __shared__ float part[MERGE_THREADS];
  __shared__ float red[MERGE_THREADS / 32];
  const int plant = blockIdx.x, plants = gridDim.x, tid = threadIdx.x;
  const int stride = R + 2;
  const int rows = R < MERGE_THREADS ? R : MERGE_THREADS;
  const int G = MERGE_THREADS / rows, g = tid / rows, dl = tid - g * rows;
  partial += (size_t)plant * nblocks * stride;
  float m = -INFINITY;
  for (int b = tid; b < nblocks; b += MERGE_THREADS) m = fmaxf(m, partial[(size_t)b * stride]);
  m = block_reduce<true>(m, red);
  float s = 0.0f;
  for (int c0 = 0; c0 < nblocks; c0 += MERGE_CHUNK) {
    const int n = nblocks - c0 < MERGE_CHUNK ? nblocks - c0 : MERGE_CHUNK;
    const float* chunk = partial + (size_t)c0 * stride;
    if (c0 > 0) __syncthreads();  // the previous chunk's scales are read
    for (int b = tid; b < n; b += MERGE_THREADS) {
      const float sc = expf(chunk[(size_t)b * stride] - m);
      scale[b] = sc;
      s += chunk[(size_t)b * stride + 1] * sc;
    }
    __syncthreads();
    for (int d0 = 0; d0 < R; d0 += rows) {
      const int d = d0 + dl;
      float acc = 0.0f;
      if (g < G && d < R)
        for (int b = g; b < n; b += G) acc = fmaf(chunk[(size_t)b * stride + 2 + d], scale[b], acc);
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

// fused_weighted_update's first pass: block b takes the softmax weights of
// samples [b*BLOCK, (b+1)*BLOCK) against its own largest logit, then thread
// d sums column d of those rows of the (K, D) noise (row stride ld) under
// the weights; partial[b] = (m_b, s_b, acc_b[0..D)).  Rows at and beyond K
// weigh exactly 0 and are not read.
__global__ void __launch_bounds__(BLOCK)
    weighted_partial(const float* cost, const float* noise, long long ld, int K, int D,
                     const float* lam, float* partial) {
  __shared__ float red[BLOCK], ws[BLOCK];
  const int tid = threadIdx.x, k0 = blockIdx.x * BLOCK, k = k0 + tid;
  const bool live = k < K;
  const float logit = live ? -cost[k] / *lam : -INFINITY;
  red[tid] = logit;
  __syncthreads();
  for (int h = BLOCK / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = fmaxf(red[tid], red[tid + h]);
    __syncthreads();
  }
  const float m_b = red[0];
  __syncthreads();
  const float w = (live && m_b > -INFINITY) ? expf(logit - m_b) : 0.0f;
  ws[tid] = w;
  red[tid] = w;
  __syncthreads();
  for (int h = BLOCK / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * (D + 2);
  if (tid == 0) {
    out[0] = m_b;
    out[1] = red[0];
  }
  const int rows = K - k0 < BLOCK ? K - k0 : BLOCK;
  for (int d = tid; d < D; d += BLOCK) {
    const float* col = noise + (size_t)k0 * ld + d;
    float acc = 0.0f;
    for (int i = 0; i < rows; ++i) acc += ws[i] * col[(size_t)i * ld];
    out[2 + d] = acc;
  }
}

// --- the sampling front-end ------------------------------------------------------

constexpr int SAMPLER_WARPS = 8;  // sample rows per block of fused_sampler

struct SamplerParams {
  int K, D;
  const int* bits;  // (rows, D) int32, or null in seed mode
  unsigned key0, key1;
  int block_k, antithetic, null_action, abs_cost, full_op;
  const float* U;  // (D,) the nominal sequence
  const float* op;  // (D,) diagonal scale, or (D, D) row-major applied as z @ op
  const float* mu;  // (D,)
  const float* lo;
  const float* hi;
  const float* a;  // (D,) action-cost vector
  float* pert;  // (K, D)
  float* cost;  // (K,)
};

// make_fused_sampler's kernel: warp w of block b takes sample row
// k = b * warps + w.  Its source row and sign are the JAX kernel's pairing
// (rows j and j + block_k/2 of each K block mirror one draw); element d of
// source row r is the bits' (r, d), or word d % 4 of Philox counter
// (r, d / 4, 0, 0).  The warp stages the row's normals in shared memory, then
// lane d writes perturbed[k, d] = clip(U_d + n_d, lo_d, hi_d) (0 before the
// clamp on the null row k = 0) and the lanes sum the action cost of the
// rectified noise.
__global__ void fused_sampler(SamplerParams p) {
  extern __shared__ float zsh[];  // (warps, D) normals
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x * warps + warp;
  if (k >= p.K) return;  // the whole warp leaves: no block barrier follows
  const int D = p.D;
  float* z = zsh + (size_t)warp * D;
  int src = k;
  float sgn = 1.0f;
  if (p.antithetic) {
    const int b = k / p.block_k, j = k % p.block_k, bh = p.block_k / 2;
    src = b * bh + (j < bh ? j : j - bh);
    if (j >= bh) sgn = -1.0f;
  }
  if (p.bits) {
    const int* row = p.bits + (size_t)src * D;
    for (int d = lane; d < D; d += 32) z[d] = sgn * bits_to_normal((unsigned)row[d]);
  } else {
    for (int g = lane; 4 * g < D; g += 32) {
      const uint4 r = philox4x32_10(make_uint4((unsigned)src, (unsigned)g, 0u, 0u), p.key0, p.key1);
      const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (4 * g + w < D) z[4 * g + w] = sgn * bits_to_normal(words[w]);
    }
  }
  __syncwarp();
  float pc = 0.0f;
  float* out = p.pert + (size_t)k * D;
  for (int d = lane; d < D; d += 32) {
    float n;
    if (p.full_op) {
      // z @ op in fp32 FMAs (the JAX dot's Precision.HIGHEST, no TF32)
      float acc = 0.0f;
      for (int j = 0; j < D; ++j) acc += z[j] * p.op[(size_t)j * D + d];
      n = acc + p.mu[d];
    } else {
      n = z[d] * p.op[d] + p.mu[d];
    }
    const float u0 = p.U[d];
    float v = u0 + n;
    if (p.null_action && k == 0) v = 0.0f;
    v = fminf(fmaxf(v, p.lo[d]), p.hi[d]);
    out[d] = v;
    const float r = v - u0;  // rectified noise (mppi.py:383-385)
    pc += (p.abs_cost ? fabsf(r) : r) * p.a[d];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) pc += __shfl_down_sync(0xffffffffu, pc, off);
  if (lane == 0) p.cost[k] = pc;
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
  mppi_fused_partial<Model, N, kGlobal, V><<<p.nblocks, BLOCK, smem, stream>>>(p);
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

// parts 0-4: the single-plant variants and the rollout kernel
template <class Model, int N>
cudaError_t launch_tiles(const Params& p, int variant, size_t smem, cudaStream_t s) {
  if (variant == kRollout) {
    fused_rollout<Model, N><<<p.nblocks, BLOCK, 0, s>>>(p);
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
cudaError_t launch_pendulum8(const Params& p, int v, size_t smem, cudaStream_t s) {
  return launch_tiles<Pendulum, 8>(p, v, smem, s);
}
#else
cudaError_t launch_pendulum8(const Params&, int, size_t, cudaStream_t);
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
// (8 or MAXN; for the batched kernel 2, 8 or MAXN), or null.
Launcher find_launcher(int variant, int model_id, int nx, int nu) {
  const int n = nx > nu ? nx : nu;
  const Launcher single[3][2] = {{launch_lq8, launch_lq32},
                                 {launch_pendulum8, nullptr},
                                 {launch_toy8, launch_toy32}};
  const Launcher batched[3][3] = {{batched_lq2, batched_lq8, batched_lq32},
                                  {batched_pendulum2, nullptr, nullptr},
                                  {batched_toy2, batched_toy8, batched_toy32}};
  if (model_id < 0 || model_id > 2 || n > MAXN) return nullptr;
  if (variant == kBatched) return batched[model_id][n <= 2 ? 0 : n <= 8 ? 1 : 2];
  return single[model_id][n <= 8 ? 0 : 1];
}

// Kernel A for `variant`, then kernel B into delta and ms.
cudaError_t launch_pair(const Params& p, int variant, int model_id, size_t smem,
                        cudaStream_t stream, float* delta, float* ms) {
  const Launcher launch = find_launcher(variant, model_id, p.nx, p.nu);
  if (!launch) return cudaErrorInvalidValue;
  const cudaError_t e = launch(p, variant, smem, stream);
  if (e != cudaSuccess) return e;
  flash_merge<<<p.num_plants, MERGE_THREADS, 0, stream>>>(p.partial, p.nblocks, p.R, delta, ms);
  return cudaGetLastError();
}

// Dynamic shared memory of kernel A, or of batched_partial for kBatched, with
// the tiles in shared memory or (`global`) in a global scratch.
size_t kernel_smem(int variant, int D, int R, int full_op, bool global) {
  const int ldt = variant == kBatched ? BATCHED_LDT : BLOCK + 1;
  const size_t tiles = global ? 0 : (full_op ? 2 : 1) * (size_t)R * ldt;
  if (variant == kBatched) return (batched_head(R) + tiles) * sizeof(float);
  const size_t w = variant == kKMPPI && !global ? (size_t)D * R : 0;
  return (2 * BLOCK + w + tiles) * sizeof(float);
}

}  // namespace

extern "C" {

int fused_mppi_block() { return BLOCK; }

int fused_mppi_max_n() { return MAXN; }

// Dynamic shared memory of kernel A (batched_partial for kBatched) with the
// tiles in shared memory (the wrapper checks it against the card's 227 KB,
// and otherwise passes a global scratch).
long long fused_mppi_smem_bytes(int variant, int D, int R, int full_op) {
  return (long long)kernel_smem(variant, D, R, full_op, false);
}

const char* fused_mppi_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Launches kernel A (batched_partial for kBatched) then kernel B on `stream`;
// returns cudaGetLastError().  `scratch` is null for the shared-memory tiles,
// else (launched blocks, tiles, R, BLOCK).  kBatched takes `num_plants`
// plants in groups of `plant_group` a block, U and a as (D, N) with the
// strides (u_rs, u_ps) and (a_rs, a_ps), and in operand mode the final noise
// (R, noise_ld); the other variants take one plant.
int fused_mppi_launch(int device, void* stream, int variant, int model_id, const float* consts,
                      int K, int T, int nx, int nu, int R,
                      const int* bits, int bits_cols, unsigned key0, unsigned key1,
                      int pair_block, int antithetic, int null_action, int abs_cost,
                      const float* x0, long long x0_row_stride, long long x0_col_stride,
                      const float* U, const float* base, const float* op, int full_op,
                      const float* mu, const float* lo, const float* hi, const float* alo,
                      const float* ahi, const float* a, const float* W, const float* lam,
                      const float* w_seq, const float* dt, float u_scale, float* cost,
                      float* partial, float* delta, float* ms, float* pert, float* scratch,
                      int num_plants, long long u_rs, long long u_ps, long long a_rs,
                      long long a_ps, const float* noise, long long noise_ld, int plant_group) {
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
  p.nblocks = (K + BLOCK - 1) / BLOCK;
  p.num_plants = num_plants;
  p.plant_group = plant_group;
  p.bits = bits;
  p.bits_cols = bits_cols;
  p.key0 = key0;
  p.key1 = key1;
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
  const size_t smem = kernel_smem(variant, p.D, R, full_op, scratch != nullptr);
  if (variant < kMPPI || variant > kBatched || num_plants < 1 ||
      (variant == kBatched ? plant_group < 1 : num_plants != 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_pair(p, variant, model_id, smem, (cudaStream_t)stream, delta, ms);
}

// make_fused_solve (the round-1 solve) on `stream`: kernel A's kMPPI path with
// `rowmajor`, then kernel B.  bits (K_pad, D) row-major int32, or null with a
// Philox key; x0 (nx,) with stride x0_stride; U and a (D,); chol (nu, nu)
// row-major; mu, lo, hi (nu,).  `scratch` as for fused_mppi_launch (two
// tiles).
int fused_mppi_rowmajor_solve(int device, void* stream, int model_id, const float* consts, int K,
                              int T, int nx, int nu, const int* bits, unsigned key0,
                              unsigned key1, int null_action, int abs_cost, const float* x0,
                              long long x0_stride, const float* U, const float* chol,
                              const float* mu, const float* lo, const float* hi, const float* a,
                              const float* lam, float u_scale, float* cost, float* partial,
                              float* delta, float* ms, float* scratch) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{};
  p.consts = consts;
  p.K = K;
  p.T = T;
  p.nx = nx;
  p.nu = nu;
  p.D = p.R = T * nu;
  p.nblocks = (K + BLOCK - 1) / BLOCK;
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
  const size_t smem = kernel_smem(kMPPI, p.D, p.R, 1, scratch != nullptr);
  return (int)launch_pair(p, kMPPI, model_id, smem, (cudaStream_t)stream, delta, ms);
}

// make_fused_sampler's kernel on `stream`: perturbed (K, D) and cost (K,)
// from bits (rows, D) int32 or a Philox key.  Returns cudaErrorInvalidValue
// when one row of normals does not fit in a block's shared memory.
int fused_mppi_sampler(int device, void* stream, int K, int D, const int* bits, unsigned key0,
                       unsigned key1, int block_k, int antithetic, int null_action, int abs_cost,
                       int full_op, const float* U, const float* op, const float* mu,
                       const float* lo, const float* hi, const float* a, float* pert,
                       float* cost) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t max_smem = 232448, row = (size_t)D * sizeof(float);
  const int warps = row * SAMPLER_WARPS <= max_smem ? SAMPLER_WARPS : (int)(max_smem / row);
  if (warps < 1 || K < 1 || (antithetic && block_k % 2)) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * row;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_sampler, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  SamplerParams p{K, D, bits, key0, key1, block_k, antithetic, null_action, abs_cost, full_op,
                  U, op, mu, lo, hi, a, pert, cost};
  fused_sampler<<<(K + warps - 1) / warps, warps * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// make_fused_rollout's kernel on `stream`: cost (K,) of the (K, T*nu) scaled
// actions u (row-major) from x0 (nx, K) with the given strides.
int fused_mppi_rollout(int device, void* stream, int model_id, const float* consts, int K, int T,
                       int nx, int nu, const float* x0, long long x0_row_stride,
                       long long x0_col_stride, const float* u, float* cost) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{};
  p.consts = consts;
  p.K = K;
  p.T = T;
  p.nx = nx;
  p.nu = nu;
  p.D = T * nu;
  p.nblocks = (K + BLOCK - 1) / BLOCK;
  p.num_plants = 1;
  p.x0 = x0;
  p.x0_row_stride = x0_row_stride;
  p.x0_col_stride = x0_col_stride;
  p.U = u;
  p.cost = cost;
  const Launcher launch = find_launcher(kRollout, model_id, nx, nu);
  if (!launch) return (int)cudaErrorInvalidValue;
  return (int)launch(p, kRollout, 0, (cudaStream_t)stream);
}

// fused_weighted_update on `stream`: weighted_partial over the (K, D) noise
// (row stride ld) into partial (nblocks, D + 2), then flash_merge into
// delta (D,) and ms (2,).
int fused_mppi_weighted_update(int device, void* stream, int K, int D, const float* cost,
                               const float* noise, long long ld, const float* lam,
                               float* partial, float* delta, float* ms) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (K + BLOCK - 1) / BLOCK;
  weighted_partial<<<nblocks, BLOCK, 0, (cudaStream_t)stream>>>(cost, noise, ld, K, D, lam,
                                                                partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_merge<<<1, MERGE_THREADS, 0, (cudaStream_t)stream>>>(partial, nblocks, D, delta, ms);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
