// One whole MPPI iteration for one plant, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel pallas_rollout.py:512 make_transposed_fused_solve
// (pytorch_mppi_tpu/ops/pallas_rollout.py).  It computes, for K samples of a
// D = T*nu flat action sequence: the normals (from injected int32 bits or from
// Philox4x32-10), the antithetic sign, the noise transform (diagonal scale or
// full (D, D) operator), U + noise, the null-action row, the clamp, the
// rectified noise and its action cost, the T-step rollout of a device model
// with u_scale, and the streaming softmax statistics.  The contract is the
// JAX one: (delta, m, s, cost) with U_new = U + delta / s.
//
// Design.  The TPU kernel walks its K blocks in order and carries (m, s, acc)
// in scratch; GPU blocks run at the same time.  So the work is two kernels:
//   A. mppi_fused_partial<Model>: one thread per sample, BLOCK samples per
//      block.  A thread keeps its perturbed column in shared memory (row
//      stride BLOCK + 1, so the column writes and the row reads of the update
//      are free of bank conflicts), rolls the model out in registers, and
//      writes cost[k].  The block then reduces its own max m_b, sum s_b and
//      acc_b[d] = sum_k w_k n_k[d] and writes them to a (nblocks, D + 2) scratch.
//      Threads with k >= K take no part (the counterpart of _tp_mask_phantom).
//   B. flash_merge: one block merges the partials,
//      m = max m_b, s = sum s_b e^(m_b - m), delta[d] = sum acc_b[d] e^(m_b - m).
// The noise never reaches device memory unless the caller asks for the
// perturbed actions (emit_perturbed).
//
// What bounds it on an H100 SXM.  At the flagship shape (K = 10,000, T = 30,
// nu = 2, seed mode) it reads and writes about 41 KB (the cost row and the
// small operands), which takes about 0.012 us at 3.35 TB/s.  Its float32 work
// is about 60 normals (Philox + Giles' erfinv, about 55 operations each) and
// 30 model steps per sample, some 4e7 operations, about 0.6 us at 67 TFLOP/s.
// So it is bound by launch latency and by how few of the 132 SMs its 79
// blocks of 128 threads fill.  chip_smoke.py computes the exact bound from
// the run's shapes.
//
// Left for later: warp-shuffle reductions in place of the shared-memory ones,
// several samples per thread, and one pass with a last-block merge in place
// of kernel B.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each entry
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;  // samples (threads) per block of kernel A
constexpr int LD = BLOCK + 1;  // row stride of the shared (D, BLOCK) tiles
constexpr int MAXN = 8;  // largest nx or nu of a device model
constexpr int MERGE_THREADS = 256;

struct Params {
  const float* consts;
  int K, T, nx, nu, D, nblocks;
  const int* bits;  // (D, bits_cols) int32, or null in seed mode
  int bits_cols;
  unsigned key0, key1;
  int pair_block, antithetic, null_action, abs_cost, full_op;
  const float* x0;  // (nx, K) with the strides below (col stride 0: shared)
  long long x0_row_stride, x0_col_stride;
  const float* U;
  const float* op;  // (D,) diagonal or (D, D) row-major
  const float* mu;
  const float* lo;
  const float* hi;
  const float* a;
  const float* lam;  // device scalar
  float u_scale;
  float* cost;  // (K,)
  float* partial;  // (nblocks, D + 2): m_b, s_b, acc_b[0..D)
  float* pert;  // (D, K) or null
};

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

// x' = x + u B^T, cost |goal - x'|^2; consts = B (nx, nu) row-major, goal (nx).
struct LinearQuadratic {
  __device__ static void step(const float* c, float* x, const float* u, int nx, int nu) {
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < nx) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXN; ++j)
          if (j < nu) acc += u[j] * c[i * nu + j];
        x[i] = x[i] + acc;
      }
    }
  }
  __device__ static float cost(const float* c, const float* x, const float*, int nx, int nu) {
    const float* goal = c + nx * nu;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < nx) {
        const float d = goal[i] - x[i];
        s += d * d;
      }
    }
    return s;
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
  __device__ static void step(const float*, float* x, const float* u, int, int) {
    const float th = x[0], thdot = x[1];
    const float uc = fminf(fmaxf(u[0], -2.0f), 2.0f);
    float nthdot = thdot + (15.0f * sinf(th) + 3.0f * uc) * 0.05f;
    nthdot = fminf(fmaxf(nthdot, -8.0f), 8.0f);
    x[0] = th + nthdot * 0.05f;
    x[1] = nthdot;
  }
  __device__ static float cost(const float*, const float* x, const float*, int, int) {
    const float an = angle_normalize(x[0]);
    return an * an + 0.1f * (x[1] * x[1]);
  }
};

// --- kernel A ---------------------------------------------------------------

template <class Model>
__global__ void __launch_bounds__(BLOCK) mppi_fused_partial(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  float* ps = smem;  // (D, LD) perturbed actions of this block
  float* zs = ps + (size_t)D * LD;  // (D, LD) raw normals, full op only
  float* red = zs + (p.full_op ? (size_t)D * LD : 0);  // BLOCK
  float* ws = red + BLOCK;  // BLOCK softmax weights

  const int tid = threadIdx.x;
  const int k = blockIdx.x * BLOCK + tid;
  const bool live = k < p.K;
  float logit = -INFINITY;

  if (live) {
    // antithetic pairing inside each pairing block (pallas_rollout.py:403-404):
    // sample j of block b takes source column b*bh + j, or the mirrored
    // draw of j - bh
    int src = k;
    float sgn = 1.0f;
    if (p.antithetic) {
      const int b = k / p.pair_block, j = k % p.pair_block, bh = p.pair_block / 2;
      src = b * bh + (j < bh ? j : j - bh);
      if (j >= bh) sgn = -1.0f;
    }
    float* zdst = p.full_op ? zs : ps;
    if (p.bits) {
      for (int d = 0; d < D; ++d)
        zdst[d * LD + tid] = sgn * bits_to_normal((unsigned)p.bits[(size_t)d * p.bits_cols + src]);
    } else {
      for (int g = 0; 4 * g < D; ++g) {
        const uint4 r = philox4x32_10(make_uint4((unsigned)src, (unsigned)g, 0u, 0u), p.key0, p.key1);
        const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (4 * g + w < D) zdst[(4 * g + w) * LD + tid] = sgn * bits_to_normal(words[w]);
      }
    }

    float pc = 0.0f;
    for (int d = 0; d < D; ++d) {
      float n;
      if (p.full_op) {
        float acc = 0.0f;
        const float* row = p.op + (size_t)d * D;
        for (int e = 0; e < D; ++e) acc += row[e] * zs[e * LD + tid];
        n = acc + p.mu[d];
      } else {
        n = ps[d * LD + tid] * p.op[d] + p.mu[d];
      }
      const float u0 = p.U[d];
      float v = u0 + n;
      if (p.null_action && k == 0) v = 0.0f;
      v = fminf(fmaxf(v, p.lo[d]), p.hi[d]);
      ps[d * LD + tid] = v;
      if (p.pert) p.pert[(size_t)d * p.K + k] = v;
      const float r = v - u0;  // rectified noise (mppi.py:383-385)
      pc += (p.abs_cost ? fabsf(r) : r) * p.a[d];
    }

    float x[MAXN], u[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      x[i] = i < p.nx ? p.x0[i * p.x0_row_stride + (long long)k * p.x0_col_stride] : 0.0f;
    float total = 0.0f;
    for (int t = 0; t < p.T; ++t) {
#pragma unroll
      for (int j = 0; j < MAXN; ++j)
        u[j] = j < p.nu ? ps[(t * p.nu + j) * LD + tid] * p.u_scale : 0.0f;
      Model::step(p.consts, x, u, p.nx, p.nu);
      total += Model::cost(p.consts, x, u, p.nx, p.nu);
    }
    const float c = pc + total;
    p.cost[k] = c;
    logit = -c / *p.lam;
  } else {
    // phantom sample: a zero rectified noise keeps the update sum finite
    for (int d = 0; d < D; ++d) ps[d * LD + tid] = p.U[d];
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
  float* out = p.partial + (size_t)blockIdx.x * (D + 2);
  if (tid == 0) {
    out[0] = m_b;
    out[1] = red[0];
  }
  for (int d = tid; d < D; d += BLOCK) {
    const float u0 = p.U[d];
    const float* row = ps + d * LD;
    float acc = 0.0f;
    for (int i = 0; i < BLOCK; ++i) acc += ws[i] * (row[i] - u0);
    out[2 + d] = acc;
  }
}

// --- kernel B ---------------------------------------------------------------

__global__ void flash_merge(const float* partial, int nblocks, int D, float* delta, float* ms) {
  __shared__ float m_sh;
  const int stride = D + 2;
  if (threadIdx.x == 0) {
    float m = -INFINITY;
    for (int b = 0; b < nblocks; ++b) m = fmaxf(m, partial[(size_t)b * stride]);
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b)
      s += partial[(size_t)b * stride + 1] * expf(partial[(size_t)b * stride] - m);
    ms[0] = m;
    ms[1] = s;
    m_sh = m;
  }
  __syncthreads();
  const float m = m_sh;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < nblocks; ++b)
      acc += partial[(size_t)b * stride + 2 + d] * expf(partial[(size_t)b * stride] - m);
    delta[d] = acc;
  }
}

template <class Model>
cudaError_t launch_partial(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mppi_fused_partial<Model>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  mppi_fused_partial<Model><<<p.nblocks, BLOCK, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_mppi_block() { return BLOCK; }

// Dynamic shared memory of kernel A for D rows (the wrapper checks it
// against the card's 227 KB).
long long fused_mppi_smem_bytes(int D, int full_op) {
  return (long long)((full_op ? 2 : 1) * (size_t)D * LD + 2 * BLOCK) * sizeof(float);
}

const char* fused_mppi_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Launches kernel A then kernel B on `stream`; returns cudaGetLastError().
int fused_mppi_launch(int device, void* stream, int model_id, const float* consts,
                      int K, int T, int nx, int nu,
                      const int* bits, int bits_cols, unsigned key0, unsigned key1,
                      int pair_block, int antithetic, int null_action, int abs_cost,
                      const float* x0, long long x0_row_stride, long long x0_col_stride,
                      const float* U, const float* op, int full_op, const float* mu,
                      const float* lo, const float* hi, const float* a, const float* lam,
                      float u_scale, float* cost, float* partial, float* delta, float* ms,
                      float* pert) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.consts = consts;
  p.K = K;
  p.T = T;
  p.nx = nx;
  p.nu = nu;
  p.D = T * nu;
  p.nblocks = (K + BLOCK - 1) / BLOCK;
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
  p.op = op;
  p.mu = mu;
  p.lo = lo;
  p.hi = hi;
  p.a = a;
  p.lam = lam;
  p.u_scale = u_scale;
  p.cost = cost;
  p.partial = partial;
  p.pert = pert;
  const size_t smem = (size_t)fused_mppi_smem_bytes(p.D, full_op);
  cudaStream_t s = (cudaStream_t)stream;
  switch (model_id) {
    case 0: e = launch_partial<LinearQuadratic>(p, smem, s); break;
    case 1: e = launch_partial<Pendulum>(p, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  flash_merge<<<1, MERGE_THREADS, 0, s>>>(partial, p.nblocks, p.D, delta, ms);
  return (int)cudaGetLastError();
}

}  // extern "C"
