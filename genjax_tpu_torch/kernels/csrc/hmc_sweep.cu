// Fused MH-adjusted HMC sweep for Hopper (sm_90a), one chain per thread.
//
// Replaces genjax_tpu/kernels/hmc.py::_hmc_kernel, the Pallas TPU kernel, and
// its in-kernel PRNG helpers _sw_rand_bits_factory, _uniform_01 and _normal
// (hmc.py:45-90), which became the counter-stream __device__ functions of
// column_common.cuh, shared with the NUTS sweep.
//
// What it computes: n_steps MH-adjusted HMC transitions on each of N chains.
// A step draws momentum p ~ N(0, M), runs L leapfrogs that carry (lp, grad)
// of the column log-density, and accepts on the Hamiltonian. Positions keep
// the reference's (D, N) layout, chains on the last axis.
//
// Design: each thread owns one chain and keeps q, p, grad, the proposal and
// lp in registers for all n_steps * L leapfrogs; D (8 or 16) is a template
// parameter so every per-dimension loop unrolls into registers. The density
// and its gradient are a hand-written device body chosen by a template
// parameter (CUDA has no autodiff): `iid_normal` and `hier_regression`, the
// flagship hierarchical regression, whose X and y sit in shared memory,
// loaded once per block and read as warp-wide broadcasts.
//
// Bound on this card: fp32 ALU. Per chain, a flagship leapfrog costs about
// 2 x 128 FMAs for X w and X^T r, so a sweep costs n_steps * L * 256 FMAs per
// chain, while it moves only 2 * D * 4 bytes of state per chain (one load and
// one store), whatever n_steps is.
//
// Random streams (runtime flag `rng`):
//   0 = counter: the bit-exact port of the reference's software stream,
//       keyed by (seed, chain block of `block_n`, column, dimension, salt).
//       The block is a stream parameter, independent of this launch geometry.
//   1 = philox: Philox4x32-10 from curand's header, keyed by (seed, global
//       chain index), counter (step, draw); held in law only.
//
// No fast-math: rejection relies on NaN and -inf comparing false, and
// Box-Muller needs accurate logf/cosf.

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include "column_common.cuh"  // K2's counter stream, the device bodies

namespace {

constexpr int kThreads = 128;

struct Params {
  const float* q_in;      // (D, N)
  float* q_out;           // (D, N)
  float* accepts;         // (N,) accepted steps per chain
  const float* inv_mass;  // (D,)
  const float* consts;    // body constants: X (n_obs x d_w, row-major), y
  int n_consts;
  int N;
  int n_obs;
  int d_w;
  float obs_scale;
  int n_steps;
  int L;
  float eps;
  uint32_t seed;
  int rng;
  int block_n;
};

// ---------------------------------------------------------------- sweep

template <int D, int BODY>
__global__ void __launch_bounds__(kThreads) hmc_sweep_kernel(const Params prm) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < prm.n_consts; k += blockDim.x) smem[k] = prm.consts[k];
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= prm.N) return;
  const BodyConsts body{smem, smem + prm.n_obs * prm.d_w, prm.n_obs, prm.d_w, prm.obs_scale};

  float q[D], g[D], p[D], qn[D], gn[D], im[D], mom_std[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = prm.q_in[static_cast<size_t>(d) * prm.N + n];
    im[d] = prm.inv_mass[d];
    mom_std[d] = sqrtf(1.0f / im[d]);
  }
  float lp = lp_grad<D, BODY>(q, g, body);

  // the counter stream's chain block and column (int32 wraparound of the
  // reference's seed + block * 0x3504F333 is uint32 arithmetic here)
  const uint32_t base = prm.seed + static_cast<uint32_t>(n / prm.block_n) * kBlockMix;
  const uint32_t col = static_cast<uint32_t>(n % prm.block_n);
  const uint2 philox_key = make_uint2(prm.seed, static_cast<uint32_t>(n));

  const float half_eps = prm.eps / 2.0f;
  float accepted = 0.0f;
  for (int i = 0; i < prm.n_steps; ++i) {
    const uint32_t salt = static_cast<uint32_t>(i) * 4u;
    if (prm.rng == kCounter) {
#pragma unroll
      for (int d = 0; d < D; ++d) p[d] = mom_std[d] * counter_normal(base, salt, d, col);
    } else {
#pragma unroll
      for (int j = 0; j < D / 4; ++j) {
        const uint4 b = curand_Philox4x32_10(
            make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(j), 0u, 0u),
            philox_key);
        float s0, c0, s1, c1;
        sincosf(kTwoPi * uniform_from_bits(b.y), &s0, &c0);
        sincosf(kTwoPi * uniform_from_bits(b.w), &s1, &c1);
        const float r0 = sqrtf(-2.0f * logf(uniform_from_bits(b.x)));
        const float r1 = sqrtf(-2.0f * logf(uniform_from_bits(b.z)));
        p[4 * j + 0] = mom_std[4 * j + 0] * r0 * c0;
        p[4 * j + 1] = mom_std[4 * j + 1] * r0 * s0;
        p[4 * j + 2] = mom_std[4 * j + 2] * r1 * c1;
        p[4 * j + 3] = mom_std[4 * j + 3] * r1 * s1;
      }
    }
    float ke0 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ke0 += im[d] * p[d] * p[d];
      qn[d] = q[d];
      gn[d] = g[d];
    }
    ke0 *= 0.5f;

    float lpn = lp;
    for (int l = 0; l < prm.L; ++l) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        p[d] += half_eps * gn[d];
        qn[d] += prm.eps * im[d] * p[d];
      }
      lpn = lp_grad<D, BODY>(qn, gn, body);
#pragma unroll
      for (int d = 0; d < D; ++d) p[d] += half_eps * gn[d];
    }
    float ke1 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) ke1 += im[d] * p[d] * p[d];
    ke1 *= 0.5f;

    const float log_alpha = (lpn - ke1) - (lp - ke0);
    float u;
    if (prm.rng == kCounter) {
      u = uniform_from_bits(counter_bits(base, salt + 2u, 0u, col));
    } else {
      const uint4 b = curand_Philox4x32_10(
          make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(D / 4), 0u, 0u),
          philox_key);
      u = uniform_from_bits(b.x);
    }
    // NaN or -inf log_alpha compares false: the proposal is rejected
    if (logf(u) < log_alpha) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        q[d] = qn[d];
        g[d] = gn[d];
      }
      lp = lpn;
      accepted += 1.0f;
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) prm.q_out[static_cast<size_t>(d) * prm.N + n] = q[d];
  prm.accepts[n] = accepted;
}

// Debug launch of the counter stream alone, over a (rows, cols) draw of one
// chain block (rows == 0 is the reference's 1-D shape, whose row index is 0).
__global__ void counter_stream_kernel(uint32_t* bits, float* uniforms, float* normals,
                                      uint32_t seed, uint32_t block, uint32_t salt,
                                      int rows, int cols) {
  const int total = (rows > 0 ? rows : 1) * cols;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const uint32_t r = rows > 0 ? static_cast<uint32_t>(idx / cols) : 0u;
  const uint32_t c = static_cast<uint32_t>(idx % cols);
  const uint32_t base = seed + block * kBlockMix;
  const uint32_t b = counter_bits(base, salt, r, c);
  bits[idx] = b;
  uniforms[idx] = uniform_from_bits(b);
  normals[idx] = counter_normal(base, salt, r, c);
}

template <int D, int BODY>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const int blocks = (prm.N + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(prm.n_consts) * sizeof(float);
  hmc_sweep_kernel<D, BODY><<<blocks, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int hmc_sweep(const float* q_in, float* q_out, float* accepts, const float* inv_mass,
              const float* consts, int n_consts, int body, int dim, int N, int n_obs,
              int d_w, float obs_scale, int n_steps, int L, float eps, int seed, int rng,
              int block_n, void* stream) {
  if (N <= 0 || block_n <= 0 || n_consts < 0 ||
      n_consts > static_cast<int>(48 * 1024 / sizeof(float)))
    return cudaErrorInvalidValue;
  if (body == kHierRegression && (d_w < 1 || d_w + 1 > dim || n_consts != n_obs * (d_w + 1)))
    return cudaErrorInvalidValue;
  Params prm{q_in, q_out, accepts, inv_mass, consts, n_consts, N, n_obs, d_w, obs_scale,
             n_steps, L, eps, static_cast<uint32_t>(seed), rng, block_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 8 && body == kIidNormal) return launch<8, kIidNormal>(prm, s);
  if (dim == 16 && body == kIidNormal) return launch<16, kIidNormal>(prm, s);
  if (dim == 8 && body == kHierRegression) return launch<8, kHierRegression>(prm, s);
  if (dim == 16 && body == kHierRegression) return launch<16, kHierRegression>(prm, s);
  return cudaErrorInvalidValue;
}

int counter_stream(uint32_t* bits, float* uniforms, float* normals, int seed, int block,
                   int salt, int rows, int cols, void* stream) {
  const int total = (rows > 0 ? rows : 1) * cols;
  if (cols <= 0 || rows < 0) return cudaErrorInvalidValue;
  counter_stream_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      bits, uniforms, normals, static_cast<uint32_t>(seed), static_cast<uint32_t>(block),
      static_cast<uint32_t>(salt), rows, cols);
  return cudaGetLastError();
}

}  // extern "C"
