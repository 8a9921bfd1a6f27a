// Gaussian-likelihood elliptical slice sampling sweep for Hopper (sm_90a): K3.
//
// Replaces genjax_tpu/kernels/elliptical.py::_ess_gauss_kernel, the Pallas
// TPU kernel that keeps a chain block's ellipse draws, their product with
// the prior factor and the shrink loop on chip for a whole sweep.
//
// What it computes: n_steps elliptical-slice transitions on each of N chains
// (columns of q, D x N) with prior N(mean, chol chol') and the Gaussian
// likelihood -1/2 sum_d prec_d (f_d - y_d)^2. Each step draws z ~ N(0, I)
// (D x chains), forms nu = chol @ z, and per chain the trig-quadratic
// coefficients A = sum prec c^2, B = sum prec nu^2, C = sum prec c nu,
// D = sum prec c r0, E = sum prec nu r0 (c = q - mean, r0 = mean - y) and
// F = sum prec r0^2, so that ll(theta) = -1/2 (A cos^2 + B sin^2 +
// 2C cos sin + 2D cos + 2E sin + F). The slice level is ll(0) + log u, the
// first angle 2 pi u', and the bracket [theta0 - 2 pi, theta0] shrinks
// toward 0 on the rejected side with the uniform of row j at iteration j,
// up to max_iters; then q <- mean + c cos(theta) + nu sin(theta) where a
// chain accepted, else q.
//
// Design: a CUDA block owns kNB = 64 chains for the whole sweep, with q and
// nu in dynamic shared memory, so q is read from device memory once and
// written once. The product nu = chol @ z is an FP32 FFMA product written
// here: the block computes nu's D x 64 tile in row chunks of 256, each
// thread an 8 x 8 register tile (rows ty*4 + {0..3} and 128 + ty*4 + {0..3},
// chains tx*4 + {0..3} and 32 + tx*4 + {0..3}); the k-loop streams a 16-wide
// slab of chol from L2 into shared memory and generates the matching 16 rows
// of z from the stream into shared memory, so no D x 64 z buffer exists. Each
// z element is a pure function of (step, row, chain), so a second row chunk
// (D > 256) regenerates the same z. The five coefficient sums reduce over D
// with four threads a chain and a shared-memory combine; then one thread a
// chain runs the shrink. Chains are independent, so the shrink is a
// per-thread loop that stops when its chain is done: a done chain's bracket,
// angle and accepted angle never change again, so this gives the unrolled
// reference's result.
//
// Bound on this card: the product is 2 D^2 FLOP per chain and step (1.07
// GFLOP per transition of 8,192 chains at D = 256), all FP32 FFMA, read from
// shared memory; 8,192 chains make 128 blocks of 256 threads, one block per
// SM (q and nu take 128 KiB at D = 256), so the FFMA pipes and the shared-
// memory bandwidth of the inner loop bound it. Tensor cores (TF32 wgmma),
// TMA for the chol slabs and the tuning of kNB are later work.
//
// Random streams (runtime flag `rng`):
//   0 = counter: K2, bit-exact with the reference's interpret-mode stream for
//       the logical chain block block_n (free of the CUDA block): chain n is
//       column n % block_n of block n / block_n, whose base is
//       seed + block * 0x3504F333. Step i has salt s = i (8 + max_iters):
//       z on s and s + 1 (row = dimension), the slice uniform on s + 4 and
//       the angle on s + 5 (row 0), the shrink uniforms on s + 6 (row j).
//   1 = philox: Philox4x32-10 from curand's header, keyed by (seed, chain),
//       counter (s, index, kind); held in law only.
//
// No fast-math: cosf, sinf and logf are the accurate versions (theta reaches
// +-2 pi), and a NaN level compares false.

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include "column_common.cuh"  // K2's counter stream

namespace {

constexpr int kNB = 64;          // chains a block
constexpr int kThreads = 256;    // 8 column groups x 32 row groups
constexpr int kRowChunk = 256;   // rows of nu a pass computes
constexpr int kTK = 16;          // depth of a chol / z slab
constexpr int kCholStride = kRowChunk + 4;  // padded, 16-byte aligned rows of the slab
constexpr int kCoefs = 5;        // A, B, C, D, E
constexpr int kParts = kThreads / kNB;  // threads summing one chain's coefficients

struct EssParams {
  const float* q_in;   // (D, N)
  float* q_out;        // (D, N)
  const float* chol;   // (D, D), row-major
  const float* y;      // (D,)
  const float* prec;   // (D,)
  const float* mean;   // (D,)
  int D;
  int N;
  int n_steps;
  int max_iters;
  uint32_t seed;
  int rng;
  int block_n;
};

// Floats of dynamic shared memory a block takes at dimension D.
__host__ __device__ constexpr long smem_floats(int D) {
  return 2L * D * kNB                  // q, nu
         + kTK * kCholStride           // chol slab, transposed
         + kTK * kNB                   // z slab
         + kParts * kCoefs * kNB       // coefficient partial sums
         + 3L * kNB                    // cos, sin of the accepted angle, done
         + 3L * D;                     // prec, mean, r0
}

struct Stream {
  int rng;
  uint32_t base;  // counter: seed + block * kBlockMix
  uint32_t col;   // counter: the chain's column in its block
  uint2 key;      // philox: (seed, chain)

  __device__ Stream(const EssParams& p, int n)
      : rng(p.rng),
        base(p.seed + static_cast<uint32_t>(n / p.block_n) * kBlockMix),
        col(static_cast<uint32_t>(n % p.block_n)),
        key(make_uint2(p.seed, static_cast<uint32_t>(n))) {}

  // z rows k .. k + 3 (k a multiple of 4) of the step with salt s
  __device__ __forceinline__ void normals4(uint32_t s, uint32_t k, float (&z)[4]) const {
    if (rng == kCounter) {
#pragma unroll
      for (int t = 0; t < 4; ++t) z[t] = counter_normal(base, s, k + t, col);
      return;
    }
    const uint4 b = curand_Philox4x32_10(make_uint4(s, k / 4u, 1u, 0u), key);
    float s0, c0, s1, c1;
    sincosf(kTwoPi * uniform_from_bits(b.y), &s0, &c0);
    sincosf(kTwoPi * uniform_from_bits(b.w), &s1, &c1);
    const float r0 = sqrtf(-2.0f * logf(uniform_from_bits(b.x)));
    const float r1 = sqrtf(-2.0f * logf(uniform_from_bits(b.z)));
    z[0] = r0 * c0;
    z[1] = r0 * s0;
    z[2] = r1 * c1;
    z[3] = r1 * s1;
  }

  // the slice uniform (salt s + 4) and the first angle's uniform (s + 5)
  __device__ __forceinline__ void start(uint32_t s, float& u, float& u_theta) const {
    if (rng == kCounter) {
      u = uniform_from_bits(counter_bits(base, s + 4u, 0u, col));
      u_theta = uniform_from_bits(counter_bits(base, s + 5u, 0u, col));
      return;
    }
    const uint4 b = curand_Philox4x32_10(make_uint4(s, 0u, 0u, 0u), key);
    u = uniform_from_bits(b.x);
    u_theta = uniform_from_bits(b.y);
  }

  // the shrink uniform of iteration j (salt s + 6, row j)
  __device__ __forceinline__ float shrink(uint32_t s, uint32_t j) const {
    if (rng == kCounter) return uniform_from_bits(counter_bits(base, s + 6u, j, col));
    const uint4 b = curand_Philox4x32_10(make_uint4(s, j / 4u, 2u, 0u), key);
    const uint32_t t = j % 4u;
    return uniform_from_bits(t == 0u ? b.x : t == 1u ? b.y : t == 2u ? b.z : b.w);
  }
};

__global__ void __launch_bounds__(kThreads, 1) ess_gauss_sweep_kernel(const EssParams p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int tid = threadIdx.x;
  float* q_s = smem;                          // [D][kNB]
  float* nu_s = q_s + D * kNB;                // [D][kNB]
  float* chol_s = nu_s + D * kNB;             // [kTK][kCholStride]
  float* z_s = chol_s + kTK * kCholStride;    // [kTK][kNB]
  float* part_s = z_s + kTK * kNB;            // [kParts][kCoefs][kNB]
  float* cos_s = part_s + kParts * kCoefs * kNB;
  float* sin_s = cos_s + kNB;
  float* done_s = sin_s + kNB;
  float* prec_s = done_s + kNB;
  float* mean_s = prec_s + D;
  float* r0_s = mean_s + D;
  __shared__ float f_coef;

  const int n0 = blockIdx.x * kNB;
  for (int d = tid; d < D; d += kThreads) {
    prec_s[d] = p.prec[d];
    mean_s[d] = p.mean[d];
    r0_s[d] = p.mean[d] - p.y[d];
  }
  for (int e = tid; e < D * kNB; e += kThreads) {
    const int n = n0 + e % kNB;
    q_s[e] = n < p.N ? p.q_in[static_cast<size_t>(e / kNB) * p.N + n] : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    float f = 0.0f;
    for (int d = 0; d < D; ++d) f += prec_s[d] * r0_s[d] * r0_s[d];
    f_coef = f;
  }

  // the z slab: this thread's chain and its four rows of each slab
  const int z_chain = tid % kNB;
  const int z_rows = 4 * (tid / kNB);
  const Stream z_stream(p, n0 + z_chain);
  // the product: this thread's register tile
  const int tx = tid % 8;
  const int ty = tid / 8;
  // the coefficient sums: this thread's chain and row residue
  const int c_chain = tid % kNB;
  const int c_part = tid / kNB;

  for (int step = 0; step < p.n_steps; ++step) {
    const uint32_t salt = static_cast<uint32_t>(step) * static_cast<uint32_t>(8 + p.max_iters);

    // ---- nu = chol @ z
    for (int i0 = 0; i0 < D; i0 += kRowChunk) {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

      for (int k0 = 0; k0 < D; k0 += kTK) {
        // the chol slab, transposed: chol_s[kk][ii] = chol[i0 + ii][k0 + kk]
        for (int e = tid; e < kTK * kRowChunk; e += kThreads) {
          const int kk = e % kTK, ii = e / kTK;
          const int row = i0 + ii, k = k0 + kk;
          chol_s[kk * kCholStride + ii] =
              (row < D && k < D) ? p.chol[static_cast<size_t>(row) * D + k] : 0.0f;
        }
        float z4[4];
        z_stream.normals4(salt, static_cast<uint32_t>(k0 + z_rows), z4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          z_s[(z_rows + t) * kNB + z_chain] = (k0 + z_rows + t < D) ? z4[t] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&chol_s[kk * kCholStride + ty * 4]);
          const float4 a1 = *reinterpret_cast<const float4*>(&chol_s[kk * kCholStride + 128 + ty * 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&z_s[kk * kNB + tx * 4]);
          const float4 b1 = *reinterpret_cast<const float4*>(&z_s[kk * kNB + 32 + tx * 4]);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = i0 + (r < 4 ? ty * 4 + r : 128 + ty * 4 + r - 4);
        if (row < D) {
          *reinterpret_cast<float4*>(&nu_s[row * kNB + tx * 4]) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          *reinterpret_cast<float4*>(&nu_s[row * kNB + 32 + tx * 4]) =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      }
    }
    __syncthreads();

    // ---- the coefficient sums over D: four threads a chain, then a combine
    {
      float a = 0.0f, b = 0.0f, cc = 0.0f, dc = 0.0f, ec = 0.0f;
      for (int d = c_part; d < D; d += kParts) {
        const float pr = prec_s[d], r0 = r0_s[d];
        const float c = q_s[d * kNB + c_chain] - mean_s[d];
        const float nu = nu_s[d * kNB + c_chain];
        a += pr * c * c;
        b += pr * nu * nu;
        cc += pr * c * nu;
        dc += pr * c * r0;
        ec += pr * nu * r0;
      }
      float* part = part_s + c_part * kCoefs * kNB + c_chain;
      part[0 * kNB] = a;
      part[1 * kNB] = b;
      part[2 * kNB] = cc;
      part[3 * kNB] = dc;
      part[4 * kNB] = ec;
    }
    __syncthreads();

    // ---- the shrink: one thread a chain
    if (tid < kNB) {
      float coef[kCoefs] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int g = 0; g < kParts; ++g)
#pragma unroll
        for (int m = 0; m < kCoefs; ++m) coef[m] += part_s[(g * kCoefs + m) * kNB + tid];
      const float A = coef[0], B = coef[1], C = coef[2], Dc = coef[3], E = coef[4];
      const float F = f_coef;
      auto ll = [&](float theta) {
        const float ct = cosf(theta), st = sinf(theta);
        return -0.5f * (A * ct * ct + B * st * st + 2.0f * C * ct * st + 2.0f * Dc * ct +
                        2.0f * E * st + F);
      };
      const Stream stream(p, n0 + tid);
      float u, u_theta;
      stream.start(salt, u, u_theta);
      const float log_y = -0.5f * (A + 2.0f * Dc + F) + logf(u);
      const float theta0 = u_theta * kTwoPi;
      float lo = theta0 - kTwoPi, hi = theta0, theta = theta0, theta_acc = theta0;
      bool done = ll(theta0) > log_y;
      for (int j = 0; j < p.max_iters && !done; ++j) {
        if (theta >= 0.0f) {
          hi = theta;
        } else {
          lo = theta;
        }
        theta = lo + (hi - lo) * stream.shrink(salt, static_cast<uint32_t>(j));
        if (ll(theta) > log_y) {
          theta_acc = theta;
          done = true;
        }
      }
      cos_s[tid] = cosf(theta_acc);
      sin_s[tid] = sinf(theta_acc);
      done_s[tid] = done ? 1.0f : 0.0f;
    }
    __syncthreads();

    // ---- q <- mean + c cos + nu sin where the chain accepted
    for (int e = tid; e < D * kNB; e += kThreads) {
      const int j = e % kNB;
      if (done_s[j] != 0.0f) {
        const float m = mean_s[e / kNB];
        q_s[e] = m + (q_s[e] - m) * cos_s[j] + nu_s[e] * sin_s[j];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < D * kNB; e += kThreads) {
    const int n = n0 + e % kNB;
    if (n < p.N) p.q_out[static_cast<size_t>(e / kNB) * p.N + n] = q_s[e];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a K3 block takes at dimension `dim`.
long ess_gauss_smem_bytes(int dim) { return static_cast<long>(sizeof(float)) * smem_floats(dim); }

// The largest dynamic shared memory a block may opt in to on `device`, or -1.
int ess_gauss_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// Returns the cudaError_t of the launch (0 on success).
int ess_gauss_sweep(const float* q_in, float* q_out, const float* chol, const float* y,
                    const float* prec, const float* mean, int dim, int N, int n_steps,
                    int max_iters, int seed, int rng, int block_n, void* stream) {
  if (dim <= 0 || N <= 0 || n_steps < 0 || max_iters < 0 || block_n <= 0 ||
      (rng != kCounter && rng != kPhilox))
    return cudaErrorInvalidValue;
  const EssParams prm{q_in, q_out, chol, y, prec, mean, dim, N, n_steps, max_iters,
                      static_cast<uint32_t>(seed), rng, block_n};
  const size_t smem = static_cast<size_t>(ess_gauss_smem_bytes(dim));
  const cudaError_t err = cudaFuncSetAttribute(
      ess_gauss_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (N + kNB - 1) / kNB;
  ess_gauss_sweep_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return cudaGetLastError();
}

}  // extern "C"
