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
// A CUDA block owns kNB = 64 chains for the whole sweep, with q in dynamic
// shared memory, so q is read from device memory once and written once. The
// five coefficient sums reduce over D with four threads a chain and a
// shared-memory combine (no atomics, so a launch repeats itself bit for bit);
// then one thread a chain runs the shrink, a loop that stops when its chain
// is done (a done chain's bracket and angles never change again, so this
// gives the unrolled reference's result). Two variants of the product:
//
// tiled (D <= 256), the main path's. What bounds it: the product, D (D + 1)
// FLOP a chain and step over a lower-triangular chol (27 GFLOP a sweep at
// the GP shape, D = 256 x 8,192 chains x 50 steps); as 3xTF32 on the tensor
// cores that is three times the product at 495 TFLOP/s, about 0.16 ms.
// What the design does about it:
//   - chol is cut into tiles of 16 rows (a band, one m16 MMA tile) by 32
//     columns (a slab). At the start each block scans chol once from L2 and
//     marks in shared memory which tiles hold a nonzero; the product skips
//     the others, so any factor is right and a lower-triangular one costs
//     about half. No host read of chol decides anything.
//   - warp w of the 8 compute warps owns bands w and 15 - w, whose k-extents
//     sum to the same for every warp over a triangle (the usual triangular-
//     product pairing), and all 64 chains: 64 sums in registers until the
//     last slab.
//   - a ninth warp only brings chol's tiles in: lane 0 asks the copy engine
//     (TMA, a tensor map of chol with the 128-byte swizzle, so the fragment
//     loads do not conflict on banks, and zeros past D) for each marked tile
//     of a slab, into a two-stage ring, counted on an mbarrier (`full`); the
//     compute warps arrive on another (`empty`) when done with a stage, so
//     no block-wide barrier runs inside the product and a warp with no tile
//     in a slab goes on to the next. Where chol's rows are not 16-byte
//     aligned (D % 4 != 0) the warp copies 4 bytes at a time with cp.async.
//     (Copies issued by the compute warps themselves, and one bulk copy a
//     tile row, were measured slower; PERF.md.) Slabs run last first, so a
//     step starts on the slab with the fewest tiles.
//   - the product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8):
//     each operand is split as hi = tf32(x) (rounded to nearest in integer
//     arithmetic) and lo = x - hi (exact, read as TF32 by the tensor core),
//     and the sum takes lo*hi + hi*lo + hi*hi, small terms first, which keeps
//     FP32-level accuracy (plain TF32 would change the ellipse's covariance
//     by about 1e-3, another sampler). The product is bound by the
//     instructions around the MMAs (the operand splits above all), not by
//     the tensor cores: PERF.md.
//   - nu goes into the ring once the product is done, so z's buffer is free
//     while the shrink runs: the 7 warps that the shrink leaves idle (the
//     copy warp among them) draw the next step's whole z then (D x 64, rows
//     padded to 72 floats for conflict-free B fragments).
//
// generic (256 < D while q and nu fit in shared memory): one pass of the
// tiled product cannot hold more than two bands a warp in registers, so the
// PR 3 design stays for larger D: FP32 FFMA register tiles (8 x 8 a thread)
// in row chunks of 256, 16-deep slabs of chol transposed into shared memory,
// and z regenerated slab by slab (each z element is a pure function of step,
// row and chain).
//
// Random streams (runtime flag `rng`):
//   0 = counter: K2, bit-exact with the reference's interpret-mode stream for
//       the logical chain block block_n (free of the CUDA block): chain n is
//       column n % block_n of block n / block_n, whose base is
//       seed + block * 0x3504F333. Step i has salt s = i (8 + max_iters):
//       z on s and s + 1 (row = dimension), the slice uniform on s + 4 and
//       the angle on s + 5 (row 0), the shrink uniforms on s + 6 (row j).
//   1 = philox: Philox4x32-10 from curand's header, keyed by (seed, chain),
//       counter (s, index, kind); one call gives four normals of z
//       (column_common.cuh's philox_normals4, shared with K1 and K4) or four
//       shrink uniforms; held in law only.
//   3 = threefry, 2 = rbg: the keyed streams, the draws of the reference's
//       XLA path (ess_sweep_gauss_cols) from jax.random.key(seed ^ 0xE5517),
//       threefry2x32 or rbg (column_common.cuh), step i under
//       fold_in(root, first_step + i) split in three: z (D x N, element
//       d N + n of normal(k_nu)), the slice uniform (element n of
//       uniform(k_u)), the first angle (of uniform(k_theta)), and shrink
//       iteration j's uniform from fold_in(k_theta, j + 1). The host passes
//       the root key; each block makes a step's three keys once (one thread,
//       into shared memory, a step ahead in the tiled variant) and a chain's
//       shrink key at each iteration. Kernels of their own
//       (ess_tiled_keyed_kernel, ess_generic_keyed_kernel: the same sweep
//       with KEY = the stream), so the counter and Philox kernels compile as
//       before. A chain past N draws nothing.
//
// No fast-math: a NaN level compares false. The slice's own sincosf and logf
// are the accurate versions (theta reaches +-2 pi) on either stream, and the
// counter stream's Box-Muller keeps the accurate logf/cosf (bit-exact port);
// only the Philox stream's Box-Muller runs on the SFU, through intrinsics.

#include <cstdint>
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime's driver entry point
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include "column_common.cuh"  // K2's counter stream

namespace {

constexpr int kNB = 64;          // chains a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCoefs = 5;        // A, B, C, D, E
constexpr int kParts = kThreads / kNB;  // threads summing one chain's coefficients

enum Variant { kTiled = 0, kGeneric = 1 };

// tiled variant
constexpr int kBand = 16;                        // rows of a tile: one m16 MMA tile
constexpr int kSlab = 32;                        // columns of a tile: a slab is a ring stage
constexpr int kStages = 2;
constexpr int kWarpBands = 2;                    // bands a warp: w and 15 - w
constexpr int kWarpTiles = kNB / 8;              // n8 MMA tiles a warp: all 64 chains
constexpr int kTiledMaxDim = kWarpBands * kWarps * kBand;  // 256
constexpr int kMaxSlabs = kTiledMaxDim / kSlab;
constexpr int kTiledThreads = kThreads + 32;     // the 256 compute threads and one copy warp
constexpr int kTileFloats = kBand * kSlab;       // a tile in the ring, swizzled, no padding
constexpr int kZStride = kNB + 8;                // conflict-free B fragments

// generic variant
constexpr int kRowChunk = 256;   // rows of nu a pass computes
constexpr int kTK = 16;          // depth of a chol / z slab
constexpr int kCholStride = kRowChunk + 4;  // padded, 16-byte aligned rows of the slab

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
  int vec_copy;  // chol rows allow 16-byte copies (D % 4 == 0, chol 16-byte aligned)
};

// The keyed kernels' own argument: fold_in(root, first_step + i) is the key
// of the launch's step i (threefry: root.x, root.y; rbg: all four words).
struct KeyArgs {
  uint4 root;
  uint32_t first_step;
};

// KEY of the kernels whose stream is p.rng (counter or Philox); a keyed
// kernel's KEY is its stream, kThreefry or kRbg.
constexpr int kRuntime = -1;

// A step's keys on a keyed stream: k_nu, k_u, k_theta = split(key, 3).
struct StepKeys {
  uint4 nu, u, theta;
};

template <int KEY>
__device__ __forceinline__ StepKeys step_keys(const KeyArgs& ka, int step) {
  const uint4 k = key_fold<KEY>(ka.root, ka.first_step + static_cast<uint32_t>(step));
  return {key_fold<KEY>(k, 0u), key_fold<KEY>(k, 1u), key_fold<KEY>(k, 2u)};
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr long tiled_smem_floats(int D) {
  static_assert(kStages * kSlab >= kNB, "nu fits in the ring");
  return 1L * kStages * round_up(D, kBand) * kSlab    // chol ring, then nu
         + 1024 / sizeof(float)                         // the ring's alignment
         + 1L * D * kNB                                 // q
         + 1L * round_up(D, kSlab) * kZStride           // z
         + kParts * kCoefs * kNB                        // coefficient partial sums
         + 3L * kNB                                     // cos, sin of the accepted angle, done
         + 3L * D;                                      // prec, mean, r0
}

__host__ __device__ constexpr long generic_smem_floats(int D) {
  return 2L * D * kNB                  // q, nu
         + kTK * kCholStride           // chol slab, transposed
         + kTK * kNB                   // z slab
         + kParts * kCoefs * kNB       // coefficient partial sums
         + 3L * kNB                    // cos, sin of the accepted angle, done
         + 3L * D;                     // prec, mean, r0
}

int variant_for(int D) { return D <= kTiledMaxDim ? kTiled : kGeneric; }

int threads_for(int variant) { return variant == kTiled ? kTiledThreads : kThreads; }

long smem_bytes(int D, int variant) {
  return static_cast<long>(sizeof(float)) *
         (variant == kGeneric ? generic_smem_floats(D) : tiled_smem_floats(D));
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
    const float4 v = philox_normals4(make_uint4(s, k / 4u, 1u, 0u), key);
    z[0] = v.x;
    z[1] = v.y;
    z[2] = v.z;
    z[3] = v.w;
  }

  // the slice uniform (salt s + 4) and the first angle's uniform (s + 5)
  __device__ __forceinline__ void start(uint32_t s, float& u, float& u_theta) const {
    if (rng == kCounter) {
      u = uniform_from_bits(counter_bits(base, s + 4u, 0u, col));
      u_theta = uniform_from_bits(counter_bits(base, s + 5u, 0u, col));
      return;
    }
    const uint4 b = curand_Philox4x32_10(make_uint4(s, 0u, 0u, 0u), key);
    u = philox_u01(b.x);
    u_theta = philox_u01(b.y);
  }

  // the shrink uniform of iteration j (salt s + 6, row j), for j = 0, 1, ...
  // in order: on Philox one call in `cache` serves four iterations
  __device__ __forceinline__ float shrink(uint32_t s, uint32_t j, uint4& cache) const {
    if (rng == kCounter) return uniform_from_bits(counter_bits(base, s + 6u, j, col));
    if (j % 4u == 0u) cache = curand_Philox4x32_10(make_uint4(s, j / 4u, 2u, 0u), key);
    const uint32_t t = j % 4u;
    return philox_u01(t == 0u ? cache.x : t == 1u ? cache.y : t == 2u ? cache.z : cache.w);
  }
};

// ---------------------------------------------------------------- shared steps

// prec, mean, r0 = mean - y and the block's q from device memory
__device__ __forceinline__ void load_block(const EssParams& p, int n0, float* q_s, float* prec_s,
                                           float* mean_s, float* r0_s) {
  for (int d = threadIdx.x; d < p.D; d += kThreads) {
    prec_s[d] = p.prec[d];
    mean_s[d] = p.mean[d];
    r0_s[d] = p.mean[d] - p.y[d];
  }
  for (int e = threadIdx.x; e < p.D * kNB; e += kThreads) {
    const int n = n0 + e % kNB;
    q_s[e] = n < p.N ? p.q_in[static_cast<size_t>(e / kNB) * p.N + n] : 0.0f;
  }
}

__device__ __forceinline__ void store_block(const EssParams& p, int n0, const float* q_s) {
  for (int e = threadIdx.x; e < p.D * kNB; e += kThreads) {
    const int n = n0 + e % kNB;
    if (n < p.N) p.q_out[static_cast<size_t>(e / kNB) * p.N + n] = q_s[e];
  }
}

// this thread's share of the five coefficient sums over D: four threads a
// chain, rows d = part (mod 4), into part_s
__device__ __forceinline__ void coefficient_parts(int D, const float* q_s, const float* nu_s,
                                                  const float* prec_s, const float* mean_s,
                                                  const float* r0_s, float* part_s) {
  const int chain = threadIdx.x % kNB, part = threadIdx.x / kNB;
  float a = 0.0f, b = 0.0f, cc = 0.0f, dc = 0.0f, ec = 0.0f;
#pragma unroll 4
  for (int d = part; d < D; d += kParts) {
    const float pr = prec_s[d], r0 = r0_s[d];
    const float c = q_s[d * kNB + chain] - mean_s[d];
    const float nu = nu_s[d * kNB + chain];
    a += pr * c * c;
    b += pr * nu * nu;
    cc += pr * c * nu;
    dc += pr * c * r0;
    ec += pr * nu * r0;
  }
  float* out = part_s + part * kCoefs * kNB + chain;
  out[0 * kNB] = a;
  out[1 * kNB] = b;
  out[2 * kNB] = cc;
  out[3 * kNB] = dc;
  out[4 * kNB] = ec;
}

// the slice and the shrink of chain `chain` (thread < kNB): cos and sin of
// the accepted angle and whether it accepted. KEY: the stream (kRuntime:
// p.rng's, at salt `salt`; a keyed stream: the step's keys `keys`).
template <int KEY>
__device__ __forceinline__ void shrink_chain(const EssParams& p, int n0, int chain, uint32_t salt,
                                             const StepKeys* keys, const float* part_s, float F,
                                             float* cos_s, float* sin_s, float* done_s) {
  if constexpr (KEY != kRuntime) {
    if (n0 + chain >= p.N) {  // a padding chain draws nothing and keeps its point
      cos_s[chain] = 1.0f;
      sin_s[chain] = 0.0f;
      done_s[chain] = 0.0f;
      return;
    }
  }
  float coef[kCoefs] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < kParts; ++g)
#pragma unroll
    for (int m = 0; m < kCoefs; ++m) coef[m] += part_s[(g * kCoefs + m) * kNB + chain];
  const float A = coef[0], B = coef[1], C = coef[2], Dc = coef[3], E = coef[4];
  auto ll = [&](float theta) {
    float st, ct;
    sincosf(theta, &st, &ct);
    return -0.5f * (A * ct * ct + B * st * st + 2.0f * C * ct * st + 2.0f * Dc * ct +
                    2.0f * E * st + F);
  };
  const Stream stream(p, n0 + chain);
  const uint64_t n = static_cast<uint64_t>(n0 + chain);
  float u, u_theta;
  if constexpr (KEY == kRuntime) {
    stream.start(salt, u, u_theta);
  } else {
    u = rbg_uniform(key_word<KEY>(keys->u, n));
    u_theta = rbg_uniform(key_word<KEY>(keys->theta, n));
  }
  const float log_y = -0.5f * (A + 2.0f * Dc + F) + logf(u);
  const float theta0 = u_theta * kTwoPi;
  float lo = theta0 - kTwoPi, hi = theta0, theta = theta0, theta_acc = theta0;
  bool done = ll(theta0) > log_y;
  uint4 cache = make_uint4(0u, 0u, 0u, 0u);
  for (int j = 0; j < p.max_iters && !done; ++j) {
    if (theta >= 0.0f) {
      hi = theta;
    } else {
      lo = theta;
    }
    float u_j;
    if constexpr (KEY == kRuntime) {
      u_j = stream.shrink(salt, static_cast<uint32_t>(j), cache);
    } else {
      u_j = rbg_uniform(key_word<KEY>(key_fold<KEY>(keys->theta, static_cast<uint32_t>(j) + 1u), n));
    }
    theta = lo + (hi - lo) * u_j;
    if (ll(theta) > log_y) {
      theta_acc = theta;
      done = true;
    }
  }
  float st, ct;
  sincosf(theta_acc, &st, &ct);
  cos_s[chain] = ct;
  sin_s[chain] = st;
  done_s[chain] = done ? 1.0f : 0.0f;
}

__device__ __forceinline__ float block_f(int D, const float* prec_s, const float* r0_s) {
  float f = 0.0f;
  for (int d = 0; d < D; ++d) f += prec_s[d] * r0_s[d] * r0_s[d];
  return f;
}

// ---------------------------------------------------------------- tiled variant

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// this thread's arrival on `bar`, with `bytes` more to come from the copy engine
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0u;
}

// wait until the phase of `bar` with parity `parity` has completed; a wait
// that never ends traps (a launch error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries > (1 << 22)) __trap();
}

// one tile (kBand rows x kSlab columns from (row, col)) of the tensor `map`
// by the copy engine (TMA), counted on `bar`
__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// this thread's arrival on `bar` once its cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Element (r, c) of a 16 x 32 tile in the ring: rows of 128 bytes whose
// 16-byte chunks are XOR-swizzled by r % 8, the copy engine's 128-byte
// swizzle, so that the MMA fragment loads do not conflict on banks.
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * kSlab + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

// Bring the tiles of slab `slab` that `bands` marks (bit b = rows 16b ..
// 16b + 15) into a ring stage, tile b at stage + b * kTileFloats, counted on
// the stage's barrier `full`; called by the copy warp. Where chol's rows are
// 16-byte aligned (D % 4 == 0) lane 0 asks the copy engine for each tile
// (one instruction a tile; it zero-fills rows and columns past D); otherwise
// the lanes copy 4 bytes at a time with cp.async, zero-filling the same.
__device__ __forceinline__ void copy_slab(const EssParams& p, const CUtensorMap* map, float* stage,
                                          uint64_t* full, int slab, uint32_t bands, int lane) {
  const int D = p.D, k0 = slab * kSlab;
  if (p.vec_copy) {
    if (lane == 0) {
      mbar_arrive_expect_tx(full, kTileFloats * 4 * __popc(bands));
      for (uint32_t rest = bands; rest; rest &= rest - 1) {
        const int b = __ffs(rest) - 1;
        tma_tile(stage + b * kTileFloats, map, k0, b * kBand, full);
      }
    }
  } else {
    for (int e = lane; e < round_up(D, kBand) * kSlab; e += 32) {
      const int row = e / kSlab, kk = e % kSlab;
      if (!((bands >> (row / kBand)) & 1u)) continue;
      const bool in = row < D && k0 + kk < D;
      cp_async4(stage + row / kBand * kTileFloats + tile_at(row % kBand, kk),
                in ? p.chol + static_cast<size_t>(row) * D + k0 + kk : p.chol, in ? 4 : 0);
    }
    cp_async_arrive(full);
  }
}

// x = hi + lo: hi the TF32 nearest x (ties away from zero: add half of the
// 13 dropped bits, then drop them), lo = x - hi exactly (|lo| <= 2^-11 |x|),
// which the tensor core reads to TF32 by dropping its low 13 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One band's 16 x 64 tile of nu += (its tile's columns kk .. kk + 7) @ (z
// rows k0 + kk .. + 7), in 3xTF32. Fragments of m16n8k8 (g = lane / 4,
// t = lane % 4): A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (t, g),
// (t + 4, g); C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void band_mma(float (&acc)[kWarpTiles][4], const float* tile, int kk,
                                         const uint32_t (&b_hi)[kWarpTiles][2],
                                         const uint32_t (&b_lo)[kWarpTiles][2]) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  uint32_t a_hi[4], a_lo[4];
  split_tf32(tile[tile_at(g, kk + t)], a_hi[0], a_lo[0]);
  split_tf32(tile[tile_at(g + 8, kk + t)], a_hi[1], a_lo[1]);
  split_tf32(tile[tile_at(g, kk + t + 4)], a_hi[2], a_lo[2]);
  split_tf32(tile[tile_at(g + 8, kk + t + 4)], a_hi[3], a_lo[3]);
#pragma unroll
  for (int nt = 0; nt < kWarpTiles; ++nt) {
    mma_tf32(acc[nt], a_lo, b_hi[nt][0], b_hi[nt][1]);
    mma_tf32(acc[nt], a_hi, b_lo[nt][0], b_lo[nt][1]);
    mma_tf32(acc[nt], a_hi, b_hi[nt][0], b_hi[nt][1]);
  }
}

// z of the step with salt `salt` (D x kNB, rows padded to kZStride) into
// z_s, by threads first, first + stride, ...: each takes four rows of one
// chain at a time, one Philox call
__device__ __forceinline__ void draw_z(const EssParams& p, int n0, float* z_s, uint32_t salt, int first,
                                       int stride) {
  for (int e = first; e < round_up(p.D, 4) / 4 * kNB; e += stride) {
    const int r = 4 * (e / kNB), c = e % kNB;
    float z4[4];
    Stream(p, n0 + c).normals4(salt, static_cast<uint32_t>(r), z4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r + i < p.D) z_s[(r + i) * kZStride + c] = z4[i];
  }
}

// z of a step on keyed stream KEY (its key k_nu) into z_s, as draw_z: element
// (d, n) is normal(k_nu)'s element d N + n; a chain past N draws nothing. The
// rbg stream with N % 4 == 0 takes one Philox call a row of four chains
// (its four words are the four elements), threefry one hash an element.
template <int KEY>
__device__ __forceinline__ void draw_z_keyed(const EssParams& p, int n0, float* z_s, uint4 k_nu, int first,
                                             int stride) {
  const uint64_t N = static_cast<uint64_t>(p.N);
  if (KEY == kRbg && p.N % 4 == 0) {
    for (int e = first; e < p.D * (kNB / 4); e += stride) {
      const int r = e / (kNB / 4), c = 4 * (e % (kNB / 4));
      if (n0 + c >= p.N) {
#pragma unroll
        for (int t = 0; t < 4; ++t) z_s[r * kZStride + c + t] = 0.0f;
        continue;
      }
      const uint4 w = rbg_block(k_nu, (r * N + static_cast<uint64_t>(n0 + c)) >> 2);
#pragma unroll
      for (int t = 0; t < 4; ++t) z_s[r * kZStride + c + t] = rbg_normal(word_of(w, static_cast<uint32_t>(t)));
    }
    return;
  }
#pragma unroll 2
  for (int e = first; e < p.D * kNB; e += stride) {
    const int r = e / kNB, c = e % kNB;
    const uint64_t n = static_cast<uint64_t>(n0 + c);
    z_s[r * kZStride + c] = n < N ? rbg_normal(key_word<KEY>(k_nu, r * N + n)) : 0.0f;
  }
}

// The tiled variant's sweep; KEY: kRuntime (p.rng's stream) or a keyed
// stream, whose step keys live in key_slots[step % 2] (two slots of the
// keyed kernel's shared memory: a step's are made while the step before it
// runs).
template <int KEY>
__device__ __forceinline__ void ess_tiled(const EssParams& p, const CUtensorMap& chol_map, const KeyArgs& ka,
                                          StepKeys* key_slots) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t tile_mask[kMaxSlabs];  // bit b of slab s: tile (band b, slab s) holds a nonzero
  __shared__ int slabs[kMaxSlabs];           // the slabs with a nonzero tile, last first
  __shared__ int n_slabs;
  __shared__ float f_coef;
  __shared__ uint64_t full[kStages];         // a ring stage's slab has landed
  __shared__ uint64_t empty[kStages];        // the compute warps are done with a ring stage
  const int D = p.D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool copier = warp == kWarps;  // the copy warp: it only asks for chol's tiles
  const int d_pad = round_up(D, kSlab), stage_floats = round_up(D, kBand) / kBand * kTileFloats;
  // the ring first, aligned to the copy engine's 1024-byte swizzle atom; it
  // holds nu ([D][kNB]) between the product and the update
  float* ring = smem + (1024u - smem_u32(smem) % 1024u) % 1024u / sizeof(float);
  float* nu_s = ring;
  float* q_s = ring + kStages * stage_floats;     // [D][kNB]
  float* z_s = q_s + D * kNB;                     // [d_pad][kZStride]
  float* part_s = z_s + d_pad * kZStride;         // [kParts][kCoefs][kNB]
  float* cos_s = part_s + kParts * kCoefs * kNB;
  float* sin_s = cos_s + kNB;
  float* done_s = sin_s + kNB;
  float* prec_s = done_s + kNB;
  float* mean_s = prec_s + D;
  float* r0_s = mean_s + D;

  const int n0 = blockIdx.x * kNB;
  if (tid < kMaxSlabs) tile_mask[tid] = 0u;
  if (tid < kStages) {
    mbar_init(&full[tid], p.vec_copy ? 1u : 32u);
    mbar_init(&empty[tid], kWarps);
  }
  if (!copier) {
    load_block(p, n0, q_s, prec_s, mean_s, r0_s);
    for (int e = D * kZStride + tid; e < d_pad * kZStride; e += kThreads) z_s[e] = 0.0f;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // ---- which tiles of chol hold a nonzero (NaN counts as nonzero)
  if (!copier) {
    static_assert(kSlab == 32, "a warp reads one slab's columns of a row");
    uint32_t bits[kMaxSlabs] = {};
    for (int row = warp; row < D; row += kWarps) {
#pragma unroll
      for (int s = 0; s < kMaxSlabs; ++s) {
        const int col = s * kSlab + lane;
        if (col < D && p.chol[row * D + col] != 0.0f) bits[s] |= 1u << (row / kBand);
      }
    }
#pragma unroll
    for (int s = 0; s < kMaxSlabs; ++s) {
      bits[s] = __reduce_or_sync(0xffffffffu, bits[s]);
      if (lane == 0 && bits[s]) atomicOr(&tile_mask[s], bits[s]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    // last slab first: over a lower triangle it has the fewest tiles, and it
    // is the one each step waits for
    int m = 0;
    for (int s = d_pad / kSlab - 1; s >= 0; --s)
      if (tile_mask[s]) slabs[m++] = s;
    n_slabs = m;
    f_coef = block_f(D, prec_s, r0_s);
    if constexpr (KEY != kRuntime) key_slots[0] = step_keys<KEY>(ka, 0);
  }
  __syncthreads();

  // this warp's bands: w and 15 - w
  const int bands[kWarpBands] = {warp, 2 * kWarps - 1 - warp};
  const int g = lane / 4, t = lane % 4;
  // the update: this thread's chain and rows
  const int chain = tid % kNB, group0 = tid / kNB;
  const uint32_t salt_step = static_cast<uint32_t>(8 + p.max_iters);
  if (!copier && p.n_steps > 0) {
    if constexpr (KEY == kRuntime) {
      draw_z(p, n0, z_s, 0u, tid, kThreads);
    } else {
      draw_z_keyed<KEY>(p, n0, z_s, key_slots[0].nu, tid, kThreads);
    }
  }

  for (int step = 0; step < p.n_steps; ++step) {
    const uint32_t salt = static_cast<uint32_t>(step) * salt_step;
    const bool next = step + 1 < p.n_steps;

    // ---- nu = chol @ z over the marked tiles
    float acc[kWarpBands][kWarpTiles][4];
#pragma unroll
    for (int j = 0; j < kWarpBands; ++j)
#pragma unroll
      for (int nt = 0; nt < kWarpTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.0f;

    // slab i of this step is the launch's slab c = step * n_slabs + i, in
    // stage c % 2 for the (c / 2)-th time: `full` completes a phase when it
    // has landed, `empty` when the 8 compute warps are done with it
    const int c0 = step * n_slabs;
    __syncthreads();  // the update is done with nu, so the ring is free
    if (copier) {
      for (int i = 0; i < n_slabs; ++i) {
        const int c = c0 + i, stage = c % kStages;
        if (i >= kStages) mbar_wait(&empty[stage], (c / kStages - 1) & 1);
        copy_slab(p, &chol_map, ring + stage * stage_floats, &full[stage], slabs[i], tile_mask[slabs[i]],
                  lane);
      }
      // the next step's keys, while the compute warps run the product
      if constexpr (KEY != kRuntime) {
        if (lane == 1 && next) key_slots[(step + 1) % 2] = step_keys<KEY>(ka, step + 1);
      }
    } else {
      for (int i = 0; i < n_slabs; ++i) {
        const int c = c0 + i, stage = c % kStages;
        const float* tiles = ring + stage * stage_floats;
        const int k0 = slabs[i] * kSlab;
        uint32_t mine = 0u;  // bit j: this warp's band j has a tile in the slab
#pragma unroll
        for (int j = 0; j < kWarpBands; ++j) mine |= ((tile_mask[slabs[i]] >> bands[j]) & 1u) << j;
        mbar_wait(&full[stage], (c / kStages) & 1);
        if (mine) {
#pragma unroll
          for (int kk = 0; kk < kSlab; kk += 8) {
            uint32_t b_hi[kWarpTiles][2], b_lo[kWarpTiles][2];
            const float* zr = z_s + (k0 + kk + t) * kZStride + g;
#pragma unroll
            for (int nt = 0; nt < kWarpTiles; ++nt) {
              split_tf32(zr[nt * 8], b_hi[nt][0], b_lo[nt][0]);
              split_tf32(zr[4 * kZStride + nt * 8], b_hi[nt][1], b_lo[nt][1]);
            }
#pragma unroll
            for (int j = 0; j < kWarpBands; ++j)
              if ((mine >> j) & 1u) band_mma(acc[j], tiles + bands[j] * kTileFloats, kk, b_hi, b_lo);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
      }
    }
    __syncthreads();  // every warp is done with z and with the ring
    if (!copier) {
#pragma unroll
      for (int j = 0; j < kWarpBands; ++j) {
        const int row = bands[j] * kBand + g;
#pragma unroll
        for (int nt = 0; nt < kWarpTiles; ++nt) {
          const int col = nt * 8 + 2 * t;
          if (row < D)
            *reinterpret_cast<float2*>(&nu_s[row * kNB + col]) = make_float2(acc[j][nt][0], acc[j][nt][1]);
          if (row + 8 < D)
            *reinterpret_cast<float2*>(&nu_s[(row + 8) * kNB + col]) =
                make_float2(acc[j][nt][2], acc[j][nt][3]);
        }
      }
    }
    __syncthreads();

    // ---- the coefficient sums, then the shrink: one thread a chain
    if (!copier) coefficient_parts(D, q_s, nu_s, prec_s, mean_s, r0_s, part_s);
    __syncthreads();
    if (tid < kNB) {
      shrink_chain<KEY>(p, n0, tid, salt, key_slots + step % 2, part_s, f_coef, cos_s, sin_s, done_s);
    } else if (next) {
      // meanwhile the other warps, the copy warp too, draw the next step's z
      // (z is free: nu is in the ring)
      if constexpr (KEY == kRuntime) {
        draw_z(p, n0, z_s, salt + salt_step, tid - kNB, kTiledThreads - kNB);
      } else {
        draw_z_keyed<KEY>(p, n0, z_s, key_slots[(step + 1) % 2].nu, tid - kNB, kTiledThreads - kNB);
      }
    }
    __syncthreads();

    // ---- q <- mean + c cos + nu sin where the chain accepted
    if (!copier && done_s[chain] != 0.0f) {
      const float ct = cos_s[chain], st = sin_s[chain];
      for (int d = group0; d < D; d += kParts) {
        const float m = mean_s[d];
        float* q = &q_s[d * kNB + chain];
        *q = m + (*q - m) * ct + nu_s[d * kNB + chain] * st;
      }
    }
    // nu's writes to the ring, before the copy engine's next ones
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (!copier) store_block(p, n0, q_s);
}

__global__ void __launch_bounds__(kTiledThreads, 1)
    ess_tiled_kernel(const EssParams p, const __grid_constant__ CUtensorMap chol_map) {
  ess_tiled<kRuntime>(p, chol_map, KeyArgs{}, nullptr);
}

template <int KEY>
__global__ void __launch_bounds__(kTiledThreads, 1)
    ess_tiled_keyed_kernel(const EssParams p, const __grid_constant__ CUtensorMap chol_map,
                           const KeyArgs ka) {
  __shared__ StepKeys key_slots[2];
  ess_tiled<KEY>(p, chol_map, ka, key_slots);
}

// ---------------------------------------------------------------- generic variant

// The generic variant's sweep; KEY as ess_tiled's, the step's keys in
// key_slots[0], made at the step's start.
template <int KEY>
__device__ __forceinline__ void ess_generic(const EssParams& p, const KeyArgs& ka, StepKeys* key_slots) {
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
  load_block(p, n0, q_s, prec_s, mean_s, r0_s);
  __syncthreads();
  if (tid == 0) f_coef = block_f(D, prec_s, r0_s);

  // the z slab: this thread's chain and its four rows of each slab
  const int z_chain = tid % kNB;
  const int z_rows = 4 * (tid / kNB);
  const Stream z_stream(p, n0 + z_chain);
  // the product: this thread's register tile
  const int tx = tid % 8;
  const int ty = tid / 8;

  for (int step = 0; step < p.n_steps; ++step) {
    const uint32_t salt = static_cast<uint32_t>(step) * static_cast<uint32_t>(8 + p.max_iters);
    if constexpr (KEY != kRuntime) {
      if (tid == 0) key_slots[0] = step_keys<KEY>(ka, step);
      __syncthreads();
    }

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
        if constexpr (KEY == kRuntime) {
          z_stream.normals4(salt, static_cast<uint32_t>(k0 + z_rows), z4);
        } else {
          const uint64_t n = static_cast<uint64_t>(n0 + z_chain);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int row = k0 + z_rows + t;
            z4[t] = row < D && n < static_cast<uint64_t>(p.N)
                        ? rbg_normal(key_word<KEY>(key_slots[0].nu, row * static_cast<uint64_t>(p.N) + n))
                        : 0.0f;
          }
        }
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

    coefficient_parts(D, q_s, nu_s, prec_s, mean_s, r0_s, part_s);
    __syncthreads();
    if (tid < kNB) shrink_chain<KEY>(p, n0, tid, salt, key_slots, part_s, f_coef, cos_s, sin_s, done_s);
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
  store_block(p, n0, q_s);
}

__global__ void __launch_bounds__(kThreads, 1) ess_generic_kernel(const EssParams p) {
  ess_generic<kRuntime>(p, KeyArgs{}, nullptr);
}

template <int KEY>
__global__ void __launch_bounds__(kThreads, 1) ess_generic_keyed_kernel(const EssParams p, const KeyArgs ka) {
  __shared__ StepKeys key_slots[1];
  ess_generic<KEY>(p, ka, key_slots);
}

bool keyed(int rng) { return rng == kThreefry || rng == kRbg; }

// the kernel of `variant` on stream `rng`
const void* kernel_for(int variant, int rng) {
  if (rng == kThreefry)
    return variant == kTiled ? reinterpret_cast<const void*>(ess_tiled_keyed_kernel<kThreefry>)
                             : reinterpret_cast<const void*>(ess_generic_keyed_kernel<kThreefry>);
  if (rng == kRbg)
    return variant == kTiled ? reinterpret_cast<const void*>(ess_tiled_keyed_kernel<kRbg>)
                             : reinterpret_cast<const void*>(ess_generic_keyed_kernel<kRbg>);
  return variant == kTiled ? reinterpret_cast<const void*>(ess_tiled_kernel)
                           : reinterpret_cast<const void*>(ess_generic_kernel);
}

// chol (dim x dim, row-major, 16-byte aligned rows) as a tensor of the copy
// engine: 16 x 32 tiles, the 128-byte swizzle, zeros past the edges. The
// encoder is the driver's cuTensorMapEncodeTiled, found through the runtime.
bool encode_chol_map(CUtensorMap* map, const float* chol, int dim) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(dim)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dim) * sizeof(float)};
  const cuuint32_t box[2] = {kSlab, kBand};
  const cuuint32_t element_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(chol), dims, strides, box,
                element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// K3's geometry at dimension `dim`: out[0] the variant (0 tiled, 1 generic),
// out[1] the dynamic shared memory of a block in bytes, out[2] the tiles of
// chol the tiled variant marks (bands of 16 rows x slabs of 32 columns; 0 in
// the generic variant, which skips nothing), out[3] the threads of a block.
void ess_gauss_geometry(int dim, long* out) {
  const int variant = variant_for(dim);
  out[0] = variant;
  out[1] = smem_bytes(dim, variant);
  out[2] = variant == kTiled ? 1L * (round_up(dim, kBand) / kBand) * (round_up(dim, kSlab) / kSlab) : 0L;
  out[3] = threads_for(variant);
}

// The largest dynamic shared memory a block may opt in to on `device`, or -1.
int ess_gauss_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// The CUDA runtime's view of K3 at dimension `dim` on stream `rng` (the keyed
// kernel for kThreefry and kRbg): out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] resident blocks an SM.
int ess_gauss_kernel_info(int dim, int rng, int* out) {
  const int variant = variant_for(dim);
  const void* fn = kernel_for(variant, rng);
  const size_t smem = static_cast<size_t>(smem_bytes(dim, variant));
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, threads_for(variant), smem);
}

// rng is kCounter, kPhilox, kThreefry or kRbg; a keyed stream takes `root`,
// the sweep's root key (four words, a threefry key's two in the first two),
// and `first_step`, the index of the launch's first step. Returns the
// cudaError_t of the launch (0 on success).
int ess_gauss_sweep(const float* q_in, float* q_out, const float* chol, const float* y,
                    const float* prec, const float* mean, int dim, int N, int n_steps,
                    int max_iters, int seed, int rng, int block_n, const uint32_t* root,
                    int first_step, void* stream) {
  if (dim <= 0 || N <= 0 || n_steps < 0 || max_iters < 0 || block_n <= 0 ||
      (rng != kCounter && rng != kPhilox && !keyed(rng)) || (keyed(rng) && root == nullptr))
    return cudaErrorInvalidValue;
  const int variant = variant_for(dim);
  const int vec_copy = dim % 4 == 0 && reinterpret_cast<uintptr_t>(chol) % 16 == 0;
  const EssParams prm{q_in, q_out, chol, y, prec, mean, dim, N, n_steps, max_iters,
                      static_cast<uint32_t>(seed), rng, block_n, vec_copy};
  CUtensorMap chol_map{};
  if (variant != kGeneric && vec_copy && !encode_chol_map(&chol_map, chol, dim))
    return cudaErrorInvalidValue;
  const void* fn = kernel_for(variant, rng);
  const size_t smem = static_cast<size_t>(smem_bytes(dim, variant));
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (N + kNB - 1) / kNB;
  KeyArgs ka{};
  if (keyed(rng)) ka = {make_uint4(root[0], root[1], root[2], root[3]), static_cast<uint32_t>(first_step)};
  void* tiled_args[] = {const_cast<EssParams*>(&prm), &chol_map, &ka};
  void* generic_keyed_args[] = {const_cast<EssParams*>(&prm), &ka};
  void** args = variant == kGeneric && keyed(rng) ? generic_keyed_args : tiled_args;
  return cudaLaunchKernel(fn, dim3(blocks), dim3(threads_for(variant)), args, smem,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
