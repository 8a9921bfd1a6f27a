// Device code shared by the column-layout sweep kernels: the HMC sweep (K1,
// hmc_sweep.cu), the NUTS sweep (K4, nuts_sweep.cu) and the Gaussian
// elliptical-slice sweep (K3, ess_gauss_sweep.cu).
//
// - K2, the counter stream: the bit-exact port of the reference's in-kernel
//   software PRNG (genjax_tpu/kernels/hmc.py: _sw_rand_bits_factory,
//   _uniform_01, _normal); all three kernels use it;
// - K2, the Philox stream that takes the place of the reference's hardware
//   bits (_hw_rand_bits): K1, K4, K3 and k2_stream.cu draw through
//   philox_normals4 and philox_u01 (K1's accept uniforms and K4's
//   directions, leaves and subtree uniforms four a call, PhiloxUniforms);
// - K2, the rbg stream: the draws of the reference's XLA twins from
//   jax.random.key(seed, impl="rbg") as JAX's CPU backend makes them
//   (rbg_word, rbg_uniform, rbg_normal): K1's and K4's rbg kernels draw
//   them from a table of the sweep's keys the host makes;
// - K2, the threefry stream: jax.random.key(seed)'s own hash (threefry2x32,
//   threefry_word) and the keys' splits and fold-ins (key_fold): K3's keyed
//   kernels draw the reference's XLA path on it, and on the rbg stream;
// - the device bodies: a column log-density and its gradient, written by hand
//   (CUDA has no autodiff) and chosen by template parameters (K1, K4): the
//   body and its shape (the flagship's (n_obs, d_w) = (16, 8) compiled as its
//   own variant, or a runtime shape);
// - the staged body (kStaged): any column log-density within the op set of
//   kernels/staged.py, printed by that module as gjt_staged::lp_grad into a
//   header that a staged build includes through -DGJT_STAGED_HEADER=<...>
//   (kernels/_build.py::load_staged). Only a staged build instantiates it, and
//   only it: the other builds compile as they did without the macro. A
//   header with chain operands (the trace path's frozen choices and arguments
//   that differ from chain to chain) also defines GJT_STAGED_CHAIN: its
//   kernels read each chain's kChain values from a (kChain, N) block
//   (ChainOperands below), and no other build sees them.
//
// What bounds the bodies on this card: FP32 instruction throughput. A
// flagship gradient is about 256 FFMAs of X against w and r. Read from shared
// memory inside a runtime loop, each FFMA pair costs a load, and the SM
// starts one such load a clock against four FFMAs; so the specialised shape
// unrolls its loops and takes X and y as constant-bank operands (below),
// which leaves the FFMAs and 16 independent residual chains.
//
// No fast-math in any kernel that includes this: rejection relies on NaN and
// -inf comparing false. The counter stream is the reference's bit for bit
// and keeps the accurate logf/cosf; the Philox stream, held in law only,
// takes its transform on the SFU through explicit intrinsics (below).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

#ifdef GJT_STAGED_HEADER
#include GJT_STAGED_HEADER  // gjt_staged::lp_grad, kD, kConsts, kConstMode
#endif

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.14159265358979f;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr uint32_t kBlockMix = 0x3504F333u;

enum Body { kIidNormal = 0, kHierRegression = 1, kStaged = 2 };
enum Rng { kCounter = 0, kPhilox = 1, kRbg = 2, kThreefry = 3 };

// ---------------------------------------------------------------- K2: PRNG

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// _sw_rand_bits_factory: base ^ salt*0x9E3779B1 + row*0x85EBCA77 +
// col*0xC2B2AE3D, then two murmur3 finalizer rounds, all mod 2^32.
__device__ __forceinline__ uint32_t counter_bits(uint32_t base, uint32_t salt,
                                                 uint32_t row, uint32_t col) {
  uint32_t x = base ^ (salt * 0x9E3779B1u);
  x = x + row * 0x85EBCA77u + col * 0xC2B2AE3Du;
  return fmix32(fmix32(x));
}

// _uniform_01: the top 24 bits, with a half-step offset, so u is in (0, 1).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f) +
         (0.5f / 16777216.0f);
}

// _normal: Box-Muller (cosine branch) on salts s and s + 1.
__device__ __forceinline__ float counter_normal(uint32_t base, uint32_t salt,
                                                uint32_t row, uint32_t col) {
  const float u1 = uniform_from_bits(counter_bits(base, salt, row, col));
  const float u2 = uniform_from_bits(counter_bits(base, salt + 1u, row, col));
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

// ---------------------------------------------------- K2: the Philox stream
//
// Philox4x32-10 from curand's header, keyed by the caller (seed, chain) and
// counted by the caller's (step or salt, draw, kind, 0). What bounds it on
// this card is issue slots: a call is about 45 integer instructions (a
// round is two IMAD.WIDE and two LOP3), and a Box-Muller with the accurate
// sincosf/logf/sqrtf would add about 240 more. So the transform runs on the
// SFU (MUFU: sin, cos, lg2 and sqrt at 16 a clock an SM, beside the FP32
// and integer pipes), uniforms take no int-to-float conversion (16 a clock
// an SM as well), and callers use every word of a call.

// sqrt.approx.f32: one MUFU operation, relative error about 2^-23.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// A uniform in (0, 1) from the low 23 bits m of a Philox word: the exponent
// of 1 OR'd in gives 1 + m 2^-23, and one exact subtraction (Sterbenz) of
// 1 - 2^-24 gives (2m + 1) 2^-24, in [2^-24, 1 - 2^-24].
__device__ __forceinline__ float philox_u01(uint32_t w) {
  return __uint_as_float((w & 0x007FFFFFu) | 0x3F800000u) - (1.0f - 0x1p-24f);
}

// Box-Muller's radius sqrt(-2 ln u) on the SFU. Near u = 1, lg2.approx's
// absolute error (about 1e-7) exceeds |ln u| (3e-8 at the top) and could
// turn -2 ln u negative, so where t = 1 - u (exact) is under 2^-6 the series
// -2 ln(1 - t) = 2t + t^2 + 2t^3/3 + t^4/2 takes its place (truncation under
// 2^-24 / 5 of the value); both branches give r^2 > 0.
__device__ __forceinline__ float bm_radius(float u) {
  constexpr float kMinusTwoLn2 = -1.3862943611198906f;
  const float t = 1.0f - u;
  const float series = t * fmaf(t, fmaf(t, fmaf(t, 0.5f, 0.6666667f), 1.0f), 2.0f);
  return sqrt_approx(t < 0x1p-6f ? series : kMinusTwoLn2 * __log2f(u));
}

// Box-Muller's angle 2 pi u - pi, in (-pi, pi) where __sincosf's absolute
// error is 2^-21.41; the shift by pi flips both signs, the same in law.
__device__ __forceinline__ void bm_angle(float u, float* s, float* c) {
  __sincosf(fmaf(kTwoPi, u, -kPi), s, c);
}

// Four standard normals by Box-Muller (both branches of two pairs) from one
// Philox4x32-10 call: radii from words x and z, angles from y and w.
__device__ __forceinline__ float4 philox_normals4(uint4 counter, uint2 key) {
  const uint4 b = curand_Philox4x32_10(counter, key);
  float s0, c0, s1, c1;
  bm_angle(philox_u01(b.y), &s0, &c0);
  bm_angle(philox_u01(b.w), &s1, &c1);
  const float r0 = bm_radius(philox_u01(b.x));
  const float r1 = bm_radius(philox_u01(b.z));
  return make_float4(r0 * c0, r0 * s0, r1 * c1, r1 * s1);
}

// Uniforms four a Philox call: draw n takes word n % 4 of the call at
// counter (n / 4, 0, 2, 0), made when the first draw of its four comes, so
// draws n must come in increasing order (gaps allowed). The kind word 2
// keeps these counters apart from the caller's normals.
struct PhiloxUniforms {
  uint4 words = make_uint4(0u, 0u, 0u, 0u);
  uint32_t group = 0xFFFFFFFFu;

  __device__ __forceinline__ float draw(uint32_t n, uint2 key) {
    if ((n >> 2) != group) {
      group = n >> 2;
      words = curand_Philox4x32_10(make_uint4(group, 0u, 2u, 0u), key);
    }
    const uint32_t t = n & 3u;
    return philox_u01(t == 0u ? words.x : t == 1u ? words.y : t == 2u ? words.z : words.w);
  }
};

// ------------------------------------------------------- K2: the rbg stream
//
// jax.random under an rbg key (w0, w1, w2, w3) draws XLA's RngBitGenerator,
// which JAX's CPU backend runs as Philox4x32-10: the Philox key is (w0, w1),
// block b is counted at (w2 + b, w3 + carry, w0, w1) (a 64-bit add over the
// two low words), and its four words are the row-major elements 4b .. 4b + 3
// of the draw (core/keys.py has the same in torch). A kernel draws element f
// of a draw (the reference's flat index: row * N + chain for a (D, N) draw,
// the chain for an (N,) one) with one Philox call, keeping one word of four.
// The transforms are the reference's, step for step: uniform is the top 23
// bits under an exponent of 1, less 1; normal is sqrt(2) erf_inv(u) of a
// uniform on [nextafter(-1, 0), 1), with XLA's float32 erf_inv polynomial
// (Giles) and its fused multiply-adds. Accurate log1pf and sqrtf: no
// intrinsic here.

// Block b of a draw under the rbg key k = (w0, w1, w2, w3): its elements
// 4b .. 4b + 3.
__device__ __forceinline__ uint4 rbg_block(uint4 k, uint64_t b) {
  const uint64_t low = static_cast<uint64_t>(k.z) + (b & 0xFFFFFFFFull);
  const uint32_t high = k.w + static_cast<uint32_t>(b >> 32) + static_cast<uint32_t>(low >> 32);
  return curand_Philox4x32_10(make_uint4(static_cast<uint32_t>(low), high, k.x, k.y), make_uint2(k.x, k.y));
}

__device__ __forceinline__ uint32_t word_of(uint4 w, uint32_t t) {
  return t == 0u ? w.x : t == 1u ? w.y : t == 2u ? w.z : w.w;
}

// Element f of a draw under the rbg key k.
__device__ __forceinline__ uint32_t rbg_word(uint4 k, uint64_t f) {
  return word_of(rbg_block(k, f >> 2), static_cast<uint32_t>(f & 3u));
}

// jax.random.uniform on [0, 1) from 32 bits.
__device__ __forceinline__ float rbg_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// XLA's float32 erf_inv (ErfInv32): a polynomial in w - 2.5 where
// w = -log1p(-x^2) < 5, else in sqrt(w) - 3, times x.
__device__ __forceinline__ float xla_erf_inv(float x) {
  constexpr float kCentral[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                                 -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                                 -0.00417768164f, 0.246640727f, 1.50140941f};
  constexpr float kTail[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                              -0.00367342844f, 0.00573950773f, -0.0076224613f,
                              0.00943887047f, 1.00167406f, 2.83297682f};
  const float xx = x * x;
  float w = -log1pf(-xx);
  const bool central = w < 5.0f;
  w = central ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = central ? kCentral[0] : kTail[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, w, central ? kCentral[i] : kTail[i]);
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

// jax.random.normal from 32 bits: minval + (maxval - minval) u, fused, with
// maxval - minval = 2 in float32, clipped below at minval.
__device__ __forceinline__ float rbg_normal(uint32_t bits) {
  constexpr float kLow = -0.99999994f;  // nextafter(-1, 0)
  const float u = fmaxf(kLow, fmaf(rbg_uniform(bits), 2.0f, kLow));
  return 1.41421356f * xla_erf_inv(u);
}

// The rows of a (D_ref, N) normal draw under k for this thread's chain n:
// launch row d takes the reference's row rows[d] (element rows[d] * N + n),
// a row of -1 gives 0. With `grouped` (N % 4 == 0, and the four chains
// n & ~3 .. n | 3 on the four lanes of an aligned 4-lane group, converged
// here) the group shares each Philox call: a row's block holds its words of
// the group's four chains, so for each four launch rows d0 .. d0 + 3 lane t
// makes row d0 + t's block, and four width-4 shuffles hand every lane its
// word of each (round j: lane s sends its word (s - j) & 3 and lane t takes
// lane (t + j) & 3's, which is its own word of row d0 + ((t + j) & 3)); four
// rows of -1 make no call. Otherwise one call a word. The rows are the same
// for every thread, so every branch on them is uniform.
template <int D>
__device__ __forceinline__ void rbg_normals(uint4 k, const int* rows, int N, uint32_t n, bool grouped,
                                            float (&z)[D]) {
  if (!grouped) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int row = __ldg(rows + d);
      z[d] = row < 0 ? 0.0f
                     : rbg_normal(rbg_word(k, static_cast<uint64_t>(row) * static_cast<uint64_t>(N) + n));
    }
    return;
  }
  const uint32_t t = n & 3u;
  const unsigned mask = 0xFu << (threadIdx.x & 28u);
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 4) {
    int r[4];
    bool any = false;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      r[s] = d0 + s < D ? __ldg(rows + d0 + s) : -1;
      any = any || r[s] >= 0;
    }
    if (!any) {
#pragma unroll
      for (int s = 0; s < 4 && d0 + s < D; ++s) z[d0 + s] = 0.0f;
      continue;
    }
    const int mine = t == 0u ? r[0] : t == 1u ? r[1] : t == 2u ? r[2] : r[3];
    const uint4 w = mine < 0 ? make_uint4(0u, 0u, 0u, 0u)
                             : rbg_block(k, (static_cast<uint64_t>(mine) * static_cast<uint64_t>(N) + (n & ~3u)) >> 2);
    uint32_t got[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      got[j] = __shfl_sync(mask, word_of(w, (t - j) & 3u), static_cast<int>((t + j) & 3u), 4);
#pragma unroll
    for (int s = 0; s < 4 && d0 + s < D; ++s) {
      const uint32_t j = (s - t) & 3u;  // the round that brought row d0 + s
      const uint32_t bits = j == 0u ? got[0] : j == 1u ? got[1] : j == 2u ? got[2] : got[3];
      z[d0 + s] = r[s] < 0 ? 0.0f : rbg_normal(bits);
    }
  }
}

// --------------------------------------------------- K2: the threefry stream
//
// jax.random under a threefry2x32 key (k1, k2), JAX's default, with
// jax_threefry_partitionable on: element f of a draw is the hash of the
// counter pair (f >> 32, f mod 2^32) under the key, its two output words
// XOR'd (core/keys.py::bits); split(k, num)[i] and fold_in(k, i) are both the
// hash of (0, i), taken as the new key. An rbg key is two threefry keys side
// by side, whose splits and fold-ins hash each half. K3's keyed kernels draw
// from them (ess_gauss_sweep.cu); the transforms are the rbg stream's above.
// What bounds a hash on this card: integer issue, about 72 instructions a
// call (20 rounds of an add, a funnel shift and an XOR, five key injections
// of two adds), each depending on the one before.

// threefry2x32 of the counter pair x under the key k: 20 rounds with
// Random123's rotations and a key injection every four, the third key word
// k1 ^ k2 ^ 0x1BD11BDA (core/keys.py::threefry2x32).
__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint2 x) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  uint32_t a = x.x + ks[0], b = x.y + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = __funnelshift_l(b, b, kRot[i % 2][j]);
      b ^= a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(a, b);
}

// Element f of a draw under the threefry key k.
__device__ __forceinline__ uint32_t threefry_word(uint2 k, uint64_t f) {
  const uint2 h = threefry2x32(k, make_uint2(static_cast<uint32_t>(f >> 32), static_cast<uint32_t>(f)));
  return h.x ^ h.y;
}

// A key of stream RNG (kThreefry: its words in x and y; kRbg: all four):
// fold_in(k, data), which is also split(k, num)[data].
template <int RNG>
__device__ __forceinline__ uint4 key_fold(uint4 k, uint32_t data) {
  const uint2 a = threefry2x32(make_uint2(k.x, k.y), make_uint2(0u, data));
  if constexpr (RNG == kRbg) {
    const uint2 b = threefry2x32(make_uint2(k.z, k.w), make_uint2(0u, data));
    return make_uint4(a.x, a.y, b.x, b.y);
  } else {
    return make_uint4(a.x, a.y, 0u, 0u);
  }
}

// Element f of a draw under the key k of stream RNG.
template <int RNG>
__device__ __forceinline__ uint32_t key_word(uint4 k, uint64_t f) {
  if constexpr (RNG == kRbg) {
    return rbg_word(k, f);
  } else {
    return threefry_word(make_uint2(k.x, k.y), f);
  }
}

// --------------------------------------------------------------- bodies
//
// One chain per thread. The flagship's constants, hier_regression's X
// (16 x 8) and y (16), are the same for every chain. At the specialised shape
// (n_obs, d_w) = (16, 8) the observation and weight loops unroll completely
// and the constants travel by value in the kernel's parameter space
// (UniformConsts, a __grid_constant__ kernel parameter), so every X and y read
// is an FFMA operand from the constant bank at a compile-time offset: no load
// instruction at all. The runtime-shape variant (any (n_obs, d_w)) runs the
// same body with runtime loop bounds and the constants in shared memory
// (SharedConsts), X as compact as in device memory.

// X (NOBS x DW, row-major) and y of a specialised shape, by value in the
// kernel's parameter space. An empty struct for the runtime-shape variant.
template <int NOBS, int DW>
struct UniformConsts {
  float X[NOBS * DW];
  float y[NOBS];

  __device__ __forceinline__ float x(int i, int j) const { return X[i * DW + j]; }
  __device__ __forceinline__ float yv(int i) const { return y[i]; }
};

#ifndef GJT_STAGED_HEADER
template <>
struct UniformConsts<0, 0> {};
#endif

// X (n_obs x d_w, row-major) and y of a runtime shape, in shared memory.
struct SharedConsts {
  const float* X;
  const float* y;
  int d_w;

  __device__ __forceinline__ float x(int i, int j) const { return X[i * d_w + j]; }
  __device__ __forceinline__ float yv(int i) const { return y[i]; }
};

// Floats of the runtime shape's constants in shared memory (X, y), rounded
// up to a float4 so what follows them stays 16-byte aligned.
__host__ __device__ constexpr int shared_consts_floats(int n_obs, int d_w) {
  return (n_obs * (d_w + 1) + 3) / 4 * 4;
}

// Copy the constants (X n_obs x d_w row-major, then y) from device memory to
// shared memory; the block synchronises before reading them.
__device__ __forceinline__ void load_shared_consts(float* dst, const float* consts, int n_obs,
                                                   int d_w) {
  for (int k = threadIdx.x; k < n_obs * (d_w + 1); k += blockDim.x) dst[k] = consts[k];
}

// The runtime shape of a body.
struct BodyShape {
  int n_obs;
  int d_w;
  float obs_scale;
};

template <int D>
__device__ __forceinline__ float iid_normal(const float (&q)[D], float (&g)[D]) {
  float lp = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    lp -= 0.5f * q[d] * q[d];
    g[d] = -q[d];
  }
  return lp;
}

// q[0] = tau, q[1 .. d_w] = w, the rest is padding with a standard-normal
// density. lp = LogNormal(tau; 0, .5) + sum_j N(w_j; 0, tau)
//             + sum_i N(y_i; (X w)_i, obs_scale) - 1/2 sum pad^2.
// Normal terms use the reference's form -(log(2 pi s^2) + (x - m)^2 / s^2) / 2.
// Outside tau > 0 the log-normal term is -inf while its gradient keeps
// log(tau), so it is NaN there exactly as autograd through the model gives,
// and the proposal is rejected.
//
// NOBS, DW > 0: the specialised shape, loops unrolled; 0: the runtime shape.
// Each observation's residual r = y_i - sum_j X_ij w_j and its gradient terms
// are summed in the reference's order (j ascending, then observations
// ascending).
template <int D, int NOBS, int DW, class Consts>
__device__ __forceinline__ float hier_regression(const float (&q)[D], float (&g)[D],
                                                 const Consts& c, const BodyShape& s) {
  const int n_obs = NOBS > 0 ? NOBS : s.n_obs;
  const int d_w = NOBS > 0 ? DW : s.d_w;

  const float tau = q[0];
  const float lt = logf(tau);
  float lp = tau > 0.0f ? -(kLog2Pi + logf(0.25f) + 4.0f * lt * lt) * 0.5f - lt : -INFINITY;
  float g_tau = -(4.0f * lt + 1.0f) / tau;

  const float tau2 = tau * tau;
  const float inv_tau2 = 1.0f / tau2;
  const float log_norm_w = logf(kTwoPi * tau2);
  float sum_w2 = 0.0f;
#pragma unroll
  for (int j = 0; j < D - 1; ++j) {
    if (j < d_w) {
      const float w = q[1 + j];
      sum_w2 += w * w;
      g[1 + j] = -w * inv_tau2;
    }
  }
  lp -= 0.5f * (static_cast<float>(d_w) * log_norm_w + sum_w2 * inv_tau2);
  g_tau += sum_w2 * inv_tau2 / tau - static_cast<float>(d_w) / tau;

  const float inv_s2 = 1.0f / (s.obs_scale * s.obs_scale);
  float sum_r2 = 0.0f;
#pragma unroll
  for (int i = 0; i < (NOBS > 0 ? NOBS : n_obs); ++i) {
    float r = c.yv(i);
#pragma unroll
    for (int j = 0; j < D - 1; ++j) {
      if (j < d_w) r -= c.x(i, j) * q[1 + j];
    }
    sum_r2 += r * r;
    const float rs = r * inv_s2;
#pragma unroll
    for (int j = 0; j < D - 1; ++j) {
      if (j < d_w) g[1 + j] += c.x(i, j) * rs;
    }
  }
  lp -= 0.5f * (static_cast<float>(n_obs) * logf(kTwoPi * s.obs_scale * s.obs_scale) +
                sum_r2 * inv_s2);
  g[0] = g_tau;

#pragma unroll
  for (int d = 1; d < D; ++d) {
    if (d > d_w) {
      lp -= 0.5f * q[d] * q[d];
      g[d] = -q[d];
    }
  }
  return lp;
}

// ------------------------------------------------------------ the staged body
//
// A staged build's body reads its hoisted constants (kernels/staged.py) where
// the header's kConstMode puts them: by value in the kernel's parameter space
// (kStagedParams: UniformConsts<0, 0> below, which only the staged kernel of
// a staged build instantiates), so that each read at a compile-time index is
// a constant-bank operand, as the flagship's X and y are; in shared memory,
// copied there at block start (kStagedSharedFloats > 0); or from global
// memory through __ldg (the header's GJT_C). kStagedD is the build's D.
//
// Chain operands (a header that defines GJT_STAGED_CHAIN): the pointer to
// their (kChain, N) block rides in the same kernel parameter, and each thread
// reads its chain's kChain values once, at sweep start, into registers
// (ChainOperands): the block is chain-minor as q is, so a warp's reads of one
// row are coalesced, and the body then reads them as registers at every
// gradient. The cap is the header's (kChainInRegisters; 32 operands,
// kernels/staged.py, CHAIN_REGISTER_CAP: the staged flagship's K1 holds 168
// registers of 255 without spilling, so 32 more still fit a thread; K4 already
// takes 255, where a larger k would only turn into spills). Above the cap a
// chain's operands are read through __ldg at each gradient (a warp's reads
// stay coalesced, and the block stays in L1 and L2).
// A staged build holds its kernels in one stream mode: the rbg kernels
// where -DGJT_STAGED_RBG is given (kernels/_build.py::load_staged), the
// other streams' kernels otherwise.
#ifdef GJT_STAGED_RBG
constexpr bool kStagedRbg = true;
#else
constexpr bool kStagedRbg = false;
#endif

#ifdef GJT_STAGED_HEADER
constexpr int kStagedD = gjt_staged::kD;
constexpr int kStagedConsts = gjt_staged::kConsts;
constexpr int kStagedChain = gjt_staged::kChain;
constexpr bool kStagedParams = gjt_staged::kConstMode == gjt_staged::kParamConsts;
constexpr int kStagedSharedFloats =
    gjt_staged::kConstMode == gjt_staged::kSharedConsts ? (gjt_staged::kConsts + 3) / 4 * 4 : 0;

template <>
struct UniformConsts<0, 0> {
  float c[kStagedParams && kStagedConsts > 0 ? kStagedConsts : 1];
#ifdef GJT_STAGED_CHAIN
  const float* chain;  // the chain operands, (kStagedChain, N) row-major
#endif

  // the header's GJT_C(k): read through the struct, as hier_regression reads X,
  // so that the read stays a parameter-space operand
  __device__ __forceinline__ float operator[](int k) const { return c[k]; }
};

#ifdef GJT_STAGED_CHAIN
// One chain's operands: in registers up to the cap, read once here ...
template <bool InRegisters>
struct StagedChain {
  float v[kStagedChain];

  __device__ __forceinline__ StagedChain(const float* chain, int n, int N) {
#pragma unroll
    for (int r = 0; r < kStagedChain; ++r) v[r] = chain[static_cast<size_t>(r) * N + n];
  }
  __device__ __forceinline__ float operator[](int r) const { return v[r]; }
};

// ... above it, read through __ldg at each use
template <>
struct StagedChain<false> {
  const float* p;
  int N;

  __device__ __forceinline__ StagedChain(const float* chain, int n, int n_chains)
      : p(chain + n), N(n_chains) {}
  __device__ __forceinline__ float operator[](int r) const {
    return __ldg(p + static_cast<size_t>(r) * N);
  }
};

using ChainOperands = StagedChain<gjt_staged::kChainInRegisters>;
#endif

// consts: the kernel parameter's UniformConsts<0, 0> in the parameter mode, else
// a pointer to shared or global memory; chain: the chain's operands
// (ChainOperands), or NoChain where the header takes none
template <int D, class Chain, class Consts>
__device__ __forceinline__ float staged_lp_grad(const float (&q)[D], float (&g)[D], const Chain& chain,
                                                const Consts& consts) {
  static_assert(D == gjt_staged::kD, "a staged build instantiates its own D only");
#ifdef GJT_STAGED_CHAIN
  return gjt_staged::lp_grad(q, g, chain, consts);
#else
  (void)chain;
  return gjt_staged::lp_grad(q, g, consts);
#endif
}
#else
constexpr int kStagedD = 0;
constexpr int kStagedConsts = 0;
constexpr int kStagedChain = 0;
constexpr bool kStagedParams = false;
constexpr int kStagedSharedFloats = 0;

// declared only: a build without a staged header never instantiates it
template <int D, class Chain, class Consts>
__device__ float staged_lp_grad(const float (&q)[D], float (&g)[D], const Chain& chain,
                                const Consts& consts);
#endif

// The chain operands of a build whose body takes none: nothing.
struct NoChain {};

// Copy the staged constants into shared memory; the block synchronises
// before reading them.
__device__ __forceinline__ void load_staged_consts(float* dst, const float* consts) {
  for (int k = threadIdx.x; k < kStagedConsts; k += blockDim.x) dst[k] = consts[k];
}

// lp(q), with its gradient written to g (every entry).
template <int D, int BODY, int NOBS, int DW, class Consts>
__device__ __forceinline__ float lp_grad(const float (&q)[D], float (&g)[D], const Consts& c,
                                         const BodyShape& s) {
  if constexpr (BODY == kIidNormal) {
    return iid_normal<D>(q, g);
  } else {
    return hier_regression<D, NOBS, DW>(q, g, c, s);
  }
}

}  // namespace
