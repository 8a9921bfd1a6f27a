// K2 alone: the random numbers of one HMC sweep (K1) made by the device
// functions K1 draws them with, and nothing else, so the PRNG's own time can
// be measured beside K1's.
//
// One thread a chain, as in K1: for each of `n_steps` steps it makes the D
// momentum normals and the accept uniform that hmc_sweep.cu's step makes,
// with the same column_common.cuh functions and counters (counter_normal and
// counter_bits; philox_normals4 and PhiloxUniforms), and
//   fold = 0: stores them: normals (n_steps, D, N), uniforms (n_steps, N),
//             float32, coalesced over the chain index;
//   fold = 1: adds them up in a register and stores one float a chain in
//             normals[0 .. N), so the generation is timed without the
//             stores of fold 0 (uniforms is not written).
// K1 multiplies each normal by the momentum's sd; this takes the standard
// normal.
//
// Random streams (runtime flag `rng`):
//   0 = counter: the bit-exact port of the reference's software stream,
//       keyed by (seed, chain block of `block_n`, column, dimension, salt);
//   1 = philox, as K1 draws it: Philox4x32-10 keyed by (seed, chain), four
//       normals a call at counter (step, j, 0, 0) by Box-Muller on the SFU,
//       and the accept uniforms four steps a call at (step / 4, 0, 2, 0);
//   2 = philox before its redesign: the same normals' counters through the
//       accurate sincosf/logf/sqrtf and 24-bit uniforms by int-to-float
//       conversion, and one more call a step at (step, D / 4, 0, 0) for the
//       uniform, of which one word is used. Kept so that the redesign is
//       timed against it in one run; the kernels never draw this way.
//
// k2_transform runs the Philox stream's Box-Muller radius and angle alone
// over every uniform the stream can give, for the whole-domain check.
//
// This is a measurement: the package's entry points do not launch it.
// No fast-math: the counter stream and the variant before the redesign keep
// the accurate logf/cosf; the Philox stream's intrinsics are explicit.

#include <cstdint>
#include <cuda_runtime.h>

#include "column_common.cuh"  // K2 (counter and Philox streams)

namespace {

constexpr int kThreads = 128;
constexpr int kD = 16;  // the flagship's padded dimension
constexpr int kPhiloxBefore = 2;

// The Philox Box-Muller before the redesign: 24-bit uniforms (as the
// counter stream's), accurate sincosf, logf and sqrtf.
__device__ __forceinline__ float4 philox_normals4_before(uint4 counter, uint2 key) {
  const uint4 b = curand_Philox4x32_10(counter, key);
  float s0, c0, s1, c1;
  sincosf(kTwoPi * uniform_from_bits(b.y), &s0, &c0);
  sincosf(kTwoPi * uniform_from_bits(b.w), &s1, &c1);
  const float r0 = sqrtf(-2.0f * logf(uniform_from_bits(b.x)));
  const float r1 = sqrtf(-2.0f * logf(uniform_from_bits(b.z)));
  return make_float4(r0 * c0, r0 * s0, r1 * c1, r1 * s1);
}

template <int RNG, bool FOLD>
__global__ void __launch_bounds__(kThreads)
    k2_stream_kernel(float* normals, float* uniforms, int N, int n_steps, uint32_t seed,
                     int block_n) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint32_t base = seed + static_cast<uint32_t>(n / block_n) * kBlockMix;
  const uint32_t col = static_cast<uint32_t>(n % block_n);
  const uint2 philox_key = make_uint2(seed, static_cast<uint32_t>(n));
  const size_t stride = static_cast<size_t>(N);
  float acc = 0.0f;
  PhiloxUniforms accept_u;
  for (int i = 0; i < n_steps; ++i) {
    float z[kD];
    float u;
    const uint32_t salt = static_cast<uint32_t>(i) * 4u;
    if constexpr (RNG == kCounter) {
#pragma unroll
      for (int d = 0; d < kD; ++d) z[d] = counter_normal(base, salt, d, col);
      u = uniform_from_bits(counter_bits(base, salt + 2u, 0u, col));
    } else {
      if constexpr (RNG == kPhilox) u = accept_u.draw(static_cast<uint32_t>(i), philox_key);
#pragma unroll
      for (int j = 0; j < kD / 4; ++j) {
        const uint4 counter =
            make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(j), 0u, 0u);
        const float4 v = RNG == kPhilox ? philox_normals4(counter, philox_key)
                                        : philox_normals4_before(counter, philox_key);
        z[4 * j + 0] = v.x;
        z[4 * j + 1] = v.y;
        z[4 * j + 2] = v.z;
        z[4 * j + 3] = v.w;
      }
      if constexpr (RNG == kPhiloxBefore)
        u = uniform_from_bits(curand_Philox4x32_10(
            make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(kD / 4), 0u, 0u),
            philox_key).x);
    }
    if constexpr (FOLD) {
#pragma unroll
      for (int d = 0; d < kD; ++d) acc += z[d];
      acc += u;
    } else {
      float* out = normals + static_cast<size_t>(i) * kD * stride + n;
#pragma unroll
      for (int d = 0; d < kD; ++d) out[d * stride] = z[d];
      uniforms[static_cast<size_t>(i) * stride + n] = u;
    }
  }
  if constexpr (FOLD) normals[n] = acc;
}

// Radius and angle of the Philox stream's Box-Muller at the uniform of every
// word whose low 23 bits are k < count.
__global__ void __launch_bounds__(kThreads)
    k2_transform_kernel(float* radius, float* cos_out, float* sin_out, int count) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  const float u = philox_u01(static_cast<uint32_t>(k));
  float s, c;
  bm_angle(u, &s, &c);
  radius[k] = bm_radius(u);
  cos_out[k] = c;
  sin_out[k] = s;
}

template <int RNG>
void launch(bool fold, int blocks, cudaStream_t s, float* normals, float* uniforms, int N,
            int n_steps, uint32_t seed, int block_n) {
  if (fold) {
    k2_stream_kernel<RNG, true><<<blocks, kThreads, 0, s>>>(normals, uniforms, N, n_steps, seed,
                                                           block_n);
  } else {
    k2_stream_kernel<RNG, false><<<blocks, kThreads, 0, s>>>(normals, uniforms, N, n_steps, seed,
                                                            block_n);
  }
}

}  // namespace

extern "C" {

// The stream's dimension (the momentum normals a step).
int k2_stream_dim() { return kD; }

// Returns the cudaError_t of the launch (0 on success).
int k2_stream(float* normals, float* uniforms, int N, int n_steps, int seed, int rng, int fold,
              int block_n, void* stream) {
  if (N <= 0 || n_steps < 0 || block_n <= 0 ||
      (rng != kCounter && rng != kPhilox && rng != kPhiloxBefore) || (fold != 0 && fold != 1))
    return cudaErrorInvalidValue;
  const int blocks = (N + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t useed = static_cast<uint32_t>(seed);
  if (rng == kCounter) {
    launch<kCounter>(fold != 0, blocks, s, normals, uniforms, N, n_steps, useed, block_n);
  } else if (rng == kPhilox) {
    launch<kPhilox>(fold != 0, blocks, s, normals, uniforms, N, n_steps, useed, block_n);
  } else {
    launch<kPhiloxBefore>(fold != 0, blocks, s, normals, uniforms, N, n_steps, useed, block_n);
  }
  return cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 on success); count <= 2^23.
int k2_transform(float* radius, float* cos_out, float* sin_out, int count, void* stream) {
  if (count <= 0 || count > (1 << 23)) return cudaErrorInvalidValue;
  k2_transform_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(radius, cos_out, sin_out, count);
  return cudaGetLastError();
}

}  // extern "C"
