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
// and its gradient are a hand-written device body chosen by template
// parameters (CUDA has no autodiff; column_common.cuh): `iid_normal`, and
// `hier_regression`, the flagship hierarchical regression, either at the
// specialised shape (n_obs, d_w) = (16, 8), whose X and y are a
// __grid_constant__ kernel parameter read as constant-bank operands, or at a
// runtime shape, whose constants sit in shared memory. eps * M^-1, M^-1 and
// the momentum sd are per-dimension values the same for every chain, kept in
// shared memory. A staged build (column_common.cuh, kStaged) instantiates the
// same sweep with the staged body at its own D (any of 1..64): a straight-line
// body whose constants ride in the kernel parameter as the flagship's do, or,
// past the stager's caps, sit in shared memory in front of those values or are
// read from global memory. A staged body with chain operands (the trace path's
// per-chain frozen choices) reads each chain's own values from a (k, N) block,
// once a sweep into registers (column_common.cuh, ChainOperands).
//
// Bound on this card: fp32 instruction throughput. A flagship gradient is
// about 630 FLOP (256 FFMAs of X w and X^T r, the prior's logs and
// divisions), a leapfrog about 100 more, while a chain moves only 2 * D * 4
// bytes of state (one load and one store) whatever n_steps is.
// __launch_bounds__(128, 4) caps the registers at 128, so four 128-thread
// blocks share an SM: 528 slots on 132 SMs hold the flagship's 512 blocks in
// one wave. (64-thread blocks measured the same time on the H100; PERF.md.)
//
// Random streams (runtime flag `rng`):
//   0 = counter: the bit-exact port of the reference's software stream,
//       keyed by (seed, chain block of `block_n`, column, dimension, salt).
//       The block is a stream parameter, independent of this launch geometry.
//   1 = philox: Philox4x32-10 from curand's header, keyed by (seed, global
//       chain index): the momenta four normals a call at counter (step, j,
//       0, 0), the accept uniforms four steps a call at (step / 4, 0, 2, 0)
//       (column_common.cuh's PhiloxUniforms), each drawn at the top of its
//       step, before the leapfrogs; held in law only.
//   2 = rbg: the reference twin's keyed stream (column_common.cuh), drawn
//       by a kernel of its own, hmc_rbg_kernel (the same sweep with
//       RBG = true, so the other streams' kernels are compiled as before):
//       step i's momentum is normal(kp_i, (D_ref, N)) and its accept
//       uniform(ku_i, (N,)), the keys read from a (n_steps, 2) table the
//       host makes (kernels/hmc.py). Launch row d draws the reference's row
//       rows[d] (a packed block's rows come in another order), element
//       rows[d] * N + n; a row of -1 (padding) draws 0. Where N % 4 == 0 the
//       four chains of a 4-lane group share each momentum Philox call
//       (column_common.cuh, rbg_normals). Its momentum sd is the reference
//       twin's 1 / sqrt(M^-1). Draw for draw with the reference's XLA twin
//       on the CPU.
//
// No fast-math: rejection relies on NaN and -inf comparing false. The
// counter stream's Box-Muller keeps the accurate logf/cosf (bit-exact port);
// the Philox stream's runs on the SFU through explicit intrinsics.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

#include "column_common.cuh"  // K2 (counter and Philox streams), the device bodies

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;
// the staged sweep's bound: at most 255 registers a thread. The flagship's
// straight-line body takes 168 with no spill, three blocks an SM; a bound of
// four blocks (128 registers) spills 340 B and is no faster
// (scripts/staged_launch_bounds.py, PERF.md)
constexpr int kStagedMinBlocks = 2;
constexpr size_t kDefaultSmem = 48 * 1024;  // the most a block takes without opting in

struct Params {
  const float* q_in;      // (D, N)
  float* q_out;           // (D, N)
  float* accepts;         // (N,) accepted steps per chain
  const float* inv_mass;  // (D,)
  const float* consts;    // body constants in device memory: X (n_obs x d_w), y
  BodyShape shape;
  int N;
  int n_steps;
  int L;
  float eps;
  uint32_t seed;
  int rng;
  int block_n;
  const uint4* rbg_keys;  // rbg: (n_steps, 2) keys, kp then ku of each step
  const int* rbg_rows;    // rbg: (D,) the reference's row of each launch row, -1 none
};

// ---------------------------------------------------------------- sweep

// The sweep of one chain a thread. RBG: the rbg stream (hmc_rbg_kernel);
// otherwise the stream is prm.rng (hmc_sweep_kernel).
template <int D, int BODY, int NOBS, int DW, bool RBG>
__device__ __forceinline__ void hmc_sweep_impl(const Params& prm, const UniformConsts<NOBS, DW>& uc) {
  constexpr bool kShared = BODY == kHierRegression && NOBS == 0;
  constexpr bool kStagedSmem = BODY == kStaged && kStagedSharedFloats > 0;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_shared = kShared ? shared_consts_floats(prm.shape.n_obs, prm.shape.d_w)
                               : (kStagedSmem ? kStagedSharedFloats : 0);
  float* s_eps_im = smem + n_shared;  // eps * M^-1
  float* s_im = s_eps_im + D;         // M^-1
  float* s_std = s_im + D;            // momentum sd, sqrt(M)
  if (kShared) load_shared_consts(smem, prm.consts, prm.shape.n_obs, prm.shape.d_w);
  if (kStagedSmem) load_staged_consts(smem, prm.consts);
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const float im = prm.inv_mass[k];
    s_eps_im[k] = prm.eps * im;
    s_im[k] = im;
    s_std[k] = RBG ? 1.0f / sqrtf(im) : sqrtf(1.0f / im);
  }
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= prm.N) return;
#ifdef GJT_STAGED_CHAIN
  const ChainOperands chain(uc.chain, n, prm.N);  // this chain's, read once
#else
  const NoChain chain{};
#endif
  // the specialised shape reads X and y straight from the kernel parameter
  auto body_lp = [&](const float (&x)[D], float (&gx)[D]) {
    if constexpr (BODY == kStaged && kStagedParams) {
      return staged_lp_grad<D>(x, gx, chain, uc);
    } else if constexpr (BODY == kStaged) {
      return staged_lp_grad<D>(x, gx, chain,
                               kStagedSmem ? static_cast<const float*>(smem) : prm.consts);
    } else if constexpr (kShared) {
      const SharedConsts c{smem, smem + prm.shape.n_obs * prm.shape.d_w, prm.shape.d_w};
      return lp_grad<D, BODY, NOBS, DW>(x, gx, c, prm.shape);
    } else {
      return lp_grad<D, BODY, NOBS, DW>(x, gx, uc, prm.shape);
    }
  };

  float q[D], g[D], p[D], qn[D], gn[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = prm.q_in[static_cast<size_t>(d) * prm.N + n];
  float lp = body_lp(q, g);

  // the counter stream's chain block and column (int32 wraparound of the
  // reference's seed + block * 0x3504F333 is uint32 arithmetic here)
  const uint32_t base = prm.seed + static_cast<uint32_t>(n / prm.block_n) * kBlockMix;
  const uint32_t col = static_cast<uint32_t>(n % prm.block_n);
  const uint2 philox_key = make_uint2(prm.seed, static_cast<uint32_t>(n));

  const float half_eps = prm.eps / 2.0f;
  float accepted = 0.0f;
  PhiloxUniforms accept_u;
  for (int i = 0; i < prm.n_steps; ++i) {
    const uint32_t salt = static_cast<uint32_t>(i) * 4u;
    // the accept uniform first: its counter is known before the trajectory
    // that its decision waits for
    float u = 0.0f;
    if constexpr (RBG) {
      // element row * N + n of normal(kp, (D_ref, N)), four chains a
      // Philox call where N % 4 == 0 (the block's threads are 128, so a
      // chain's 4-lane group is aligned); n of uniform(ku, (N,))
      u = rbg_uniform(rbg_word(__ldg(prm.rbg_keys + 2 * i + 1), static_cast<uint64_t>(n)));
      rbg_normals<D>(__ldg(prm.rbg_keys + 2 * i), prm.rbg_rows, prm.N, static_cast<uint32_t>(n), prm.N % 4 == 0, p);
#pragma unroll
      for (int d = 0; d < D; ++d) p[d] *= s_std[d];
    } else {
      if (prm.rng == kPhilox) u = accept_u.draw(static_cast<uint32_t>(i), philox_key);
      if (prm.rng == kCounter) {
#pragma unroll
        for (int d = 0; d < D; ++d) p[d] = s_std[d] * counter_normal(base, salt, d, col);
      } else {
#pragma unroll
        for (int j = 0; j < (D + 3) / 4; ++j) {  // a D that is no multiple of 4 drops the last words
          const float4 z = philox_normals4(
              make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(j), 0u, 0u), philox_key);
          p[4 * j + 0] = s_std[4 * j + 0] * z.x;
          if (4 * j + 1 < D) p[4 * j + 1] = s_std[4 * j + 1] * z.y;
          if (4 * j + 2 < D) p[4 * j + 2] = s_std[4 * j + 2] * z.z;
          if (4 * j + 3 < D) p[4 * j + 3] = s_std[4 * j + 3] * z.w;
        }
      }
    }
    float ke0 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ke0 += s_im[d] * p[d] * p[d];
      qn[d] = q[d];
      gn[d] = g[d];
    }
    ke0 *= 0.5f;

    float lpn = lp;
    for (int l = 0; l < prm.L; ++l) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        p[d] += half_eps * gn[d];
        qn[d] += s_eps_im[d] * p[d];
      }
      lpn = body_lp(qn, gn);
#pragma unroll
      for (int d = 0; d < D; ++d) p[d] += half_eps * gn[d];
    }
    float ke1 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) ke1 += s_im[d] * p[d] * p[d];
    ke1 *= 0.5f;

    const float log_alpha = (lpn - ke1) - (lp - ke0);
    if (!RBG && prm.rng == kCounter) u = uniform_from_bits(counter_bits(base, salt + 2u, 0u, col));
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

template <int D, int BODY, int NOBS, int DW>
__global__ void __launch_bounds__(kThreads, BODY == kStaged ? kStagedMinBlocks : kMinBlocks)
    hmc_sweep_kernel(const __grid_constant__ Params prm,
                     const __grid_constant__ UniformConsts<NOBS, DW> uc) {
  hmc_sweep_impl<D, BODY, NOBS, DW, false>(prm, uc);
}

template <int D, int BODY, int NOBS, int DW>
__global__ void __launch_bounds__(kThreads, BODY == kStaged ? kStagedMinBlocks : kMinBlocks)
    hmc_rbg_kernel(const __grid_constant__ Params prm,
                   const __grid_constant__ UniformConsts<NOBS, DW> uc) {
  hmc_sweep_impl<D, BODY, NOBS, DW, true>(prm, uc);
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

// Dynamic shared memory of one block: the runtime-shape constants (or the
// staged body's, where they fit under the stager's cap), then eps * M^-1,
// M^-1 and the momentum sd.
size_t smem_bytes(int dim, int body, int specialised, int n_obs, int d_w) {
  const bool shared = body == kHierRegression && !specialised;
  const int consts = shared ? shared_consts_floats(n_obs, d_w)
                            : (body == kStaged ? kStagedSharedFloats : 0);
  return sizeof(float) * (static_cast<size_t>(consts) + 3 * static_cast<size_t>(dim));
}

// Calls f with the kernel instantiation for (dim, body, specialised, rbg) as
// integral constants, or returns cudaErrorInvalidValue. iid_normal has no
// constants and one variant.
template <class F>
cudaError_t dispatch(int dim, int body, int specialised, bool rbg, F&& f) {
  using std::integral_constant;
  using I8 = integral_constant<int, 8>;
  using I16 = integral_constant<int, 16>;
  using Iid = integral_constant<int, kIidNormal>;
  using Hier = integral_constant<int, kHierRegression>;
  using Z = integral_constant<int, 0>;
#ifdef GJT_STAGED_HEADER
  // a staged build holds the staged body at its own D in its one stream
  // mode, and nothing else
  if (body == kStaged && dim == kStagedD && rbg == kStagedRbg)
    return f(integral_constant<int, kStagedD>{}, integral_constant<int, kStaged>{}, Z{}, Z{},
             std::bool_constant<kStagedRbg>{});
  return cudaErrorInvalidValue;
#else
  auto g = [&](auto d, auto b, auto no, auto dw) {
    return rbg ? f(d, b, no, dw, std::true_type{}) : f(d, b, no, dw, std::false_type{});
  };
  if (body == kIidNormal) {  // no constants: one variant
    if (dim == 8) return g(I8{}, Iid{}, Z{}, Z{});
    if (dim == 16) return g(I16{}, Iid{}, Z{}, Z{});
  }
  if (body == kHierRegression && !specialised) {
    if (dim == 8) return g(I8{}, Hier{}, Z{}, Z{});
    if (dim == 16) return g(I16{}, Hier{}, Z{}, Z{});
  }
  if (body == kHierRegression && specialised && dim == 16)
    return g(I16{}, Hier{}, integral_constant<int, 16>{}, integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
#endif
}

template <int D, int BODY, int NOBS, int DW, bool RBG>
const void* kernel_ptr() {
  if constexpr (RBG)
    return reinterpret_cast<const void*>(&hmc_rbg_kernel<D, BODY, NOBS, DW>);
  else
    return reinterpret_cast<const void*>(&hmc_sweep_kernel<D, BODY, NOBS, DW>);
}

// Above the default 48 KiB a block opts in to `smem` bytes of dynamic shared
// memory; the runtime refuses more than the card's opt-in limit.
cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// The largest dynamic shared memory a block may opt in to on `device`, or -1.
int hmc_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

long hmc_smem_bytes(int dim, int body, int specialised, int n_obs, int d_w) {
  return static_cast<long>(smem_bytes(dim, body, specialised, n_obs, d_w));
}

// Returns the cudaError_t of the launch (0 on success). `consts` is the
// body's constants in device memory and `consts_host` the same on the host
// (read into the kernel's parameters at the specialised shape). `chain` is a
// staged body's (n_chain, N) block of chain operands in device memory, which
// a build whose header takes kChain of them needs (n_chain == kChain), and no
// other build takes (n_chain == 0).
//
// rng is kCounter, kPhilox or kRbg; the rbg stream takes `rbg_keys`, the
// sweep's (n_steps, 2) keys of four words in device memory, and `rbg_rows`,
// the reference's row of each launch row (-1: none), (dim,) in device memory.
int hmc_sweep(const float* q_in, float* q_out, float* accepts, const float* inv_mass,
              const float* consts, const float* consts_host, int n_consts, int body,
              int specialised, int dim, int N, int n_obs, int d_w, float obs_scale, int n_steps,
              int L, float eps, int seed, int rng, int block_n, const float* chain, int n_chain,
              const void* rbg_keys, const int* rbg_rows, void* stream) {
  if (N <= 0 || block_n <= 0 || n_consts < 0 || (rng != kCounter && rng != kPhilox && rng != kRbg))
    return cudaErrorInvalidValue;
  if (rng == kRbg && ((n_steps > 0 && rbg_keys == nullptr) || rbg_rows == nullptr))
    return cudaErrorInvalidValue;
  if (n_chain != kStagedChain || (n_chain > 0 && chain == nullptr)) return cudaErrorInvalidValue;
  if (body == kHierRegression && (d_w < 1 || d_w + 1 > dim || n_consts != n_obs * (d_w + 1)))
    return cudaErrorInvalidValue;
  if (specialised && body == kHierRegression && (n_obs != 16 || d_w != 8))
    return cudaErrorInvalidValue;
  if (body == kStaged && n_consts != kStagedConsts) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dim, body, specialised, n_obs, d_w);
  const Params prm{q_in, q_out, accepts, inv_mass, consts, BodyShape{n_obs, d_w, obs_scale},
                   N, n_steps, L, eps, static_cast<uint32_t>(seed), rng, block_n,
                   static_cast<const uint4*>(rbg_keys), rbg_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kThreads - 1) / kThreads;
  return dispatch(dim, body, specialised, rng == kRbg, [&](auto d, auto b, auto no, auto dw, auto rbg) {
    constexpr int NOBS = decltype(no)::value, DW = decltype(dw)::value;
    constexpr bool RBG = decltype(rbg)::value;
    const cudaError_t err =
        allow_smem(kernel_ptr<decltype(d)::value, decltype(b)::value, NOBS, DW, RBG>(), smem);
    if (err != cudaSuccess) return err;
    UniformConsts<NOBS, DW> uc{};
    if constexpr (NOBS > 0) std::memcpy(&uc, consts_host, sizeof(uc));
    if constexpr (decltype(b)::value == kStaged && kStagedParams && kStagedConsts > 0)
      std::memcpy(uc.c, consts_host, sizeof(float) * kStagedConsts);
#ifdef GJT_STAGED_CHAIN
    uc.chain = chain;
#endif
    if constexpr (RBG)
      hmc_rbg_kernel<decltype(d)::value, decltype(b)::value, NOBS, DW><<<blocks, kThreads, smem, s>>>(prm, uc);
    else
      hmc_sweep_kernel<decltype(d)::value, decltype(b)::value, NOBS, DW><<<blocks, kThreads, smem, s>>>(prm, uc);
    return cudaGetLastError();
  });
}

// Registers, local (spill) bytes a thread, and resident blocks an SM of one
// instantiation (the rbg kernel where rbg != 0): out[0..2]. Returns a
// cudaError_t.
int hmc_kernel_info(int dim, int body, int specialised, int n_obs, int d_w, int rbg, int* out) {
  const size_t smem = smem_bytes(dim, body, specialised, n_obs, d_w);
  return dispatch(dim, body, specialised, rbg != 0, [&](auto d, auto b, auto no, auto dw, auto r) {
    const void* fn = kernel_ptr<decltype(d)::value, decltype(b)::value, decltype(no)::value,
                                decltype(dw)::value, decltype(r)::value>();
    cudaError_t err = allow_smem(fn, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kThreads, smem);
  });
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
