// NUTS sweep for Hopper (sm_90a), one chain per thread: K4.
//
// Replaces genjax_tpu/kernels/nuts_pallas.py::_nuts_kernel, the Pallas TPU
// kernel that keeps a chain block's whole NUTS tree on chip for a sweep. A
// staged build (column_common.cuh, kStaged) instantiates the same sweep with
// the staged body at its own D, its constants in the kernel parameter (or, past
// the stager's caps, in front of the stacks or in global memory), and, where
// the body takes chain operands, each chain's own from a (k, N) block, read
// once a sweep (column_common.cuh, ChainOperands).
//
// What it computes: n_steps NUTS transitions on each of N chains, with the
// reference kernel's semantics. A transition draws momentum r0 ~ N(0, M) and
// doubles the trajectory up to max_depth times, each doubling in a random
// direction: a subtree of 2^j leapfrog leaves, multinomial progressive
// sampling within it and biased progressive sampling across doublings. Leaf
// i is pushed on a checkpoint stack at slot popcount(i) and checked for a
// U-turn against slots popcount(i) - 1 - k, k < ntz(i + 1), the openers of
// every balanced subtree closing at i; a leaf whose energy rises by more than
// div_threshold diverges. Per chain it returns the position, and the accept
// statistic and leapfrog count summed over the transitions.
//
// Design: a CUDA block is a chain block of `blockDim.x` chains, one chain a
// thread. The leaf loop and the doubling loop exit on block-wide conditions
// (any chain of the block still integrating, any not done), taken with
// __syncthreads_or, exactly as the reference exits per chain block; so every
// loop bound is uniform over the block, and the stream's salt, which advances
// once per block-wide draw, is one per block. The two checkpoint stacks sit
// in dynamic shared memory, [slot][d][chain], so a warp's accesses fall in
// consecutive banks; the body's constants (at a runtime shape) sit in front
// of them. The tree (its two ends with their gradients, the proposal) and the
// subtree's proposal are register arrays, D being a template parameter. The
// subtree is built in place on the end it extends: both ends are swapped
// when it runs backward, and an end left half-extended by a subtree that
// U-turned or diverged is never read again, since that chain is then done.
// A chain that is done, or whose subtree has stopped, skips the leapfrog:
// its state would not change, and what it would push is never read.
//
// Bound on this card: every leaf is a dependent chain of a gradient (about
// 630 FLOP for the flagship, with the prior's logs and divisions) and the
// scalar work after it (energies, log-add-exp, the PRNG, the decisions), so
// the kernel is bound by latency and instruction throughput. A thread holds
// about 128 registers of tree state and uses 255 in all, and the default
// 32-chain block (one warp) takes 32 KiB of stacks at depth 8, so six blocks
// share an SM (shared-memory bound); the specialised body's unrolled
// observations, whose X and y are kernel-parameter operands, give the warp
// its ILP. (Spreading a chain over 2 or 4 lanes, with its sums taken by warp
// shuffles, measured about twice as slow on the H100: every lane repeats the
// scalar work; PERF.md.)
//
// Random streams (runtime flag `rng`):
//   0 = counter: K2, bit-exact; the block's base is seed + block * 0x3504F333,
//       the column is the thread, and the salt schedule is the reference's:
//       a transition draws r0 on salts s, s + 1 and starts doubling at s + 4;
//       every direction, leaf and subtree take draws at the salt and moves it
//       by 4; a transition ends by moving it by 4. The launch block is the
//       stream's chain block.
//   1 = philox: Philox4x32-10 from curand's header, keyed by (seed, chain):
//       r0 four normals a call at counter (salt, j, 1, 0) (philox_normals4);
//       the direction, leaf and subtree uniforms, whose salts are 1 + 4m,
//       four a call: draw m takes word m % 4 of the call at (m / 4, 0, 2, 0)
//       (column_common.cuh's PhiloxUniforms); held in law only.
//   Every thread takes a leaf's uniform before the leaf's leapfrog, a done
//   or stopped chain too, so the Philox call that a fourth draw makes is
//   block-uniform and its rounds do not wait behind the gradient.
//   2 = rbg: the reference twin's keyed stream (column_common.cuh), drawn by
//       a kernel of its own, nuts_rbg_kernel (the same sweep with RBG = true,
//       so the other streams' kernels are compiled as before). Transition t
//       reads its keys from row t of a table the host makes
//       (kernels/nuts_pallas.py, rbg_table): kr, then doubling j's
//       direction key fold_in(kd, j), its subtree key fold_in(fold_in(ku, j),
//       1 << 30), and its leaf keys fold_in(fold_in(ku, j), i). Chain n
//       draws element n of each (N,) draw (the direction is forward where
//       its uniform is under 0.5, as the reference's bernoulli has it) and
//       element rows[d] * N + n of the momentum normal(kr, (D_ref, N)) at
//       launch row d (-1, padding, draws 0; four chains a Philox call where
//       N and the block are multiples of 4), with the momentum sd
//       1 / sqrt(M^-1).
//       A chain's draws depend on its index alone, so the block-wide exits
//       change none: draw for draw with the reference's XLA twin on the CPU.
//
// No fast-math: NaN energies become +inf, logaddexp(-inf, -inf) is -inf, and
// u < NaN must be false. The counter stream keeps the accurate logf/cosf
// (bit-exact port); the Philox stream's Box-Muller runs on the SFU.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

#include "column_common.cuh"  // K2 (counter and Philox streams), the device bodies

namespace {

constexpr int kMaxThreads = 256;

struct NutsParams {
  const float* q_in;      // (D, N)
  float* q_out;           // (D, N)
  float* accepts;         // (N,) accept statistic summed over transitions
  float* leaps;           // (N,) leapfrogs summed over transitions
  const float* inv_mass;  // (D,)
  const float* consts;    // body constants in device memory: X (n_obs x d_w), y
  BodyShape shape;
  int N;
  int n_steps;
  float eps;
  float div_threshold;
  int max_depth;
  uint32_t seed;
  int rng;
  const uint4* rbg_keys;  // rbg: (n_steps, rbg_stride) keys of four words
  int rbg_stride;         // rbg: keys a transition, 2 max_depth + 2^max_depth
  const int* rbg_rows;    // rbg: (D,) the reference's row of each launch row, -1 none
};

// jnp.logaddexp: max + log1p(exp(-|a - b|)), and a + b where a - b is NaN
// (NaN inputs, or infinities of one sign: logaddexp(-inf, -inf) = -inf).
__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float delta = a - b;
  if (isnan(delta)) return a + b;
  return fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
}

// jnp.minimum(1, x), which keeps a NaN (fminf would drop it).
__device__ __forceinline__ float min1(float x) { return isnan(x) ? x : fminf(1.0f, x); }

struct Stream {
  int rng;
  uint32_t base;  // counter: seed + block * kBlockMix
  uint32_t col;   // counter: the chain's column in its block
  uint2 key;      // philox: (seed, chain)
  PhiloxUniforms cache;  // philox: the uniforms' current call

  // the reference's (1, block) uniform draw: row 0; salts come in
  // increasing order
  __device__ __forceinline__ float uniform(uint32_t salt) {
    if (rng == kCounter) return uniform_from_bits(counter_bits(base, salt, 0u, col));
    return cache.draw(salt >> 2, key);
  }

  // the reference's (D, block) normal draw on salts salt and salt + 1
  template <int D>
  __device__ __forceinline__ void normals(uint32_t salt, float (&z)[D]) const {
    if (rng == kCounter) {
#pragma unroll
      for (int d = 0; d < D; ++d) z[d] = counter_normal(base, salt, d, col);
      return;
    }
#pragma unroll
    for (int j = 0; j < (D + 3) / 4; ++j) {  // a D that is no multiple of 4 drops the last words
      const float4 v = philox_normals4(make_uint4(salt, static_cast<uint32_t>(j), 1u, 0u), key);
      z[4 * j + 0] = v.x;
      if (4 * j + 1 < D) z[4 * j + 1] = v.y;
      if (4 * j + 2 < D) z[4 * j + 2] = v.z;
      if (4 * j + 3 < D) z[4 * j + 3] = v.w;
    }
  }
};

template <int D>
__device__ __forceinline__ void swap_if(bool cond, float (&a)[D], float (&b)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float t = a[d];
    a[d] = cond ? b[d] : a[d];
    b[d] = cond ? t : b[d];
  }
}

// 1/2 r' M^-1 r, summed in the reference's order ((m * r) * r).
template <int D>
__device__ __forceinline__ float kinetic(const float (&r)[D], const float (&im)[D]) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) s += im[d] * r[d] * r[d];
  return 0.5f * s;
}

#ifdef GJT_STAGED_HEADER
// a staged build holds the staged kernel alone: its bound on resident
// 256-thread blocks (registers at most 65536 / (256 * kStagedMinBlocks) a
// thread); PERF.md has the alternatives' times
constexpr int kStagedMinBlocks = 1;
#define NUTS_LAUNCH_BOUNDS __launch_bounds__(kMaxThreads, kStagedMinBlocks)
#else
#define NUTS_LAUNCH_BOUNDS __launch_bounds__(kMaxThreads)
#endif

// The sweep of one chain a thread. RBG: the rbg stream (nuts_rbg_kernel);
// otherwise the stream is prm.rng (nuts_sweep_kernel).
template <int D, int BODY, int NOBS, int DW, bool RBG>
__device__ __forceinline__ void nuts_sweep_impl(const NutsParams& prm,
                                                const UniformConsts<NOBS, DW>& uc) {
  constexpr bool kShared = BODY == kHierRegression && NOBS == 0;
  constexpr bool kStagedSmem = BODY == kStaged && kStagedSharedFloats > 0;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int n_shared = kShared ? shared_consts_floats(prm.shape.n_obs, prm.shape.d_w)
                               : (kStagedSmem ? kStagedSharedFloats : 0);
  float* ck_z = smem + n_shared;  // checkpoint stacks [slot][d][thread]
  float* ck_r = ck_z + prm.max_depth * D * T;
  if (kShared) load_shared_consts(smem, prm.consts, prm.shape.n_obs, prm.shape.d_w);
  if (kStagedSmem) load_staged_consts(smem, prm.consts);
  __syncthreads();

#ifdef GJT_STAGED_CHAIN
  // this chain's operands, read once (a thread past N reads chain 0's)
  const int n_own = blockIdx.x * T + tid;
  const ChainOperands chain(uc.chain, n_own < prm.N ? n_own : 0, prm.N);
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

  // threads past N idle through the block-wide loops as done chains
  const int n = blockIdx.x * T + tid;
  const bool valid = n < prm.N;
  Stream stream{prm.rng, prm.seed + static_cast<uint32_t>(blockIdx.x) * kBlockMix,
                static_cast<uint32_t>(tid), make_uint2(prm.seed, static_cast<uint32_t>(n)), {}};

  float im[D], q[D];  // the inverse mass; the position: each transition's proposal
#pragma unroll
  for (int d = 0; d < D; ++d) {
    im[d] = prm.inv_mass[d];
    q[d] = valid ? prm.q_in[static_cast<size_t>(d) * prm.N + n] : 1.0f;
  }

  // the tree: its backward (m) and forward (p) ends with their gradients,
  // and the subtree's proposal
  float zm[D], rm[D], gm[D], zp[D], rp[D], gp[D], szprop[D];
  float acc_sum = 0.0f, leap_sum = 0.0f;
  uint32_t salt = 1u;

  // rbg: element n of an (N,) draw; this transition's keys
  const uint64_t nn = static_cast<uint64_t>(n);
  const uint4* keys = prm.rbg_keys;
  for (int step = 0; step < prm.n_steps; ++step) {
    if constexpr (RBG) {
      keys = prm.rbg_keys + static_cast<size_t>(step) * prm.rbg_stride;
      // every thread draws here, a done one too, so a chain's 4-lane group
      // (aligned where the block is a multiple of 4) shares the momentum's
      // Philox calls where N % 4 == 0
      rbg_normals<D>(__ldg(keys), prm.rbg_rows, prm.N, static_cast<uint32_t>(n),
                     prm.N % 4 == 0 && T % 4 == 0, rm);
#pragma unroll
      for (int d = 0; d < D; ++d) rm[d] *= 1.0f / sqrtf(im[d]);
    } else {
      stream.normals<D>(salt, rm);
#pragma unroll
      for (int d = 0; d < D; ++d) rm[d] *= sqrtf(1.0f / im[d]);
    }
    const float ld0 = body_lp(q, gm);
    const float energy0 = -ld0 + kinetic<D>(rm, im);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      zm[d] = q[d];
      zp[d] = q[d];
      rp[d] = rm[d];
      gp[d] = gm[d];
    }
    float lw_traj = -energy0;
    float t_sacc = 0.0f, t_scnt = 0.0f, n_leap = 0.0f;
    bool done = !valid;
    salt += 4u;

    for (int j = 0; j < prm.max_depth; ++j) {
      if (!__syncthreads_or(!done)) break;
      float dir;
      if constexpr (RBG) {
        dir = rbg_uniform(rbg_word(__ldg(keys + 1 + j), nn)) < 0.5f ? 1.0f : -1.0f;
      } else {
        dir = stream.uniform(salt) < 0.5f ? -1.0f : 1.0f;
        salt += 4u;
      }
      const bool fwd = dir > 0.0f;
      const float e = prm.eps * dir;
      const float half_e = 0.5f * e;

      // build the subtree on the end it extends, held in (zp, rp, gp)
      swap_if<D>(!fwd, zm, zp);
      swap_if<D>(!fwd, rm, rp);
      swap_if<D>(!fwd, gm, gp);
#pragma unroll
      for (int d = 0; d < D; ++d) szprop[d] = zp[d];
      float lw_sub = -INFINITY;
      bool s_turn = false, s_div = false;
      float s_sacc = t_sacc, s_scnt = t_scnt;

      const int n_leaves = 1 << j;
      for (int i = 0; i < n_leaves; ++i) {
        const bool active = !(s_turn || s_div || done);
        if (!__syncthreads_or(active)) break;
        float u_leaf;
        if constexpr (RBG) {
          if (!active) continue;
          u_leaf = rbg_uniform(rbg_word(__ldg(keys + 1 + 2 * prm.max_depth + (n_leaves - 1) + i), nn));
        } else {
          u_leaf = stream.uniform(salt);
          salt += 4u;
          if (!active) continue;
        }

#pragma unroll
        for (int d = 0; d < D; ++d) {
          rp[d] = rp[d] + half_e * gp[d];
          zp[d] = zp[d] + e * im[d] * rp[d];
        }
        const float ld_new = body_lp(zp, gp);
        const int bc = __popc(i);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          rp[d] = rp[d] + half_e * gp[d];
          ck_z[(bc * D + d) * T + tid] = zp[d];
          ck_r[(bc * D + d) * T + tid] = rp[d];
        }

        float energy = -ld_new + kinetic<D>(rp, im);
        if (isnan(energy)) energy = INFINITY;
        const float lw_leaf = -energy;
        const bool div_new = energy - energy0 > prm.div_threshold;
        const float lw_new = log_add_exp(lw_sub, lw_leaf);
        if (u_leaf < expf(lw_leaf - lw_new)) {  // NaN never takes
#pragma unroll
          for (int d = 0; d < D; ++d) szprop[d] = zp[d];
        }
        s_sacc += min1(expf(energy0 - energy));
        s_scnt += 1.0f;

        const int ntz1 = __ffs(i + 1) - 1;
        for (int k = 0; k < ntz1; ++k) {
          const int slot = bc - 1 - k;
          float a = 0.0f, b = 0.0f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float dzm = dir * (zp[d] - ck_z[(slot * D + d) * T + tid]) * im[d];
            a += dzm * ck_r[(slot * D + d) * T + tid];
            b += dzm * rp[d];
          }
          if (a < 0.0f || b < 0.0f) s_turn = true;
        }
        lw_sub = lw_new;
        s_div = s_div || div_new;
      }

      const bool sub_ok = !(s_turn || s_div);
      const float p_acc = min1(expf(lw_sub - lw_traj));
      float u;
      if constexpr (RBG) {
        u = rbg_uniform(rbg_word(__ldg(keys + 1 + prm.max_depth + j), nn));
      } else {
        u = stream.uniform(salt);
        salt += 4u;
      }
      if (!done && sub_ok) {
        if (u < p_acc) {
#pragma unroll
          for (int d = 0; d < D; ++d) q[d] = szprop[d];
        }
        lw_traj = log_add_exp(lw_traj, lw_sub);
      }
      swap_if<D>(!fwd, zm, zp);
      swap_if<D>(!fwd, rm, rp);
      swap_if<D>(!fwd, gm, gp);

      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float dzm = (zp[d] - zm[d]) * im[d];
        a += dzm * rm[d];
        b += dzm * rp[d];
      }
      if (!done) {
        n_leap += static_cast<float>(n_leaves);
        t_sacc = s_sacc;
        t_scnt = s_scnt;
      }
      done = done || !sub_ok || a < 0.0f || b < 0.0f;
    }
    acc_sum += t_sacc / fmaxf(t_scnt, 1.0f);
    leap_sum += n_leap;
    salt += 4u;
  }

  if (valid) {
#pragma unroll
    for (int d = 0; d < D; ++d) prm.q_out[static_cast<size_t>(d) * prm.N + n] = q[d];
    prm.accepts[n] = acc_sum;
    prm.leaps[n] = leap_sum;
  }
}

template <int D, int BODY, int NOBS, int DW>
__global__ void NUTS_LAUNCH_BOUNDS
    nuts_sweep_kernel(const __grid_constant__ NutsParams prm,
                      const __grid_constant__ UniformConsts<NOBS, DW> uc) {
  nuts_sweep_impl<D, BODY, NOBS, DW, false>(prm, uc);
}

template <int D, int BODY, int NOBS, int DW>
__global__ void NUTS_LAUNCH_BOUNDS
    nuts_rbg_kernel(const __grid_constant__ NutsParams prm,
                    const __grid_constant__ UniformConsts<NOBS, DW> uc) {
  nuts_sweep_impl<D, BODY, NOBS, DW, true>(prm, uc);
}

// Dynamic shared memory of one block of `chains` chains: the runtime shape's
// constants (or the staged body's, where they fit under the stager's cap),
// then the two checkpoint stacks (max_depth, D, chains).
size_t smem_bytes(int dim, int body, int specialised, int n_obs, int d_w, int max_depth,
                  int chains) {
  const bool shared = body == kHierRegression && !specialised;
  const int consts = shared ? shared_consts_floats(n_obs, d_w)
                            : (body == kStaged ? kStagedSharedFloats : 0);
  return sizeof(float) * (static_cast<size_t>(consts) +
                          2 * static_cast<size_t>(max_depth) * dim * chains);
}

template <int V>
using IC = std::integral_constant<int, V>;

template <int D, class F>
cudaError_t dispatch_body(int body, int specialised, F&& f) {
  if (body == kIidNormal) return f(IC<D>{}, IC<kIidNormal>{}, IC<0>{}, IC<0>{});
  if (body == kHierRegression && !specialised)
    return f(IC<D>{}, IC<kHierRegression>{}, IC<0>{}, IC<0>{});
  if constexpr (D == 16) {
    if (body == kHierRegression && specialised)
      return f(IC<D>{}, IC<kHierRegression>{}, IC<16>{}, IC<8>{});
  }
  return cudaErrorInvalidValue;
}

// Calls f with the kernel instantiation for (dim, body, specialised, rbg) as
// integral constants, or returns cudaErrorInvalidValue. iid_normal has no
// constants and one variant.
template <class F>
cudaError_t dispatch(int dim, int body, int specialised, bool rbg, F&& f) {
#ifdef GJT_STAGED_HEADER
  // a staged build holds the staged body at its own D in its one stream
  // mode, and nothing else
  if (body == kStaged && dim == kStagedD && rbg == kStagedRbg)
    return f(IC<kStagedD>{}, IC<kStaged>{}, IC<0>{}, IC<0>{}, std::bool_constant<kStagedRbg>{});
  return cudaErrorInvalidValue;
#else
  auto g = [&](auto d, auto b, auto no, auto dw) {
    return rbg ? f(d, b, no, dw, std::true_type{}) : f(d, b, no, dw, std::false_type{});
  };
  if (dim == 8) return dispatch_body<8>(body, specialised, g);
  if (dim == 16) return dispatch_body<16>(body, specialised, g);
  return cudaErrorInvalidValue;
#endif
}

// The kernel of an instantiation: nuts_rbg_kernel for the rbg stream.
template <int D, int BODY, int NOBS, int DW, bool RBG>
const void* kernel_ptr() {
  if constexpr (RBG)
    return reinterpret_cast<const void*>(&nuts_rbg_kernel<D, BODY, NOBS, DW>);
  else
    return reinterpret_cast<const void*>(&nuts_sweep_kernel<D, BODY, NOBS, DW>);
}

#define NUTS_KERNEL_PTR(d, b, no, dw, r)                                                  \
  kernel_ptr<decltype(d)::value, decltype(b)::value, decltype(no)::value, decltype(dw)::value, \
             decltype(r)::value>()

}  // namespace

extern "C" {

// The largest dynamic shared memory a block may opt in to on `device`, or -1.
int nuts_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

long nuts_smem_bytes(int dim, int body, int specialised, int n_obs, int d_w, int max_depth,
                     int chains) {
  return static_cast<long>(smem_bytes(dim, body, specialised, n_obs, d_w, max_depth, chains));
}

// Returns the cudaError_t of the launch (0 on success). The block is `chains`
// chains. `consts` is the body's constants in device
// memory and `consts_host` the same on the host (read into the kernel's
// parameters at the specialised shape). `chain` is a staged body's (n_chain,
// N) block of chain operands in device memory, which a build whose header
// takes kChain of them needs (n_chain == kChain), and no other build takes
// (n_chain == 0).
//
// rng is kCounter, kPhilox or kRbg; the rbg stream takes `rbg_keys`, the
// sweep's (n_steps, rbg_stride) keys of four words in device memory
// (rbg_stride = 2 max_depth + 2^max_depth), and `rbg_rows`, the reference's
// row of each launch row (-1: none), (dim,) in device memory.
int nuts_sweep(const float* q_in, float* q_out, float* accepts, float* leaps,
               const float* inv_mass, const float* consts, const float* consts_host,
               int n_consts, int body, int specialised, int dim, int N, int n_obs, int d_w,
               float obs_scale, int n_steps, float eps, float div_threshold, int max_depth,
               int seed, int rng, int chains, const float* chain, int n_chain,
               const void* rbg_keys, int rbg_stride, const int* rbg_rows, void* stream) {
  if (N <= 0 || chains <= 0 || chains > kMaxThreads ||
      n_consts < 0 || n_steps < 0 || max_depth < 1 || max_depth > 30 ||
      (rng != kCounter && rng != kPhilox && rng != kRbg))
    return cudaErrorInvalidValue;
  if (rng == kRbg && ((n_steps > 0 && rbg_keys == nullptr) || rbg_rows == nullptr ||
                      rbg_stride != 2 * max_depth + (1 << max_depth)))
    return cudaErrorInvalidValue;
  if (n_chain != kStagedChain || (n_chain > 0 && chain == nullptr)) return cudaErrorInvalidValue;
  if (body == kHierRegression && (d_w < 1 || d_w + 1 > dim || n_consts != n_obs * (d_w + 1)))
    return cudaErrorInvalidValue;
  if (specialised && body == kHierRegression && (n_obs != 16 || d_w != 8))
    return cudaErrorInvalidValue;
  if (body == kStaged && n_consts != kStagedConsts) return cudaErrorInvalidValue;
  const NutsParams prm{q_in, q_out, accepts, leaps, inv_mass, consts,
                       BodyShape{n_obs, d_w, obs_scale}, N, n_steps, eps, div_threshold,
                       max_depth, static_cast<uint32_t>(seed), rng,
                       static_cast<const uint4*>(rbg_keys), rbg_stride, rbg_rows};
  const size_t smem = smem_bytes(dim, body, specialised, n_obs, d_w, max_depth, chains);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (N + chains - 1) / chains;
  return dispatch(dim, body, specialised, rng == kRbg, [&](auto d, auto b, auto no, auto dw, auto r) {
    const cudaError_t err = cudaFuncSetAttribute(NUTS_KERNEL_PTR(d, b, no, dw, r),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    UniformConsts<decltype(no)::value, decltype(dw)::value> uc{};
    if constexpr (decltype(no)::value > 0) std::memcpy(&uc, consts_host, sizeof(uc));
    if constexpr (decltype(b)::value == kStaged && kStagedParams && kStagedConsts > 0)
      std::memcpy(uc.c, consts_host, sizeof(float) * kStagedConsts);
#ifdef GJT_STAGED_CHAIN
    uc.chain = chain;
#endif
    constexpr int D = decltype(d)::value, B = decltype(b)::value;
    constexpr int NOBS = decltype(no)::value, DW = decltype(dw)::value;
    if constexpr (decltype(r)::value)
      nuts_rbg_kernel<D, B, NOBS, DW><<<blocks, chains, smem, s>>>(prm, uc);
    else
      nuts_sweep_kernel<D, B, NOBS, DW><<<blocks, chains, smem, s>>>(prm, uc);
    return cudaGetLastError();
  });
}

// Registers, local (spill) bytes a thread, and resident blocks an SM of one
// instantiation (the rbg kernel where rbg != 0) at `chains` chains a block:
// out[0..2]. Returns a cudaError_t.
int nuts_kernel_info(int dim, int body, int specialised, int n_obs, int d_w, int max_depth,
                     int chains, int rbg, int* out) {
  const size_t smem = smem_bytes(dim, body, specialised, n_obs, d_w, max_depth, chains);
  return dispatch(dim, body, specialised, rbg != 0, [&](auto d, auto b, auto no, auto dw, auto r) {
    const void* fn = NUTS_KERNEL_PTR(d, b, no, dw, r);
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, chains, smem);
  });
}

}  // extern "C"
