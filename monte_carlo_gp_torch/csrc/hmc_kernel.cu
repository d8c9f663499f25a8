// A whole stage of the Bayesian qualifying model's HMC fit, every chain, in
// one launch, for Hopper (sm_90a).
//
// What it replaces. The JAX fit (monte_carlo_gp_tpu/models/bayesian.py) is one
// compiled program: _leapfrog (:247-259, a lax.fori_loop) and _hmc_transition
// (:262-284) inside _warmup_scan (:287-333, the dual averaging and Welford
// updates) and _sample_chain (:336-360), lax.scans over the transitions,
// vmapped over the chains; XLA computes them and no Pallas kernel is
// involved. The port's plain version is stage_plain with the eager
// transition and the hand-written gradient of make_log_posterior
// (monte_carlo_gp_torch/ops/hmc_kernel.py, models/bayesian.py). Here one block
// runs one chain through a whole warmup or sampling stage: per iteration the
// momentum z / sqrt(inv_mass), the step jitter eps * (0.8 + 0.4 u_jit), the
// leapfrog trajectory with its n_leapfrog + 1 gradients, logp at the
// proposal, both kinetic energies, alpha and the accept against u_acc; in a
// warmup stage the dual-averaging update of the step size and, over the
// stage's second half, the Welford variance; and the trace (theta, lp, the
// step size used, alpha). It draws nothing: z, u_jit and u_acc are inputs.
// The one-transition entry (iters = 1 from a given lp) and the logp entry
// (iters = 0) run the same code.
//
// The statistics form. Every training row has one team, one driver and one
// circuit column, so with A the (N, K) one-hot design and err = A eff - y the
// effects' gradient A^T err = C eff - b and sum(err^2) = eff.(C eff - b) -
// b.eff + y^T y, with C = A^T A (integer co-occurrence counts) and b = A^T y,
// built once per fit on the host. A gradient never reads a row: it is one
// K x K product (K = T + D + C ~ 50) and two K-long sums.
//
// What bounds it. Per transition and chain, ~49 x (2 K^2 + O(K)) ~ 2.6e5
// float64 operations as the product takes them, densely (the work the
// inputs need is about half: C's team x team, driver x driver and circuit x
// circuit blocks are diagonal), and a few hundred bytes of draws and trace:
// under 0.03 us for 4 chains at the card's 34 TFLOP/s float64 rate. Neither
// rate sets the pace: the 49 gradients of a transition, and the transitions
// of a stage, are a chain of dependent steps, so the time is their latency
// (the K x K product's dependent adds, warp 0's update with its shuffle
// trees, and the two barriers between them).
//
// What the design does about it. One block of 4 warps per chain (chains
// are independent, so blocks never wait on each other; one warp per chain,
// synchronised by __syncwarp alone, ran slower on the H100, PERF.md), and a
// whole stage inside the launch, so the host neither launches nor adapts
// between transitions. C (float64, padded with zero rows to 4 equal ranges), the
// effects and the product's range sums live in shared memory; the chain's
// state (theta, its start, p, inv_mass, the gradient, b and the effects of
// the lane's columns, the Welford sums) lives in warp 0's registers, lane L
// holding parameters L, L + 32, ... (S = ceil(dim / 32) of them, a template
// argument), so the update reads no shared memory. Device memory is read for
// C once and for each iteration's draws, and written for the trace. Per
// gradient:
//   1. the product (all warps): effect k's sum over the columns j in 4
//      contiguous ranges, each summed in column order from 0 (warp w takes
//      range w, its lane k effects k and k + 32);                   barrier
//   2. warp 0: colsum_k = ((p0 + p1) + p2) + p3 - b_k and sum(err^2) = the
//      lane sums of eff_k (colsum_k - b_k) (effect k in lane (5 + k) % 32,
//      in order), a fixed butterfly, + y^T y; then the float32 gradient,
//      momentum and position updates, the scales broadcast from lanes 0-4
//      by shuffles, and the next effects into shared memory;        barrier
// Every launch takes a table of fits. A fit's 4 chains fill 4 of the card's
// 132 SMs, and a season's walk-forward fits do not depend on each other, so
// mcgp_hmc_run runs one stage of any number of fits in one launch: a block
// per chain of every fit, each block reading its fit's Args from the table
// in device memory and running the same code (run_chain), so each chain's
// trace and result are bitwise those of a launch of its fit alone. A lone
// fit, the one-transition entry and the logp entry are tables of one. Fits
// of one launch share S, the template argument; the dynamic shared memory
// is the largest fit's.
// Why float64. Near the posterior C eff ~ b to within colsum (|b_k| ~ 10^3,
// |colsum_k| ~ 10), so float32 rounding of each term alone (~10^-4) times
// 1/sigma^2 (up to ~10^3) would move the gradient far outside the plain
// version's tolerance. Each product of a count (an integer below 2^29) and a
// float32 effect is exact in float64, so fma(count, eff, acc) is acc + the
// product rounded once, as the plain version's multiply and add; every sum
// has a fixed order and there are no atomics, so the same inputs give
// bitwise the same outputs on every run. Built with --fmad=false: a*b + c
// stays a multiply and an add.

#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

namespace {

constexpr int kScalars = 5;  // team_mu and the four log-scales lead theta
constexpr int kRanges = 4;   // ops/hmc_kernel.py: RANGES
constexpr int kWarps = 4;    // ops/hmc_kernel.py: WARPS; warp w sums range w
constexpr int kFitPtrs = 20;  // a fit's pointers in mcgp_hmc_run (ops/hmc_kernel.py)
static_assert(kWarps == kRanges, "one warp per range of the product");
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int n, t, d, k, dim;
};

// The four prior precisions 1 / scale^2 (team, driver, circuit, observation).
struct Prior {
  float p0, p1, p2, p3;
};

// One fit's inputs and outputs in a launch (an entry of mcgp_hmc_run's table).
struct Args {
  const double* counts;  // (k, k) C = A^T A, symmetric
  const double* bvec;    // (k,) b = A^T y
  double yty;
  Shape s;
  Prior pr;
  int adapt;                // a warmup stage: dual averaging and Welford
  double t0, gamma, kappa;  // the dual averaging's constants
  float target, log10, var_lo, var_hi;
  const float *theta, *lp, *eps, *inv_mass, *z, *u_jit, *u_acc;
  float *theta_out, *lp_out, *alpha_out, *grad_out, *eps_out, *var_out, *lp0_out;
  float *trace_theta, *trace_lp, *trace_eps, *trace_alpha;
  int chains, iters, n_leapfrog;
};

__device__ __forceinline__ float pick4(int j, float a0, float a1, float a2, float a3) {
  return j == 0 ? a0 : (j == 1 ? a1 : (j == 2 ? a2 : a3));
}

// The sum over the warp's 32 lanes by a fixed butterfly: every lane ends
// with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

// Which scale effect column k takes: 0 team, 1 driver, 2 circuit.
__device__ __forceinline__ int segment(int k, const Shape& s) {
  return k < s.t ? 0 : (k < s.t + s.d ? 1 : 2);
}

// The scalar part of theta as warp 0 reads it.
struct Scales {
  float team_mu, l0, l1, l2, l3, s0, s1, s2, s3, inv_var;

  __device__ __forceinline__ float sig(int j) const { return pick4(j, s0, s1, s2, s3); }
};

// The block's shared memory, float64: C padded with zero rows to kp =
// kRanges * ceil(k / kRanges) (every range of the product has the same width;
// adding 0 * 0 leaves a sum as it is), the effects (kp, zero past k) and the
// product's range sums (kRanges, k).
__device__ __forceinline__ int padded(int k) { return (k + kRanges - 1) / kRanges * kRanges; }

// Dynamic shared memory of one block at k effect columns (ops/hmc_kernel.py:
// shared_bytes).
size_t shared_bytes(int k) {
  const int kp = (k + kRanges - 1) / kRanges * kRanges;
  return (size_t)(kp * k + kp + kRanges * k) * sizeof(double);
}

// The chain's state in warp 0's registers: lane L owns the parameters
// i = L + 32 j, j < S (ops/hmc_kernel.py: SLOTS is the largest S), the effect
// k = i - 5 where i >= 5.
template <int S>
struct Lane {
  float th[S], th0[S], p[S], im[S], g[S], w_mean[S], w_m2[S];
  double b[S], e[S];  // b_k and eff_k of the lane's effects
  int seg[S];         // the effect's scale: 0 team, 1 driver, 2 circuit; -1 a
                      // scalar parameter; -2 past the last parameter
};

// The scalar part of theta, broadcast from lanes 0-4 (warp 0).
template <int S>
__device__ __forceinline__ Scales read_scales(const Lane<S>& L) {
  Scales s;
  s.team_mu = __shfl_sync(kFull, L.th[0], 0);
  s.l0 = __shfl_sync(kFull, L.th[0], 1);
  s.l1 = __shfl_sync(kFull, L.th[0], 2);
  s.l2 = __shfl_sync(kFull, L.th[0], 3);
  s.l3 = __shfl_sync(kFull, L.th[0], 4);
  s.s0 = expf(s.l0);
  s.s1 = expf(s.l1);
  s.s2 = expf(s.l2);
  s.s3 = expf(s.l3);
  s.inv_var = expf(-2.0f * s.l3);
  return s;
}

// eff_k = team_mu * [k is a team column] + raw_k * scale_k, widened to
// float64 into the lane's registers and shared memory (warp 0); returns the
// scales at theta, which the gradient and logp there take.
template <int S>
__device__ __forceinline__ Scales write_effects(Lane<S>& L, double* effd, int lane) {
  const Scales sc = read_scales(L);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (L.seg[j] < 0) continue;
    const float mask = L.seg[j] == 0 ? 1.0f : 0.0f;
    L.e[j] = (double)(sc.team_mu * mask + L.th[j] * sc.sig(L.seg[j]));
    effd[lane + 32 * j - kScalars] = L.e[j];
  }
  return sc;
}

// Step 1 (all warps): part[w][k] = sum over the columns j of range w, in
// column order, of C[j][k] eff_j. A lane takes effects k and k + 32 at once:
// two independent sums.
__device__ __forceinline__ void product(const double* c, const double* effd, double* part,
                                        const Shape& s, int warp, int lane) {
  const int width = padded(s.k) / kRanges;
  const int j0 = warp * width;
  for (int k0 = lane; k0 < s.k; k0 += 64) {
    const bool two = k0 + 32 < s.k;
    const int k1 = two ? k0 + 32 : k0;
    double a0 = 0.0, a1 = 0.0;
#pragma unroll 4
    for (int j = j0; j < j0 + width; ++j) {
      const double e = effd[j];
      const double* row = c + j * s.k;  // C is symmetric: C[j][k] = C[k][j]
      a0 = fma(row[k0], e, a0);
      a1 = fma(row[k1], e, a1);
    }
    double* out = part + warp * s.k;
    out[k0] = a0;
    if (two) out[k1] = a1;
  }
}

// Step 2 (warp 0): from the range sums, colsum = C eff - b in float64 and
// sum(err^2) = sum_k eff_k (colsum_k - b_k) + y^T y, each lane's effects in
// order, then a fixed butterfly, rounded to float32 (every lane returns
// it); and from colsum rounded to float32, d logp / d theta into the lanes'
// g (scales sc).
template <int S>
__device__ __forceinline__ float gradient(Lane<S>& L, const double* part, const Scales& sc,
                                          double yty, const Shape& s, Prior pr, int lane) {
  const float neg_inv_var = -sc.inv_var;
  double t = 0.0;
  float team = 0.0f, seg0 = 0.0f, seg1 = 0.0f, seg2 = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (L.seg[j] < 0) continue;
    const int k = lane + 32 * j - kScalars;
    double v = part[k] + part[s.k + k];
    v = v + part[2 * s.k + k];
    v = v + part[3 * s.k + k];
    v = v - L.b[j];
    t = t + L.e[j] * (v - L.b[j]);
    const float raw = L.th[j];
    const float g_eff = (float)v * neg_inv_var;  // d logp / d effect
    const float gr = g_eff * raw;
    if (L.seg[j] == 0) {
      team = team + g_eff;
      seg0 = seg0 + gr;
    } else if (L.seg[j] == 1) {
      seg1 = seg1 + gr;
    } else {
      seg2 = seg2 + gr;
    }
    L.g[j] = -raw + sc.sig(L.seg[j]) * g_eff;
  }
  const float sq = (float)(warp_sum(t) + yty);
  team = warp_sum(team);
  seg0 = warp_sum(seg0);
  seg1 = warp_sum(seg1);
  seg2 = warp_sum(seg2);
  const float g_obs = sq * sc.inv_var - (float)s.n;
  if (lane == 0) {
    L.g[0] = team - sc.team_mu;
  } else if (lane < kScalars) {
    // the prior's 1 - (sigma / scale)^2, the scale's sum of d logp / d effect
    // * raw, and the likelihood's sum(resid^2) - n for the observation noise
    const int j = lane - 1;
    const float sig = sc.sig(j);
    float v = 1.0f - (sig * sig) * pick4(j, pr.p0, pr.p1, pr.p2, pr.p3);
    v = v + sig * pick4(j, seg0, seg1, seg2, 0.0f);
    L.g[0] = v + g_obs * (j == 3 ? 1.0f : 0.0f);
  }
  return sq;
}

// logp at theta (scales sc) whose rows gave sum(err^2) = sq (warp 0; every
// lane returns it).
template <int S>
__device__ __forceinline__ float log_density(const Lane<S>& L, const Scales& sc, float sq,
                                             const Shape& s, Prior pr) {
  float raw2 = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (L.seg[j] >= 0) raw2 = raw2 + L.th[j] * L.th[j];
  raw2 = warp_sum(raw2);
  float prior = (-0.5f * (sc.s0 * sc.s0)) * pr.p0 + sc.l0;
  prior = prior + ((-0.5f * (sc.s1 * sc.s1)) * pr.p1 + sc.l1);
  prior = prior + ((-0.5f * (sc.s2 * sc.s2)) * pr.p2 + sc.l2);
  prior = prior + ((-0.5f * (sc.s3 * sc.s3)) * pr.p3 + sc.l3);
  float lp = -0.5f * (sc.team_mu * sc.team_mu);
  lp = lp + prior;
  lp = lp - 0.5f * raw2;
  lp = lp - (0.5f * sq) * sc.inv_var;
  return lp - (float)s.n * sc.l3;
}

// 0.5 * sum(p * inv_mass * p) (warp 0; every lane returns it).
template <int S>
__device__ __forceinline__ float kinetic(const Lane<S>& L) {
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (L.seg[j] > -2) v = v + (L.p[j] * L.im[j]) * L.p[j];
  return 0.5f * warp_sum(v);
}

// Chain `chain` of the fit `a` in this block of kWarps warps, S parameters
// per lane of warp 0; see mcgp_hmc_run for the modes. The block's dynamic
// shared memory holds at least shared_bytes(a.s.k).
template <int S>
__device__ __forceinline__ void run_chain(const Args& a, const int chain) {
  extern __shared__ double smem[];
  const Shape s = a.s;
  const int kp = padded(s.k);
  double* c = smem;            // (kp, k) the counts, zero rows past k
  double* effd = c + kp * s.k;  // (kp,) the effects, zero past k
  double* part = effd + kp;     // (kRanges, k) the product's range sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lead = warp == 0;  // warp 0 keeps and updates the chain's state
  const size_t base = (size_t)chain * s.dim;
  const bool adapt = a.adapt != 0;

  for (int i = threadIdx.x; i < kp * s.k; i += kWarps * 32) c[i] = i < s.k * s.k ? a.counts[i] : 0.0;
  for (int i = threadIdx.x; i < kp; i += kWarps * 32) effd[i] = 0.0;
  Lane<S> L;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int i = lane + 32 * j, k = i - kScalars;
    L.seg[j] = i >= s.dim ? -2 : (k < 0 ? -1 : segment(k, s));
    L.th[j] = L.im[j] = L.w_mean[j] = L.w_m2[j] = 0.0f;
    L.b[j] = 0.0;
    if (!lead || L.seg[j] == -2) continue;
    L.th[j] = a.theta[base + i];
    if (a.iters > 0) L.im[j] = a.inv_mass[base + i];
    if (k >= 0) L.b[j] = a.bvec[k];
  }
  __syncthreads();

  // logp at the starting theta (and its gradient for the logp entry),
  // unless the one-transition entry was given it
  float lp = 0.0f;
  Scales sc;  // warp 0: the scales at the position the effects were formed at
  if (a.lp == nullptr) {
    if (lead) sc = write_effects(L, effd, lane);
    __syncthreads();
    product(c, effd, part, s, warp, lane);
    __syncthreads();
    if (lead) {
      const float sq = gradient(L, part, sc, a.yty, s, a.pr, lane);
      lp = log_density(L, sc, sq, s, a.pr);
      if (a.grad_out != nullptr) {
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (L.seg[j] > -2) a.grad_out[base + lane + 32 * j] = L.g[j];
      }
      if (lane == 0 && a.iters == 0) a.lp_out[chain] = lp;
      if (lane == 0 && a.lp0_out != nullptr) a.lp0_out[chain] = lp;
    }
    if (a.iters == 0) return;
  } else if (lead) {
    lp = a.lp[chain];
  }

  // the dual averaging's state (warp 0, the same in every lane)
  float log_eps = 0.0f, mu = 0.0f, h_bar = 0.0f, log_eps_bar = 0.0f, alpha_sum = 0.0f;
  int w_n = 0;
  const int half_iters = a.iters / 2;
  if (adapt && lead) {
    log_eps = logf(a.eps[chain]);
    mu = a.log10 + log_eps;
    log_eps_bar = log_eps;
  }

  for (int it = 0; it < a.iters; ++it) {
    const size_t row = (size_t)it * a.chains + chain;  // this iteration's draws
    float eps_used = 0.0f, eps = 0.0f, half = 0.0f, ke0 = 0.0f, sq = 0.0f;
    if (lead) {
      eps_used = adapt ? expf(log_eps) : a.eps[chain];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (L.seg[j] == -2) continue;
        L.th0[j] = L.th[j];
        // p ~ N(0, M), M = 1 / inv_mass
        L.p[j] = a.z[row * s.dim + lane + 32 * j] / sqrtf(L.im[j]);
      }
      eps = eps_used * (0.8f + 0.4f * a.u_jit[row]);
      half = 0.5f * eps;
      ke0 = kinetic(L);
      sc = write_effects(L, effd, lane);
    }
    for (int step = 0; step <= a.n_leapfrog; ++step) {
      __syncthreads();
      product(c, effd, part, s, warp, lane);
      __syncthreads();
      if (lead) {
        sq = gradient(L, part, sc, a.yty, s, a.pr, lane);
        // p += eps g (half steps at both ends); then, but after the last
        // gradient, theta += eps inv_mass p and the effects at the new theta
        const bool last = step == a.n_leapfrog;
        const float coef = (step == 0 || last) ? half : eps;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (L.seg[j] == -2) continue;
          const float pi = L.p[j] + coef * L.g[j];
          L.p[j] = pi;
          if (!last) L.th[j] = L.th[j] + (eps * L.im[j]) * pi;
        }
        if (!last) sc = write_effects(L, effd, lane);
      }
    }
    if (!lead) continue;

    const float lp_new = log_density(L, sc, sq, s, a.pr);
    const float ke_new = kinetic(L);
    const float log_alpha = (lp_new - ke_new) - (lp - ke0);
    const float alpha = isfinite(log_alpha) ? fminf(expf(log_alpha), 1.0f) : 0.0f;
    const bool accept = a.u_acc[row] < alpha;
    lp = accept ? lp_new : lp;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (L.seg[j] == -2) continue;
      if (!accept) L.th[j] = L.th0[j];
      if (a.trace_theta != nullptr) a.trace_theta[row * s.dim + lane + 32 * j] = L.th[j];
    }
    if (a.trace_theta != nullptr && lane == 0) {
      a.trace_lp[row] = lp;
      a.trace_eps[row] = eps_used;
      a.trace_alpha[row] = alpha;
    }
    alpha_sum = alpha_sum + alpha;
    if (adapt) {
      // ops/hmc_kernel.py: Adaptation.update. Its Python scalars are computed
      // in double and rounded to float32, as PyTorch rounds a Python scalar
      // it multiplies a float32 tensor by.
      const double m = it + 1.0, w = pow(m, -a.kappa);
      h_bar = (float)(1.0 - 1.0 / (m + a.t0)) * h_bar + (a.target - alpha) / (float)(m + a.t0);
      log_eps = mu - (float)(sqrt(m) / a.gamma) * h_bar;
      log_eps_bar = (float)w * log_eps + (float)(1.0 - w) * log_eps_bar;
      if (it >= half_iters) {  // Welford over the stage's second half
        ++w_n;
        const float fn = (float)w_n;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const float x = L.th[j];
          const float delta = x - L.w_mean[j];
          const float mean = L.w_mean[j] + delta / fn;
          L.w_mean[j] = mean;
          L.w_m2[j] = L.w_m2[j] + delta * (x - mean);
        }
      }
    }
  }

  if (!lead) return;
  if (lane == 0) {
    a.lp_out[chain] = lp;
    a.alpha_out[chain] = alpha_sum / (float)a.iters;
  }
  if (adapt && lane == 0) a.eps_out[chain] = expf(log_eps_bar);
  const float denom = (float)(w_n - 1);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (L.seg[j] == -2) continue;
    const size_t i = base + lane + 32 * j;
    a.theta_out[i] = L.th[j];
    if (adapt) a.var_out[i] = fminf(fmaxf(w_n > 1 ? L.w_m2[j] / denom : 1.0f, a.var_lo), a.var_hi);
  }
}

// One stage of the fits of one S: fits[f] is fit f's Args, its chains the
// blocks after those of fits 0..f-1, each block running its own fit's
// design, state, draws and trace.
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
    hmc_kernel(const Args* __restrict__ fits, const int n_fits) {
  int f = 0, first = 0;
  while (f + 1 < n_fits && (int)blockIdx.x >= first + fits[f].chains) first += fits[f++].chains;
  run_chain<S>(fits[f], (int)blockIdx.x - first);
}

// One launch of hmc_kernel<S> over n_fits fits whose Args are at `fits` in
// device memory, with `blocks` chains in all; `smem` the largest fit's shared
// memory.
template <int S>
cudaError_t launch(const Args* fits, int n_fits, int blocks, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hmc_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  hmc_kernel<S><<<blocks, kWarps * 32, smem, stream>>>(fits, n_fits);
  return cudaGetLastError();
}

template <int S>
int blocks_per_sm(int k) {
  const size_t smem = shared_bytes(k);
  int blocks = 0;
  if (cudaFuncSetAttribute(hmc_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, hmc_kernel<S>, kWarps * 32, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// The kernel of S = ceil(dim / 32) parameters per lane, applied to f:
// f.template operator()<S>(), or `fail` past the largest S.
template <typename F, typename R>
R by_slots(int dim, F f, R fail) {
  switch ((dim + 31) / 32) {
    case 1: return f.template operator()<1>();
    case 2: return f.template operator()<2>();
    case 3: return f.template operator()<3>();
    case 4: return f.template operator()<4>();
    case 5: return f.template operator()<5>();
    case 6: return f.template operator()<6>();
    default: return fail;
  }
}

struct LaunchOp {
  const Args* fits;
  int n_fits, blocks;
  size_t smem;
  cudaStream_t stream;
  template <int S>
  cudaError_t operator()() const { return launch<S>(fits, n_fits, blocks, smem, stream); }
};

struct QueryOp {
  int k;
  template <int S>
  int operator()() const { return blocks_per_sm<S>(k); }
};

// The Args of one fit (an entry of mcgp_hmc_run's table), or the error
// that refuses them.
cudaError_t fill_args(Args& a, const double* counts, const double* bvec, double yty, int n, int t,
                      int d, int c, float prec0, float prec1, float prec2, float prec3, int adapt,
                      double t0, double gamma, double kappa, float target, float log10,
                      float var_lo, float var_hi, const float* theta, const float* lp,
                      const float* eps, const float* inv_mass, const float* z, const float* u_jit,
                      const float* u_acc, float* theta_out, float* lp_out, float* alpha_out,
                      float* grad_out, float* eps_out, float* var_out, float* lp0_out,
                      float* trace_theta, float* trace_lp, float* trace_eps, float* trace_alpha,
                      int chains, int iters, int n_leapfrog) {
  if (n < 0 || t < 1 || d < 0 || c < 0 || chains < 1 || chains > 65535 || iters < 0 ||
      n_leapfrog < 0 || lp_out == nullptr)
    return cudaErrorInvalidValue;
  if (iters > 0 && (eps == nullptr || inv_mass == nullptr || z == nullptr || u_jit == nullptr ||
                    u_acc == nullptr || theta_out == nullptr || alpha_out == nullptr ||
                    n_leapfrog < 1))
    return cudaErrorInvalidValue;
  if (adapt && (iters < 1 || eps_out == nullptr || var_out == nullptr))
    return cudaErrorInvalidValue;
  if (trace_theta != nullptr && (trace_lp == nullptr || trace_eps == nullptr ||
                                 trace_alpha == nullptr))
    return cudaErrorInvalidValue;
  const int k = t + d + c;
  a.counts = counts;
  a.bvec = bvec;
  a.yty = yty;
  a.s = Shape{n, t, d, k, kScalars + k};
  a.pr = Prior{prec0, prec1, prec2, prec3};
  a.adapt = adapt;
  a.t0 = t0;
  a.gamma = gamma;
  a.kappa = kappa;
  a.target = target;
  a.log10 = log10;
  a.var_lo = var_lo;
  a.var_hi = var_hi;
  a.theta = theta;
  a.lp = lp;
  a.eps = eps;
  a.inv_mass = inv_mass;
  a.z = z;
  a.u_jit = u_jit;
  a.u_acc = u_acc;
  a.theta_out = theta_out;
  a.lp_out = lp_out;
  a.alpha_out = alpha_out;
  a.grad_out = grad_out;
  a.eps_out = eps_out;
  a.var_out = var_out;
  a.lp0_out = lp0_out;
  a.trace_theta = trace_theta;
  a.trace_lp = trace_lp;
  a.trace_eps = trace_eps;
  a.trace_alpha = trace_alpha;
  a.chains = chains;
  a.iters = iters;
  a.n_leapfrog = n_leapfrog;
  return cudaSuccess;
}

}  // namespace

// The most dynamic shared memory a block may opt in to on the current
// device; -1 on a CUDA error.
extern "C" int mcgp_hmc_max_shared_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return bytes;
}

// How many blocks fit on one SM at once at k effect columns; -1 on a CUDA
// error or more columns than the library holds.
extern "C" int mcgp_hmc_blocks_per_sm(int k) {
  return by_slots(kScalars + k, QueryOp{k}, -1);
}

// The bytes of one fit's entry in mcgp_hmc_run's table.
extern "C" int mcgp_hmc_args_bytes() { return (int)sizeof(Args); }

// One stage of n_fits fits of the same S = ceil((5 + k) / 32) in one launch,
// one block of 32 * kWarps threads per chain of every fit. Per fit f:
// ptrs[kFitPtrs f ...] its device pointers (counts, bvec, theta, lp, eps,
// inv_mass, z, u_jit, u_acc, theta_out, lp_out, alpha_out, grad_out, eps_out,
// var_out, lp0_out, trace_theta, trace_lp, trace_eps, trace_alpha; 0 for
// null), sizes[5 f ...] its n, t, d, c and chains, yty[f], and prec[4 f ...]
// its four prior precisions: counts (k, k) and bvec (k,) float64 with k = t +
// d + c, yty and n the rows' y^T y and count; the state tensors float32:
// theta, inv_mass (chains, 5 + k), lp, eps (chains,); z (iters, chains, 5 +
// k), u_jit and u_acc (iters, chains). The stage's other arguments are every
// fit's. The modes:
//   * iters = 0: logp at theta into lp_out and, when grad_out is not null,
//     its gradient (chains, 5 + k) into grad_out;
//   * iters >= 1: the chains' transitions from theta, at lp when it is not
//     null, else at logp(theta), written to lp0_out when it is not null;
//     with adapt a warmup stage (the step size dual-averaged from eps with
//     the constants t0, gamma and kappa; eps_out its final exp(log_eps_bar),
//     var_out the clamped Welford variance), without, every transition at
//     eps; theta_out, lp_out the final state, alpha_out the mean alpha; when
//     trace_theta is not null the trace, per iteration theta (iters, chains,
//     5 + k), lp, the step size used and alpha (iters, chains).
// `table`: device memory of n_fits * mcgp_hmc_args_bytes() bytes, which this
// fills on the stream and the launch reads, so it must stay allocated until
// the launch has run. Returns the first refusal of a fit
// (cudaErrorInvalidValue, also for fits of different S) or CUDA error of the
// copy, the opt-in and the launch.
extern "C" int mcgp_hmc_run(int n_fits, const unsigned long long* ptrs, const int* sizes,
                            const double* yty, const float* prec, int adapt, double t0,
                            double gamma, double kappa, float target, float log10, float var_lo,
                            float var_hi, int iters, int n_leapfrog, void* table, void* stream) {
  if (n_fits < 1 || table == nullptr) return (int)cudaErrorInvalidValue;
  std::vector<Args> fits(n_fits);
  long long blocks = 0;
  size_t smem = 0;
  for (int f = 0; f < n_fits; ++f) {
    const unsigned long long* p = ptrs + (size_t)kFitPtrs * f;
    const int* sz = sizes + 5 * f;
    auto in = [p](int i) { return reinterpret_cast<const float*>(p[i]); };
    auto out = [p](int i) { return reinterpret_cast<float*>(p[i]); };
    const cudaError_t err = fill_args(
        fits[f], reinterpret_cast<const double*>(p[0]), reinterpret_cast<const double*>(p[1]),
        yty[f], sz[0], sz[1], sz[2], sz[3], prec[4 * f], prec[4 * f + 1], prec[4 * f + 2],
        prec[4 * f + 3], adapt, t0, gamma, kappa, target, log10, var_lo, var_hi, in(2), in(3),
        in(4), in(5), in(6), in(7), in(8), out(9), out(10), out(11), out(12), out(13), out(14),
        out(15), out(16), out(17), out(18), out(19), sz[4], iters, n_leapfrog);
    if (err != cudaSuccess) return (int)err;
    if ((fits[f].s.dim + 31) / 32 != (fits[0].s.dim + 31) / 32) return (int)cudaErrorInvalidValue;
    blocks += fits[f].chains;
    smem = std::max(smem, shared_bytes(fits[f].s.k));
  }
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // pageable host memory: the call returns once the table is staged, so
  // `fits` may go when it returns
  cudaError_t err = cudaMemcpyAsync(table, fits.data(), sizeof(Args) * n_fits,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const LaunchOp op{static_cast<const Args*>(table), n_fits, (int)blocks, smem, st};
  return (int)by_slots(fits[0].s.dim, op, cudaErrorInvalidValue);
}
