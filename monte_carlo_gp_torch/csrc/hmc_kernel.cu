// One whole HMC transition of every chain of the Bayesian qualifying model
// in one launch, for Hopper (sm_90a).
//
// What it replaces. The JAX fit (monte_carlo_gp_tpu/models/bayesian.py) is one
// compiled program: its _leapfrog (:247-259, a lax.fori_loop) and
// _hmc_transition (:262-284) run inside lax.scans over the transitions,
// vmapped over the chains, and XLA computes them; no Pallas kernel is
// involved. The port's plain version is _hmc_transition with the hand-written
// gradient of make_log_posterior (monte_carlo_gp_torch/ops/hmc_kernel.py::
// hmc_transition_plain, models/bayesian.py), about 1,550 small launches per
// transition. Here one block runs one chain through all of it: the momentum
// z / sqrt(inv_mass), the step jitter eps * (0.8 + 0.4 u_jit), the leapfrog
// trajectory with its n_leapfrog + 1 gradients in the plain version's order
// of operations, logp at the proposal, both kinetic energies, alpha and the
// accept against u_acc. It draws nothing: z, u_jit and u_acc are inputs. With
// n_leapfrog = 0 it computes logp (and, given grad_out, the gradient) at theta
// alone: each warmup stage's starting logp, so every lp of a card fit has the
// same summation order.
//
// What bounds it. Per transition and chain the work is n_leapfrog + 1 passes
// over the N training rows (N ~ 5,100: three gathers and a few adds per row,
// then each row's residual summed into its three effect columns) and a
// 5 + K parameter update (K ~ 50): about 2·10^6 float32 operations a chain,
// 0.12 µs for 4 chains at 67 TFLOP/s, and ~0.14 MB of design read once,
// 0.04 µs at 3.35 TB/s. Neither sets the pace: the 49 gradients are a chain of
// dependent block-wide reductions, so the time is their latency (shared-memory
// and L1 round trips and three __syncthreads per gradient).
//
// What the design does about it. One block of 1,024 threads per chain
// (chains are independent, so blocks never wait on each other), and the whole
// trajectory inside the launch: the state (theta, p, inv_mass, the gradient),
// the effects and every row's residual stay in shared memory; only the design
// (16 B a row, and the column lists) is read from device memory, from L1/L2
// after the first gradient. Per gradient:
//   1. every thread forms err_i = eff[t_i] + eff[T+d_i] + eff[T+D+c_i] - y_i
//      for rows i = tid, tid + 1024, ..., keeps it in shared memory, and sums
//      err_i^2 in that order; a fixed shuffle tree per warp, then one over the
//      32 warp partials, gives sum(err^2);                       __syncthreads
//   2. warp w sums the residuals of effect columns w, w + 32, ... over the
//      column's rows (a CSR list built once per fit, in row order), each lane
//      strided by 32, then a fixed __shfl_xor tree;              __syncthreads
//   3. warp 0 forms the 5 + K gradient, the momentum and position updates and
//      the next effects.                                         __syncthreads
// Every sum has a fixed order and there are no float atomics, so the same
// inputs give bitwise the same outputs on every run. Built with --fmad=false:
// a*b + c stays a multiply and an add, as in the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // ops/hmc_kernel.py: THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kScalars = 5;  // team_mu and the four log-scales lead theta
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int n, t, d, k, dim;
};

// The four prior precisions 1 / scale^2 (team, driver, circuit, observation).
struct Prior {
  float p0, p1, p2, p3;
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

// Which scale effect column k takes: 0 team, 1 driver, 2 circuit.
__device__ __forceinline__ int segment(int k, const Shape& s) {
  return k < s.t ? 0 : (k < s.t + s.d ? 1 : 2);
}

// The scalar part of theta as warp 0 reads it.
struct Scales {
  float team_mu, l0, l1, l2, l3, s0, s1, s2, s3, inv_var;

  __device__ __forceinline__ float sig(int j) const { return pick4(j, s0, s1, s2, s3); }
};

__device__ __forceinline__ Scales read_scales(const float* th) {
  Scales s;
  s.team_mu = th[0];
  s.l0 = th[1];
  s.l1 = th[2];
  s.l2 = th[3];
  s.l3 = th[4];
  s.s0 = expf(s.l0);
  s.s1 = expf(s.l1);
  s.s2 = expf(s.l2);
  s.s3 = expf(s.l3);
  s.inv_var = expf(-2.0f * s.l3);
  return s;
}

// eff_k = team_mu * [k is a team column] + raw_k * scale_k (warp 0).
__device__ __forceinline__ void write_effects(const float* th, float* eff, const Shape& s,
                                              int lane) {
  const Scales sc = read_scales(th);
  for (int k = lane; k < s.k; k += 32) {
    const int seg = segment(k, s);
    const float mask = seg == 0 ? 1.0f : 0.0f;
    eff[k] = sc.team_mu * mask + th[kScalars + k] * sc.sig(seg);
  }
}

// Step 1: every row's residual into err, and each warp's sum of its threads'
// err^2 (each thread's rows in row order) into warp_sq.
__device__ __forceinline__ void row_pass(const int4* __restrict__ rows, const float* eff,
                                         float* err, float* warp_sq, int n) {
  float sq = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int4 r = __ldg(rows + i);
    float e = eff[r.x] + eff[r.y];
    e = e + eff[r.z];
    e = e + __int_as_float(r.w);
    err[i] = e;
    sq = sq + e * e;
  }
  sq = warp_sum(sq);
  if ((threadIdx.x & 31) == 0) warp_sq[threadIdx.x >> 5] = sq;
}

// Step 2: each effect column's sum of its rows' residuals into colsum.
__device__ __forceinline__ void column_pass(const int* __restrict__ col_start,
                                            const int* __restrict__ col_rows, const float* err,
                                            float* colsum, int k_cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < k_cols; k += kWarps) {
    const int end = __ldg(col_start + k + 1);
    float v = 0.0f;
    for (int j = __ldg(col_start + k) + lane; j < end; j += 32) v = v + err[__ldg(col_rows + j)];
    v = warp_sum(v);
    if (lane == 0) colsum[k] = v;
  }
}

// Step 3's gradient (warp 0): d logp / d theta into g, from the column sums
// and sum(err^2) at the state th.
__device__ __forceinline__ void gradient(const float* th, const float* colsum, float sq, float* g,
                                         const Shape& s, Prior pr, int lane) {
  const Scales sc = read_scales(th);
  const float neg_inv_var = -sc.inv_var;
  float team = 0.0f, seg0 = 0.0f, seg1 = 0.0f, seg2 = 0.0f;
  for (int k = lane; k < s.k; k += 32) {
    const int seg = segment(k, s);
    const float raw = th[kScalars + k];
    const float g_eff = colsum[k] * neg_inv_var;  // d logp / d effect
    const float gr = g_eff * raw;
    if (seg == 0) {
      team = team + g_eff;
      seg0 = seg0 + gr;
    } else if (seg == 1) {
      seg1 = seg1 + gr;
    } else {
      seg2 = seg2 + gr;
    }
    g[kScalars + k] = -raw + sc.sig(seg) * g_eff;
  }
  team = warp_sum(team);
  seg0 = warp_sum(seg0);
  seg1 = warp_sum(seg1);
  seg2 = warp_sum(seg2);
  const float g_obs = sq * sc.inv_var - (float)s.n;
  if (lane == 0) {
    g[0] = team - sc.team_mu;
  } else if (lane < kScalars) {
    // the prior's 1 - (sigma / scale)^2, the scale's sum of d logp / d effect
    // * raw, and the likelihood's sum(resid^2) - n for the observation noise
    const int j = lane - 1;
    const float sig = sc.sig(j);
    float v = 1.0f - (sig * sig) * pick4(j, pr.p0, pr.p1, pr.p2, pr.p3);
    v = v + sig * pick4(j, seg0, seg1, seg2, 0.0f);
    g[lane] = v + g_obs * (j == 3 ? 1.0f : 0.0f);
  }
}

// logp at the state th whose rows gave sum(err^2) = sq (warp 0; every lane
// returns it).
__device__ __forceinline__ float log_density(const float* th, float sq, const Shape& s,
                                             Prior pr, int lane) {
  const Scales sc = read_scales(th);
  float raw2 = 0.0f;
  for (int k = lane; k < s.k; k += 32) {
    const float r = th[kScalars + k];
    raw2 = raw2 + r * r;
  }
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
__device__ __forceinline__ float kinetic(const float* p, const float* im, int dim, int lane) {
  float v = 0.0f;
  for (int i = lane; i < dim; i += 32) {
    const float pi = p[i];
    v = v + (pi * im[i]) * pi;
  }
  return 0.5f * warp_sum(v);
}

// theta (chains, dim) etc. as in ops/hmc_kernel.py::hmc_transition; one block
// per chain. n_leapfrog = 0: lp_out = logp(theta) and, when grad_out is not
// null, grad_out = its gradient; the other pointers are not read.
__global__ void __launch_bounds__(kThreads)
    hmc_kernel(const int4* __restrict__ rows, const int* __restrict__ col_start,
               const int* __restrict__ col_rows, int n, int t, int d, int c, Prior pr,
               const float* __restrict__ theta_in, const float* __restrict__ lp_in,
               const float* __restrict__ eps_in, const float* __restrict__ inv_mass_in,
               const float* __restrict__ z_in, const float* __restrict__ u_jit_in,
               const float* __restrict__ u_acc_in, float* __restrict__ theta_out,
               float* __restrict__ lp_out, float* __restrict__ alpha_out,
               float* __restrict__ grad_out, int n_leapfrog) {
  extern __shared__ float smem[];
  const Shape s{n, t, d, t + d + c, kScalars + t + d + c};
  float* th = smem;             // the position
  float* th0 = th + s.dim;      // the chain's state, for a rejection
  float* p = th0 + s.dim;       // the momentum
  float* im = p + s.dim;        // inv_mass
  float* g = im + s.dim;        // the gradient
  float* eff = g + s.dim;       // (K,) effects
  float* colsum = eff + s.k;    // (K,) residual sums per effect column
  float* warp_sq = colsum + s.k;  // (32,) warp partials of sum(err^2)
  float* err = warp_sq + kWarps;  // (N,) residuals

  const bool move = n_leapfrog > 0;
  const bool want_grad = move || grad_out != nullptr;
  const int lane = threadIdx.x & 31;
  const bool lead = threadIdx.x < 32;  // warp 0 updates the state
  const size_t base = (size_t)blockIdx.x * s.dim;

  for (int i = threadIdx.x; i < s.dim; i += kThreads) {
    const float v = theta_in[base + i];
    th[i] = v;
    th0[i] = v;
    if (move) {
      const float m = inv_mass_in[base + i];
      im[i] = m;
      p[i] = z_in[base + i] / sqrtf(m);  // p ~ N(0, M), M = 1 / inv_mass
    }
  }
  __syncthreads();
  float eps = 0.0f, half = 0.0f, ke0 = 0.0f;
  if (lead) {
    if (move) {
      eps = eps_in[blockIdx.x] * (0.8f + 0.4f * u_jit_in[blockIdx.x]);
      half = 0.5f * eps;
      ke0 = kinetic(p, im, s.dim, lane);
    }
    write_effects(th, eff, s, lane);
  }
  __syncthreads();

  float sq = 0.0f;
  const int n_grads = move ? n_leapfrog + 1 : 1;
  for (int step = 0; step < n_grads; ++step) {
    row_pass(rows, eff, err, warp_sq, s.n);
    __syncthreads();
    if (want_grad) {
      column_pass(col_start, col_rows, err, colsum, s.k);
      __syncthreads();
    }
    if (lead) {
      sq = warp_sum(warp_sq[lane]);
      if (want_grad) {
        gradient(th, colsum, sq, g, s, pr, lane);
        __syncwarp();
      }
      if (move) {
        // p += eps g (half steps at both ends); then, but after the last
        // gradient, theta += eps inv_mass p and the effects at the new theta
        const bool last = step == n_leapfrog;
        const float coef = (step == 0 || last) ? half : eps;
        for (int i = lane; i < s.dim; i += 32) {
          const float pi = p[i] + coef * g[i];
          p[i] = pi;
          if (!last) th[i] = th[i] + (eps * im[i]) * pi;
        }
        __syncwarp();
        if (!last) write_effects(th, eff, s, lane);
      }
    }
    __syncthreads();
  }

  if (!lead) return;
  const float lp_new = log_density(th, sq, s, pr, lane);
  if (!move) {
    if (lane == 0) lp_out[blockIdx.x] = lp_new;
    if (grad_out != nullptr)
      for (int i = lane; i < s.dim; i += 32) grad_out[base + i] = g[i];
    return;
  }
  const float ke_new = kinetic(p, im, s.dim, lane);
  const float lp0 = lp_in[blockIdx.x];
  const float log_alpha = (lp_new - ke_new) - (lp0 - ke0);
  const float alpha = isfinite(log_alpha) ? fminf(expf(log_alpha), 1.0f) : 0.0f;
  const bool accept = u_acc_in[blockIdx.x] < alpha;
  for (int i = lane; i < s.dim; i += 32) theta_out[base + i] = accept ? th[i] : th0[i];
  if (lane == 0) {
    lp_out[blockIdx.x] = accept ? lp_new : lp0;
    alpha_out[blockIdx.x] = alpha;
  }
}

// Dynamic shared memory a block takes for n rows and k effect columns
// (ops/hmc_kernel.py: shared_bytes).
size_t shared_bytes(int n, int k) {
  return (size_t)(5 * (kScalars + k) + 2 * k + kWarps + n) * sizeof(float);
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

// How many blocks fit on one SM at once for n rows and k effect columns;
// -1 on a CUDA error.
extern "C" int mcgp_hmc_blocks_per_sm(int n, int k) {
  const size_t smem = shared_bytes(n, k);
  int blocks = 0;
  if (cudaFuncSetAttribute(hmc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, hmc_kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// rows (n, 4) int32: each row's three effect columns and -y as float32 bits;
// col_start (k + 1,) and col_rows (3n,) int32: each column's rows in row
// order; the state tensors float32 (chains, 5 + k) or (chains,). One block per
// chain. Returns the first CUDA error of the shared-memory opt-in and the
// launch.
extern "C" int mcgp_hmc_run(const int* rows, const int* col_start, const int* col_rows, int n,
                            int t, int d, int c, float prec0, float prec1, float prec2,
                            float prec3, const float* theta, const float* lp, const float* eps,
                            const float* inv_mass, const float* z, const float* u_jit,
                            const float* u_acc, float* theta_out, float* lp_out,
                            float* alpha_out, float* grad_out, int chains, int n_leapfrog,
                            void* stream) {
  if (n < 1 || t < 1 || d < 0 || c < 0 || chains < 1 || chains > 65535 || n_leapfrog < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(n, t + d + c);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(hmc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Prior pr{prec0, prec1, prec2, prec3};
  hmc_kernel<<<chains, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(rows), col_start, col_rows, n, t, d, c, pr, theta, lp, eps,
      inv_mass, z, u_jit, u_acc, theta_out, lp_out, alpha_out, grad_out, n_leapfrog);
  return (int)cudaGetLastError();
}
