// The whole-race Monte Carlo kernels for Hopper (sm_90a).
//
// K1, race_kernel, replaces monte_carlo_gp_tpu/ops/pallas_engine.py::_race_kernel
// (the Pallas TPU kernel body) in its single-race launch, _pallas_counts_one
// (pallas_engine.py:838). K2, season_kernel, replaces the same body with
// season=True in its race-batched launch, _pallas_counts_season_one
// (pallas_engine.py:895): every race of a season in one launch. Both run one
// block body, race_block, as the Pallas launches run one kernel body.
// Each simulation runs one whole race
// -- Gumbel-max grid, lap-1 start model, laps 2..race_laps (race control,
// dirty air, DNF, lap time, pits, three overtake passes, DRS) and the
// classification -- and adds its finishing order to a (D, D) [driver,
// position] int32 histogram. The plain PyTorch version of the same function
// is monte_carlo_gp_torch/ops/race_kernel.py::race_counts_plain; both follow
// the Pallas body operation for operation in float32 (this file is built
// with --fmad=false so that no multiply-add is contracted) and draw from the
// same Philox4x32-10 stream (ops/philox.py).
//
// What bounds it: not bytes. Per simulation it reads about 1 KB of
// parameters (a (D, 8) matrix, 25 scalars, a (D, D) grid table, all cached)
// and writes nothing but shared-memory atomics. The work is a few thousand
// integer compares, shuffles, selects and Philox rounds per lap, so the
// kernel is bound by instruction issue.
//
// What the design does about it: one warp per simulation, one car per lane
// (D <= 32). The car state (~16 values) stays in registers for the whole
// race. Every O(D^2) rank of the TPU kernel becomes D shuffles and compares
// per lane; the sublane gathers become __shfl_sync; the inverse permutation
// goes through 32 ints of shared memory per warp; the overtake chain's
// prefix max is a log2(D) __shfl_up_sync scan; the leader min and the pick
// of the leader's row are warp reductions and ballots. No lane ever waits on
// memory inside the race. Warps loop over simulations with a grid stride
// and the block's histogram lives in shared memory, so global atomics run
// once per block, not once per simulation. Integer atomics keep the counts
// bitwise deterministic, and the Philox counter is (global sim index, draw
// block, row), so the counts do not depend on the launch shape.
//
// K2 is bound the same way, by instruction issue. Its grid is 2-D,
// (blocks_per_race, R): row r of blocks reads race r's parameters, scalars,
// grid table, lap count and key words, and adds into race r's histogram.
// A season's races are uneven (44 to 78 laps in the synthetic 2024 season):
// each block's lap loop runs to its own race's lap count, so a short race
// costs only its own laps, and the wrapper gives each race the single-race
// launch's grid (1,056 blocks of 8 warps on 132 SMs), so the season holds
// many times more short blocks than the SMs take at once: the SMs that
// finish a short race's blocks early take queued blocks of other races
// instead of idling through a ragged tail of long blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDrivers = 32;
constexpr int kIKeyBase = 0x3E800000;  // int view of 0.25f
constexpr int kDnfKey = 2100000000;
// D <= 32: cum quantized to 4 ULP, 32 rows per quantum (the Pallas tier).
constexpr int kQShift = 2;
constexpr int kRowMult = 32;

// scalar pack layout (ops/race_kernel.py)
enum {
  PIT_LOSS, OVERTAKE_DELTA, DRS_DELTA, SC_P, VSC_P, RED_P, DIRTY_THRESH,
  DIRTY_PEN, TRACK_COND, CPACE0, CDEG0 = CPACE0 + 5, COPT0 = CDEG0 + 5,
  N_SCALARS = COPT0 + 5
};
// per-driver parameter columns
enum { P_BASE, P_DEG, P_VAR, P_DNF, P_TEAMDNF, P_ACTIVE, N_PCOLS = 8 };
enum { SOFT, MEDIUM, HARD, INTERMEDIATE, WET };
enum { DRY, DAMP, FULL_WET };

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The lane's view of the stream: draw k of this simulation, row = lane.
// Every lane of the warp calls it at the same k, so the refill branch is
// warp-uniform.
struct Stream {
  uint32_t key0, key1, sim, row;
  uint32_t k;
  uint4 w;

  __device__ uint32_t next() {
    if ((k & 3u) == 0u) w = philox4x32_10(sim, k >> 2, row, 0u, key0, key1);
    const uint32_t s = k & 3u;
    ++k;
    return s == 0u ? w.x : (s == 1u ? w.y : (s == 2u ? w.z : w.w));
  }
  __device__ float uniform() { return (float)(next() >> 8) * (1.0f / 16777216.0f); }
  __device__ float normal() {
    const float u1 = fmaxf(uniform(), 5.9604645e-8f);
    const float u2 = uniform();
    return sqrtf(-2.0f * logf(u1)) * cosf(6.2831853f * u2);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int rank_key(float cum, int row) {
  const int ik = __float_as_int(fmaxf(cum, 0.25f));
  return ((ik - kIKeyBase) >> kQShift) * kRowMult + row;
}

// #{j < d : key_j < key}: the car's rank among unique keys.
__device__ __forceinline__ int rank_of(int key, int d) {
  int r = 0;
  for (int j = 0; j < d; ++j) r += __shfl_sync(kFull, key, j) < key;
  return r;
}

// perm[rank] = lane for the real lanes; the caller reads perm, then syncs.
__device__ __forceinline__ void scatter_perm(volatile int* perm, int rank, bool real, int lane) {
  __syncwarp();
  if (real) perm[rank] = lane;
  __syncwarp();
}

__device__ __forceinline__ int condition_compound(int track, int remaining) {
  const int dry = remaining > 30 ? HARD : (remaining > 15 ? MEDIUM : SOFT);
  return track == FULL_WET ? WET : (track == DAMP ? INTERMEDIATE : dry);
}

// One block's share of one race, the body of both launches: the block's
// warps walk simulations sim_offset + [block * warps_per_block + warp, n_sims)
// with a stride of n_blocks * warps_per_block, and the block adds its (d, d)
// histogram to `counts` once at the end.
__device__ __forceinline__ void race_block(const float* __restrict__ pmat,
                                           const float* __restrict__ scal_g,
                                           const float* __restrict__ grid_log,
                                           int* __restrict__ counts, int d, int race_laps,
                                           uint32_t key0, uint32_t key1, uint32_t sim_offset,
                                           uint32_t n_sims, uint32_t block, uint32_t n_blocks) {
  extern __shared__ int smem[];
  int* hist = smem;                                         // d * d
  float* scal = reinterpret_cast<float*>(smem + d * d);     // N_SCALARS
  int* perms = smem + d * d + 32;                           // 32 per warp

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_block = blockDim.x >> 5;
  volatile int* perm = perms + warp * 32;

  for (int i = threadIdx.x; i < d * d; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x < N_SCALARS) scal[threadIdx.x] = scal_g[threadIdx.x];
  perm[lane] = 0;
  __syncthreads();

  const bool real = lane < d;
  const float base_pace = real ? pmat[lane * N_PCOLS + P_BASE] : 0.0f;
  const float driver_deg = real ? pmat[lane * N_PCOLS + P_DEG] : 0.0f;
  const float variance = real ? pmat[lane * N_PCOLS + P_VAR] : 0.0f;
  const float dnf_rate = real ? pmat[lane * N_PCOLS + P_DNF] : 0.0f;
  const float team_dnf = real ? pmat[lane * N_PCOLS + P_TEAMDNF] : 0.0f;
  const bool active = real && pmat[lane * N_PCOLS + P_ACTIVE] > 0.5f;
  const float factor = driver_deg > 0.0f ? driver_deg / 0.05f : 1.0f;
  const int track = (int)scal[TRACK_COND];
  const float drs_delta = scal[DRS_DELTA];
  const float overtake_delta = scal[OVERTAKE_DELTA];
  const float tenth = (float)lane * 0.1f;

  const uint32_t total_warps = n_blocks * warps_per_block;
  for (uint32_t sim = block * warps_per_block + warp; sim < n_sims; sim += total_warps) {
    Stream rng{key0, key1, sim_offset + sim, (uint32_t)lane, 0u, make_uint4(0u, 0u, 0u, 0u)};

    // ---- grid: masked Gumbel-max per slot ----------------------------------
    bool remaining = active;
    int start_pos = d;
    for (int pos = 0; pos < d; ++pos) {
      const float col = real ? grid_log[lane * d + pos] : -kInf;
      const float masked = remaining ? col : -kInf;
      const bool col_empty = warp_max(masked) <= -kInf / 2;
      const float logits = (col_empty && remaining) ? 0.0f : masked;
      const float u = fmaxf(rng.uniform(), 5.9604645e-8f);
      const float score = remaining ? logits + (-logf(-logf(u))) : -kInf;
      const float best = warp_max(score);
      const bool is_best = (score == best) && remaining;
      const int first = warp_min_int(is_best ? lane : d);
      const bool any_remaining = __any_sync(kFull, remaining);
      const bool take = lane == first && any_remaining;
      if (take) start_pos = pos;
      remaining = remaining && !take;
    }

    // ---- car init --------------------------------------------------------------
    const bool top10 = start_pos < 10;
    int compound = track == FULL_WET ? WET : (track == DAMP ? INTERMEDIATE : (top10 ? SOFT : MEDIUM));
    float age = (track == DRY && top10) ? 4.0f : 0.0f;
    bool used_s = compound == SOFT, used_m = compound == MEDIUM, used_h = compound == HARD;
    float fuel = 110.0f, cum = 0.0f, last_lap = 0.0f, behind = 0.0f;
    float dnf_lap = 0.0f, laps_done = 0.0f;
    bool dnf = !active;  // phantom lanes (>= d) are retired from the start
    bool drs = false;
    float drs_until = 0.0f;

    auto clean_lap_time = [&](int comp, float noise) {
      return base_pace + age * scal[CDEG0 + comp] * factor - (110.0f - fuel) * 0.03f +
             scal[CPACE0 + comp] - (drs ? drs_delta : 0.0f) + variance * noise;
    };

    // ---- lap 1 -------------------------------------------------------------------
    // every lane draws every time: the draw counter is per lane
    const float u_dnf = rng.uniform();
    const bool lap1_dnf = !dnf && (u_dnf < team_dnf * 4.0f);
    const float base_lap = clean_lap_time(compound, rng.normal());
    const float position = (float)start_pos + 1.0f;
    const float sigma = fminf(1.5f, 0.5f + position * 0.1f);
    float start_delta = sigma * rng.normal();
    if (position <= 3.0f) start_delta = fminf(start_delta, 1.0f);
    {
      const float lap_time = base_lap - start_delta * 0.5f;
      const bool alive = !dnf && !lap1_dnf;
      dnf = dnf || lap1_dnf;
      if (lap1_dnf) dnf_lap = 1.0f;
      if (alive) {
        cum = cum + lap_time;
        age = age + 1.0f;
        fuel = fmaxf(0.0f, fuel - 1.5f);
      }
    }
    float leader = warp_min(dnf ? kInf : cum);
    if (!dnf) behind = cum - leader;
    int urank = rank_of(dnf ? kDnfKey + lane : rank_key(cum, lane), d);
    float ahead_ll = 0.0f;

    // ---- laps 2..race_laps -----------------------------------------------------------
    for (int lap = 2; lap <= race_laps; ++lap) {
      const float lap_f = (float)lap;
      const bool act = !dnf;

      // race control (red -> SC -> VSC), rows 0..3 of an 8-row draw
      const float u_rc = rng.uniform();
      const float u_red = __shfl_sync(kFull, u_rc, 0), u_sc = __shfl_sync(kFull, u_rc, 1);
      const float u_vsc = __shfl_sync(kFull, u_rc, 2), u_ref = __shfl_sync(kFull, u_rc, 3);
      const bool is_red = u_red < scal[RED_P];
      const bool is_sc = !is_red && u_sc < scal[SC_P];
      const bool is_vsc = !is_red && !is_sc && u_vsc < scal[VSC_P];
      const bool vsc_refund = is_vsc && u_ref < 0.3f;

      // the rank carried from the previous position update is this lap's rank
      const int rank = urank;
      leader = warp_min(dnf ? kInf : cum);
      const unsigned lead = __ballot_sync(kFull, real && rank == 0 && act);
      const float leader_laps_v = __shfl_sync(kFull, laps_done, lead ? __ffs(lead) - 1 : 0);
      const float leader_laps = lead ? leader_laps_v : 0.0f;
      const float rank_f = (float)rank;
      const float laps_down = leader_laps - laps_done;
      const float sc_time = leader + rank_f * 0.5f + (laps_down > 0.0f ? laps_down * 90.0f : 0.0f);
      const float vsc_time = leader + (cum - leader) * 0.8f;
      const float red_time = leader + rank_f * 0.1f;
      const bool m_red = is_red && act, m_sc = is_sc && act, m_vsc = is_vsc && act;
      cum = m_red ? red_time : (m_sc ? sc_time : (m_vsc ? vsc_time : cum));
      if (m_red || m_sc || m_vsc) behind = cum - leader;
      const bool refund = m_sc || (vsc_refund && act);
      age = m_red ? 0.0f : (refund ? fmaxf(0.0f, age - 1.0f) : age);
      const int remaining_laps = race_laps - lap;
      const int red_compound = condition_compound(track, remaining_laps);
      if (m_red) {
        compound = red_compound;
        used_s = used_s || red_compound == SOFT;
        used_m = used_m || red_compound == MEDIUM;
        used_h = used_h || red_compound == HARD;
      }
      drs_until = (is_red || is_sc) ? lap_f + 2.0f : (is_vsc ? lap_f + 1.0f : drs_until);

      // DNF draw + lap time, dirty air from the carried lap of the car ahead
      const float u_d = rng.uniform();
      const bool new_dnf = act && (u_d < dnf_rate);
      const bool alive = act && !new_dnf;
      const float clean = clean_lap_time(compound, rng.normal());
      const bool in_dirty = behind > 0.0f && ahead_ll > 0.0f && behind < scal[DIRTY_THRESH];
      const float lap_time = in_dirty ? fmaxf(clean + scal[DIRTY_PEN], ahead_ll) : clean;
      dnf = dnf || new_dnf;
      if (new_dnf) dnf_lap = lap_f;
      if (alive) {
        cum = cum + lap_time;
        last_lap = lap_time;
        age = age + 1.0f;
        fuel = fmaxf(0.0f, fuel - 1.5f);
        laps_done = laps_done + 1.0f;
      }

      // pit stops and the two-dry-compound rule
      const float opt = scal[COPT0 + compound];
      const float opt_adj = driver_deg > 0.05f ? floorf(opt * 0.85f)
                                               : (driver_deg < 0.02f ? floorf(opt * 1.1f) : opt);
      if (!dnf && age > opt_adj && remaining_laps > 5) {
        int target = condition_compound(track, remaining_laps);
        const int n_used_dry = (int)used_s + (int)used_m + (int)used_h;
        const bool repeats = (target == SOFT && used_s) || (target == MEDIUM && used_m) ||
                             (target == HARD && used_h);
        if (n_used_dry == 1 && repeats && track == DRY)
          target = remaining_laps > 20 ? (!used_m ? MEDIUM : HARD) : (!used_s ? SOFT : MEDIUM);
        cum = cum + scal[PIT_LOSS];
        compound = target;
        used_s = used_s || target == SOFT;
        used_m = used_m || target == MEDIUM;
        used_h = used_h || target == HARD;
        age = 0.0f;
      }

      // overtakes: 3 passes in position space (lane p = the car at position p)
      const float pace = dnf ? __int_as_float(0x7fc00000) : base_pace + age * driver_deg;
      const float att = pace - (drs ? drs_delta : 0.0f);
      bool pass_active = true;
      const int n_passes = d > 1 ? 3 : 0;
      for (int pass = 0; pass < n_passes; ++pass) {
        const int orank = rank_of(rank_key(cum, lane), d);
        scatter_perm(perm, orank, real, lane);
        const int inv = perm[lane];
        const float r_cum = __shfl_sync(kFull, cum, inv);
        const float r_pace = __shfl_sync(kFull, pace, inv);
        const float r_att = __shfl_sync(kFull, att, inv);
        // attacker at p vs the car at p-1 (NaN pace -> no swap)
        const float delta = __shfl_up_sync(kFull, r_pace, 1) - r_att;
        const float prob = fminf(0.5f, delta * 0.5f);
        const float u = rng.uniform();
        const bool swap = lane >= 1 && real && delta > overtake_delta && u < prob && pass_active;
        // closed form of the sequential time-rewrite chain: prefix max of z
        float z = swap ? -kInf : r_cum + tenth;
        for (int dist = 1; dist < d; dist <<= 1) {
          const float up = __shfl_up_sync(kFull, z, dist);
          if (lane >= dist) z = fmaxf(z, up);
        }
        const float a = swap ? fmaxf(0.1f, z - tenth) : r_cum;
        const bool swap_next = __shfl_down_sync(kFull, (int)swap, 1) && lane + 1 < d;
        const float fin = swap_next ? fmaxf(0.1f, a - 0.1f) + 0.3f : a;
        cum = __shfl_sync(kFull, fin, orank);  // write back: driver reads its position
        const bool any_swap = __any_sync(kFull, swap);
        pass_active = pass_active && any_swap;
      }

      // position / DRS update
      urank = rank_of(dnf ? kDnfKey + lane : rank_key(cum, lane), d);
      leader = warp_min(dnf ? kInf : cum);
      if (!dnf) behind = cum - leader;
      scatter_perm(perm, urank, real, lane);
      const bool has_ahead = real && urank > 0;
      const int src = has_ahead ? perm[urank - 1] : lane;
      __syncwarp();
      const float cum_ahead = __shfl_sync(kFull, cum, src);
      const float ll_ahead = __shfl_sync(kFull, last_lap, src);
      const float ahead_cum = has_ahead ? cum_ahead : 0.0f;
      ahead_ll = has_ahead ? ll_ahead : 0.0f;
      const float gap_ahead = cum - ahead_cum;
      drs = lap_f > 2.0f && !(lap_f <= drs_until) && has_ahead && gap_ahead < 1.0f && !dnf;
    }

    // ---- classification: (dnf, dnf_lap desc, cum desc, row) ----------------------
    const float key_t = dnf ? kInf : cum;
    int active_rank = 0, dnf_rank = 0;
    for (int j = 0; j < d; ++j) {
      const float kj = __shfl_sync(kFull, key_t, j);
      const float lap_j = __shfl_sync(kFull, dnf_lap, j);
      const float cum_j = __shfl_sync(kFull, cum, j);
      const bool dnf_j = __shfl_sync(kFull, (int)dnf, j);
      active_rank += (kj < key_t) || (kj == key_t && j < lane);
      const bool greater =
          lap_j > dnf_lap || (lap_j == dnf_lap && (cum_j > cum || (cum_j == cum && j < lane)));
      dnf_rank += greater && dnf_j && dnf;
    }
    const int n_active = __popc(__ballot_sync(kFull, real && !dnf));
    const int final_pos = dnf ? n_active + dnf_rank : active_rank;
    if (real) atomicAdd(&hist[lane * d + final_pos], 1);
  }

  __syncthreads();
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const int c = hist[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

// K1: one race, a 1-D grid over its simulations.
__global__ void race_kernel(const float* __restrict__ pmat, const float* __restrict__ scal_g,
                            const float* __restrict__ grid_log, int* __restrict__ counts,
                            int d, int race_laps, uint32_t key0, uint32_t key1,
                            uint32_t sim_offset, uint32_t n_sims) {
  race_block(pmat, scal_g, grid_log, counts, d, race_laps, key0, key1, sim_offset, n_sims,
             blockIdx.x, gridDim.x);
}

// K2: a season, grid (blocks_per_race, R). Row blockIdx.y is race r: its
// inputs, lap count, key words and histogram; its simulations are 0..n_sims-1
// of its own stream, so race r equals K1 at race r's seed bit for bit.
__global__ void season_kernel(const float* __restrict__ pmat_s,
                              const float* __restrict__ scal_s,
                              const float* __restrict__ grid_log_s,
                              const int* __restrict__ race_laps,
                              const uint32_t* __restrict__ keys, int* __restrict__ counts,
                              int d, uint32_t n_sims) {
  const int r = blockIdx.y;
  race_block(pmat_s + (size_t)r * d * N_PCOLS, scal_s + (size_t)r * N_SCALARS,
             grid_log_s + (size_t)r * d * d, counts + (size_t)r * d * d, d, race_laps[r],
             keys[2 * r], keys[2 * r + 1], 0u, n_sims, blockIdx.x, gridDim.x);
}

size_t shared_bytes(int d, int warps_per_block) {
  return (size_t)(d * d + 32 + 32 * warps_per_block) * sizeof(int);
}

}  // namespace

// counts (d, d) int32 must be zeroed by the caller. Returns cudaGetLastError().
extern "C" int mcgp_race_counts(const float* pmat, const float* scal, const float* grid_log,
                                int* counts, int d, int race_laps, uint32_t key0,
                                uint32_t key1, uint32_t sim_offset, uint32_t n_sims,
                                int warps_per_block, int n_blocks, void* stream) {
  if (d < 1 || d > kMaxDrivers || warps_per_block < 1 || warps_per_block > 32 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  race_kernel<<<n_blocks, 32 * warps_per_block, shared_bytes(d, warps_per_block),
                (cudaStream_t)stream>>>(pmat, scal, grid_log, counts, d, race_laps, key0, key1,
                                        sim_offset, n_sims);
  return (int)cudaGetLastError();
}

// pmat_s (R, d, 8), scal_s (R, 24), grid_log_s (R, d, d) float32; race_laps
// (R,) int32; keys (R, 2) uint32 key words; counts (R, d, d) int32 zeroed by
// the caller. Returns cudaGetLastError().
extern "C" int mcgp_season_counts(const float* pmat_s, const float* scal_s,
                                  const float* grid_log_s, const int* race_laps,
                                  const uint32_t* keys, int* counts, int n_races, int d,
                                  uint32_t n_sims, int warps_per_block, int blocks_per_race,
                                  void* stream) {
  if (d < 1 || d > kMaxDrivers || warps_per_block < 1 || warps_per_block > 32 ||
      blocks_per_race < 1 || n_races < 1 || n_races > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_per_race, n_races);
  season_kernel<<<grid, 32 * warps_per_block, shared_bytes(d, warps_per_block),
                  (cudaStream_t)stream>>>(pmat_s, scal_s, grid_log_s, race_laps, keys, counts,
                                          d, n_sims);
  return (int)cudaGetLastError();
}
