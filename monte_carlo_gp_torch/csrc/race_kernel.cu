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
// What the design does about it: one warp per simulation, and each lane
// holds R = ceil(D / 32) cars (D <= 128), strided: car i sits in slot
// i / 32 of lane i % 32, and in position space position p sits in slot
// p / 32 of lane p % 32. R is a template parameter, so the per-car state
// (~16 values per car) is a fully unrolled register array that stays in
// registers for the whole race; R = 1 is the one-car-per-lane kernel. Every
// O(D^2) rank of the TPU kernel becomes D shuffles, each compared against
// the lane's R keys; a gather of car src reads slot src / 32 of lane
// src % 32 (R shuffles and a select); the inverse permutation goes through
// 32 R ints of shared memory per warp; the overtake chain's prefix max is a
// __shfl_up_sync scan within each slot that carries each slot's maximum into
// the next; the leader min and the pick of the leader's row are warp
// reductions and ballots over the R slots. No lane ever waits on memory
// inside the race. Warps loop over simulations with a grid stride and the
// block's histogram lives in shared memory (64 KB at D = 128, so the
// launches opt in to more than 48 KB of dynamic shared memory), so global
// atomics run once per block, not once per simulation. Integer atomics keep
// the counts bitwise deterministic, and the Philox counter is (global sim
// index, draw block, row = driver index, or position index for the overtake
// draws), so the counts do not depend on the launch shape.
//
// The rank keys pack (cumulative time quantized to 2^Q ULP) * M + row, with
// the Pallas kernel's tiers by field size (pallas_engine.py:229-240):
// (Q, M) = (2, 32) for D <= 32, (3, 64) for 33..64, (4, 128) for 65..128.
// R fixes the tier: R = 1 -> (2, 32), R = 2 -> (3, 64), R = 3, 4 -> (4, 128).
//
// K2 is bound the same way, by instruction issue. Its grid is 2-D,
// (blocks_per_race, R races): row r of blocks reads race r's parameters,
// scalars, grid table, lap count and key words, and adds into race r's
// histogram. A season's races are uneven (44 to 78 laps in the synthetic
// 2024 season): each block's lap loop runs to its own race's lap count, so a
// short race costs only its own laps, and the wrapper gives each race the
// single-race launch's grid (four whole waves of the blocks that fit on the
// SMs at once: 1,584 blocks of 8 warps on 132 SMs at D <= 32), so the
// season holds many times more short blocks than the SMs take at once: the
// SMs that finish a short race's blocks early take queued blocks of other
// races instead of idling through a ragged tail of long blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDrivers = 128;
constexpr int kIKeyBase = 0x3E800000;  // int view of 0.25f
constexpr int kDnfKey = 2100000000;

// The rank-key tier of a field held R cars per lane.
template <int R>
__host__ __device__ constexpr int q_shift() { return R == 1 ? 2 : (R == 2 ? 3 : 4); }
template <int R>
__host__ __device__ constexpr int row_mult() { return R == 1 ? 32 : (R == 2 ? 64 : 128); }

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

// The lane's view of the stream: draw k of this simulation for each of the
// lane's R rows (row = lane + 32 j). Every lane of the warp calls it at the
// same k, so the refill branch is warp-uniform; each row keeps its own four
// cached words.
template <int R>
struct Stream {
  uint32_t key0, key1, sim, lane;
  uint32_t k;
  uint4 w[R];

  __device__ void next(uint32_t (&out)[R]) {
    const uint32_t s = k & 3u;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (s == 0u) w[j] = philox4x32_10(sim, k >> 2, lane + 32u * j, 0u, key0, key1);
      out[j] = s == 0u ? w[j].x : (s == 1u ? w[j].y : (s == 2u ? w[j].z : w[j].w));
    }
    ++k;
  }
  __device__ void uniform(float (&u)[R]) {
    uint32_t b[R];
    next(b);
#pragma unroll
    for (int j = 0; j < R; ++j) u[j] = (float)(b[j] >> 8) * (1.0f / 16777216.0f);
  }
  __device__ void normal(float (&z)[R]) {
    float u1[R], u2[R];
    uniform(u1);
    uniform(u2);
#pragma unroll
    for (int j = 0; j < R; ++j)
      z[j] = sqrtf(-2.0f * logf(fmaxf(u1[j], 5.9604645e-8f))) * cosf(6.2831853f * u2[j]);
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

// max / min over every car of the warp (the R slots, then the lanes)
template <int R>
__device__ __forceinline__ float max_over(const float (&v)[R]) {
  float m = v[0];
#pragma unroll
  for (int j = 1; j < R; ++j) m = fmaxf(m, v[j]);
  return warp_max(m);
}
template <int R>
__device__ __forceinline__ float min_over(const float (&v)[R]) {
  float m = v[0];
#pragma unroll
  for (int j = 1; j < R; ++j) m = fminf(m, v[j]);
  return warp_min(m);
}

template <int R>
__device__ __forceinline__ int rank_key(float cum, int row) {
  const int ik = __float_as_int(fmaxf(cum, 0.25f));
  return ((ik - kIKeyBase) >> q_shift<R>()) * row_mult<R>() + row;
}

// rank[j] = #{c < d : key_c < key[j]}: each of the lane's cars' rank among
// unique keys; one shuffle per car of the field.
template <int R>
__device__ __forceinline__ void rank_of(const int (&key)[R], int d, int (&rank)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) rank[j] = 0;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int n = min(32, d - 32 * s);
    for (int l = 0; l < n; ++l) {
      const int kl = __shfl_sync(kFull, key[s], l);
#pragma unroll
      for (int j = 0; j < R; ++j) rank[j] += kl < key[j];
    }
  }
}

// perm[rank] = car for the real cars; the caller reads perm, then syncs.
template <int R>
__device__ __forceinline__ void scatter_perm(volatile int* perm, const int (&rank)[R],
                                             const bool (&real)[R], int lane) {
  __syncwarp();
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (real[j]) perm[rank[j]] = lane + 32 * j;
  __syncwarp();
}

// The value of car (or position) src of a per-slot array: slot src / 32 of
// lane src % 32. Every lane may ask for another src.
template <int R>
__device__ __forceinline__ float gather(const float (&v)[R], int src) {
  if constexpr (R == 1) {
    return __shfl_sync(kFull, v[0], src);
  } else {
    float out = 0.0f;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const float t = __shfl_sync(kFull, v[s], src & 31);
      if ((src >> 5) == s) out = t;
    }
    return out;
  }
}

__device__ __forceinline__ int condition_compound(int track, int remaining) {
  const int dry = remaining > 30 ? HARD : (remaining > 15 ? MEDIUM : SOFT);
  return track == FULL_WET ? WET : (track == DAMP ? INTERMEDIATE : dry);
}

// One block's share of one race, the body of both launches: the block's
// warps walk simulations sim_offset + [block * warps_per_block + warp, n_sims)
// with a stride of n_blocks * warps_per_block, and the block adds its (d, d)
// histogram to `counts` once at the end. d <= 32 R.
template <int R>
__device__ __forceinline__ void race_block(const float* __restrict__ pmat,
                                           const float* __restrict__ scal_g,
                                           const float* __restrict__ grid_log,
                                           int* __restrict__ counts, int d, int race_laps,
                                           uint32_t key0, uint32_t key1, uint32_t sim_offset,
                                           uint32_t n_sims, uint32_t block, uint32_t n_blocks) {
  extern __shared__ int smem[];
  int* hist = smem;                                         // d * d
  float* scal = reinterpret_cast<float*>(smem + d * d);     // N_SCALARS
  int* perms = smem + d * d + 32;                           // 32 R per warp

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_block = blockDim.x >> 5;
  volatile int* perm = perms + warp * 32 * R;

  for (int i = threadIdx.x; i < d * d; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x < N_SCALARS) scal[threadIdx.x] = scal_g[threadIdx.x];
#pragma unroll
  for (int j = 0; j < R; ++j) perm[lane + 32 * j] = 0;
  __syncthreads();

  // slot j of this lane: car (and position) lane + 32 j
  int car[R];
  bool real[R], active[R];
  float base_pace[R], driver_deg[R], variance[R], dnf_rate[R], team_dnf[R], factor[R];
  float tenth[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    car[j] = lane + 32 * j;
    real[j] = car[j] < d;
    const float* row = pmat + car[j] * N_PCOLS;
    base_pace[j] = real[j] ? row[P_BASE] : 0.0f;
    driver_deg[j] = real[j] ? row[P_DEG] : 0.0f;
    variance[j] = real[j] ? row[P_VAR] : 0.0f;
    dnf_rate[j] = real[j] ? row[P_DNF] : 0.0f;
    team_dnf[j] = real[j] ? row[P_TEAMDNF] : 0.0f;
    active[j] = real[j] && row[P_ACTIVE] > 0.5f;
    factor[j] = driver_deg[j] > 0.0f ? driver_deg[j] / 0.05f : 1.0f;
    tenth[j] = (float)car[j] * 0.1f;
  }
  const int track = (int)scal[TRACK_COND];
  const float drs_delta = scal[DRS_DELTA];
  const float overtake_delta = scal[OVERTAKE_DELTA];

  const uint32_t total_warps = n_blocks * warps_per_block;
  for (uint32_t sim = block * warps_per_block + warp; sim < n_sims; sim += total_warps) {
    Stream<R> rng{key0, key1, sim_offset + sim, (uint32_t)lane, 0u, {}};

    // ---- grid: masked Gumbel-max per slot ----------------------------------
    bool remaining[R];
    int start_pos[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      remaining[j] = active[j];
      start_pos[j] = d;
    }
    for (int pos = 0; pos < d; ++pos) {
      float masked[R], u[R], score[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float col = real[j] ? grid_log[car[j] * d + pos] : -kInf;
        masked[j] = remaining[j] ? col : -kInf;
      }
      const bool col_empty = max_over<R>(masked) <= -kInf / 2;
      rng.uniform(u);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float logits = (col_empty && remaining[j]) ? 0.0f : masked[j];
        const float uj = fmaxf(u[j], 5.9604645e-8f);
        score[j] = remaining[j] ? logits + (-logf(-logf(uj))) : -kInf;
      }
      const float best = max_over<R>(score);
      int cand = d;
      bool any_left = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if ((score[j] == best) && remaining[j]) cand = min(cand, car[j]);
        any_left = any_left || remaining[j];
      }
      const int first = warp_min_int(cand);
      const bool any_remaining = __any_sync(kFull, any_left);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool take = car[j] == first && any_remaining;
        if (take) start_pos[j] = pos;
        remaining[j] = remaining[j] && !take;
      }
    }

    // ---- car init --------------------------------------------------------------
    int compound[R];
    float age[R], fuel[R], cum[R], last_lap[R], behind[R], dnf_lap[R], laps_done[R];
    float ahead_ll[R];
    bool used_s[R], used_m[R], used_h[R], dnf[R], drs[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool top10 = start_pos[j] < 10;
      compound[j] = track == FULL_WET ? WET : (track == DAMP ? INTERMEDIATE : (top10 ? SOFT : MEDIUM));
      age[j] = (track == DRY && top10) ? 4.0f : 0.0f;
      used_s[j] = compound[j] == SOFT;
      used_m[j] = compound[j] == MEDIUM;
      used_h[j] = compound[j] == HARD;
      fuel[j] = 110.0f;
      cum[j] = last_lap[j] = behind[j] = dnf_lap[j] = laps_done[j] = ahead_ll[j] = 0.0f;
      dnf[j] = !active[j];  // phantom cars (>= d) are retired from the start
      drs[j] = false;
    }
    float drs_until = 0.0f;

    auto clean_lap_time = [&](int j, int comp, float noise) {
      return base_pace[j] + age[j] * scal[CDEG0 + comp] * factor[j] - (110.0f - fuel[j]) * 0.03f +
             scal[CPACE0 + comp] - (drs[j] ? drs_delta : 0.0f) + variance[j] * noise;
    };

    // ---- lap 1 -------------------------------------------------------------------
    // every row draws every time: the draw counter is per simulation
    {
      float u_dnf[R], lap_noise[R], start_noise[R];
      rng.uniform(u_dnf);
      rng.normal(lap_noise);
      rng.normal(start_noise);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool lap1_dnf = !dnf[j] && (u_dnf[j] < team_dnf[j] * 4.0f);
        const float base_lap = clean_lap_time(j, compound[j], lap_noise[j]);
        const float position = (float)start_pos[j] + 1.0f;
        const float sigma = fminf(1.5f, 0.5f + position * 0.1f);
        float start_delta = sigma * start_noise[j];
        if (position <= 3.0f) start_delta = fminf(start_delta, 1.0f);
        const float lap_time = base_lap - start_delta * 0.5f;
        const bool alive = !dnf[j] && !lap1_dnf;
        dnf[j] = dnf[j] || lap1_dnf;
        if (lap1_dnf) dnf_lap[j] = 1.0f;
        if (alive) {
          cum[j] = cum[j] + lap_time;
          age[j] = age[j] + 1.0f;
          fuel[j] = fmaxf(0.0f, fuel[j] - 1.5f);
        }
      }
    }
    float timing[R];
#pragma unroll
    for (int j = 0; j < R; ++j) timing[j] = dnf[j] ? kInf : cum[j];
    float leader = min_over<R>(timing);
    int urank[R];
    {
      int key[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!dnf[j]) behind[j] = cum[j] - leader;
        key[j] = dnf[j] ? kDnfKey + car[j] : rank_key<R>(cum[j], car[j]);
      }
      rank_of<R>(key, d, urank);
    }

    // ---- laps 2..race_laps -----------------------------------------------------------
    for (int lap = 2; lap <= race_laps; ++lap) {
      const float lap_f = (float)lap;
      bool act[R];
#pragma unroll
      for (int j = 0; j < R; ++j) act[j] = !dnf[j];

      // race control (red -> SC -> VSC), rows 0..3 of an 8-row draw (slot 0)
      float u_rc[R];
      rng.uniform(u_rc);
      const float u_red = __shfl_sync(kFull, u_rc[0], 0), u_sc = __shfl_sync(kFull, u_rc[0], 1);
      const float u_vsc = __shfl_sync(kFull, u_rc[0], 2), u_ref = __shfl_sync(kFull, u_rc[0], 3);
      const bool is_red = u_red < scal[RED_P];
      const bool is_sc = !is_red && u_sc < scal[SC_P];
      const bool is_vsc = !is_red && !is_sc && u_vsc < scal[VSC_P];
      const bool vsc_refund = is_vsc && u_ref < 0.3f;

      // the rank carried from the previous position update is this lap's rank
#pragma unroll
      for (int j = 0; j < R; ++j) timing[j] = dnf[j] ? kInf : cum[j];
      leader = min_over<R>(timing);
      float leader_laps = 0.0f;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const unsigned lead = __ballot_sync(kFull, real[s] && urank[s] == 0 && act[s]);
        const float leader_laps_v = __shfl_sync(kFull, laps_done[s], lead ? __ffs(lead) - 1 : 0);
        if (lead) leader_laps = leader_laps_v;
      }
      const int remaining_laps = race_laps - lap;
      const int red_compound = condition_compound(track, remaining_laps);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float rank_f = (float)urank[j];
        const float laps_down = leader_laps - laps_done[j];
        const float sc_time =
            leader + rank_f * 0.5f + (laps_down > 0.0f ? laps_down * 90.0f : 0.0f);
        const float vsc_time = leader + (cum[j] - leader) * 0.8f;
        const float red_time = leader + rank_f * 0.1f;
        const bool m_red = is_red && act[j], m_sc = is_sc && act[j], m_vsc = is_vsc && act[j];
        cum[j] = m_red ? red_time : (m_sc ? sc_time : (m_vsc ? vsc_time : cum[j]));
        if (m_red || m_sc || m_vsc) behind[j] = cum[j] - leader;
        const bool refund = m_sc || (vsc_refund && act[j]);
        age[j] = m_red ? 0.0f : (refund ? fmaxf(0.0f, age[j] - 1.0f) : age[j]);
        if (m_red) {
          compound[j] = red_compound;
          used_s[j] = used_s[j] || red_compound == SOFT;
          used_m[j] = used_m[j] || red_compound == MEDIUM;
          used_h[j] = used_h[j] || red_compound == HARD;
        }
      }
      drs_until = (is_red || is_sc) ? lap_f + 2.0f : (is_vsc ? lap_f + 1.0f : drs_until);

      // DNF draw + lap time, dirty air from the carried lap of the car ahead
      float u_d[R], lap_noise[R];
      rng.uniform(u_d);
      rng.normal(lap_noise);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool new_dnf = act[j] && (u_d[j] < dnf_rate[j]);
        const bool alive = act[j] && !new_dnf;
        const float clean = clean_lap_time(j, compound[j], lap_noise[j]);
        const bool in_dirty =
            behind[j] > 0.0f && ahead_ll[j] > 0.0f && behind[j] < scal[DIRTY_THRESH];
        const float lap_time = in_dirty ? fmaxf(clean + scal[DIRTY_PEN], ahead_ll[j]) : clean;
        dnf[j] = dnf[j] || new_dnf;
        if (new_dnf) dnf_lap[j] = lap_f;
        if (alive) {
          cum[j] = cum[j] + lap_time;
          last_lap[j] = lap_time;
          age[j] = age[j] + 1.0f;
          fuel[j] = fmaxf(0.0f, fuel[j] - 1.5f);
          laps_done[j] = laps_done[j] + 1.0f;
        }

        // pit stops and the two-dry-compound rule
        const float opt = scal[COPT0 + compound[j]];
        const float opt_adj = driver_deg[j] > 0.05f
                                  ? floorf(opt * 0.85f)
                                  : (driver_deg[j] < 0.02f ? floorf(opt * 1.1f) : opt);
        if (!dnf[j] && age[j] > opt_adj && remaining_laps > 5) {
          int target = condition_compound(track, remaining_laps);
          const int n_used_dry = (int)used_s[j] + (int)used_m[j] + (int)used_h[j];
          const bool repeats = (target == SOFT && used_s[j]) || (target == MEDIUM && used_m[j]) ||
                               (target == HARD && used_h[j]);
          if (n_used_dry == 1 && repeats && track == DRY)
            target = remaining_laps > 20 ? (!used_m[j] ? MEDIUM : HARD) : (!used_s[j] ? SOFT : MEDIUM);
          cum[j] = cum[j] + scal[PIT_LOSS];
          compound[j] = target;
          used_s[j] = used_s[j] || target == SOFT;
          used_m[j] = used_m[j] || target == MEDIUM;
          used_h[j] = used_h[j] || target == HARD;
          age[j] = 0.0f;
        }
      }

      // overtakes: 3 passes in position space (slot s of lane l = position
      // l + 32 s)
      float pace[R], att[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        pace[j] = dnf[j] ? __int_as_float(0x7fc00000) : base_pace[j] + age[j] * driver_deg[j];
        att[j] = pace[j] - (drs[j] ? drs_delta : 0.0f);
      }
      bool pass_active = true;
      const int n_passes = d > 1 ? 3 : 0;
      for (int pass = 0; pass < n_passes; ++pass) {
        int okey[R], orank[R];
#pragma unroll
        for (int j = 0; j < R; ++j) okey[j] = rank_key<R>(cum[j], car[j]);
        rank_of<R>(okey, d, orank);
        scatter_perm<R>(perm, orank, real, lane);
        float r_cum[R], r_pace[R], r_att[R];
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int inv = perm[lane + 32 * s];
          r_cum[s] = gather<R>(cum, inv);
          r_pace[s] = gather<R>(pace, inv);
          r_att[s] = gather<R>(att, inv);
        }
        float u[R];
        rng.uniform(u);
        bool swap[R];
        float z[R];
#pragma unroll
        for (int s = 0; s < R; ++s) {
          // attacker at p vs the car at p-1 (NaN pace -> no swap); position
          // 32 s - 1 is lane 31 of the slot before
          float ahead_pace = __shfl_up_sync(kFull, r_pace[s], 1);
          if (s > 0) {
            const float last = __shfl_sync(kFull, r_pace[s > 0 ? s - 1 : 0], 31);
            if (lane == 0) ahead_pace = last;
          }
          const float delta = ahead_pace - r_att[s];
          const float prob = fminf(0.5f, delta * 0.5f);
          const int p = lane + 32 * s;
          swap[s] = p >= 1 && p < d && delta > overtake_delta && u[s] < prob && pass_active;
          z[s] = swap[s] ? -kInf : r_cum[s] + tenth[s];
        }
        // closed form of the sequential time-rewrite chain: prefix max of z,
        // a scan within each slot that carries the slot before's maximum
        const int span = R == 1 ? d : 32;
#pragma unroll
        for (int s = 0; s < R; ++s) {
          for (int dist = 1; dist < span; dist <<= 1) {
            const float up = __shfl_up_sync(kFull, z[s], dist);
            if (lane >= dist) z[s] = fmaxf(z[s], up);
          }
          if (s > 0) z[s] = fmaxf(z[s], __shfl_sync(kFull, z[s > 0 ? s - 1 : 0], 31));
        }
        float fin[R];
        bool any_swap_lane = false;
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const float a = swap[s] ? fmaxf(0.1f, z[s] - tenth[s]) : r_cum[s];
          bool next = __shfl_down_sync(kFull, (int)swap[s], 1);
          if (s + 1 < R) {
            const bool next_slot = __shfl_sync(kFull, (int)swap[s + 1 < R ? s + 1 : s], 0);
            if (lane == 31) next = next_slot;
          }
          const bool swap_next = next && lane + 32 * s + 1 < d;
          fin[s] = swap_next ? fmaxf(0.1f, a - 0.1f) + 0.3f : a;
          any_swap_lane = any_swap_lane || swap[s];
        }
        // write back: each car reads its position
#pragma unroll
        for (int j = 0; j < R; ++j) cum[j] = gather<R>(fin, orank[j]);
        const bool any_swap = __any_sync(kFull, any_swap_lane);
        pass_active = pass_active && any_swap;
      }

      // position / DRS update
      {
        int key[R];
#pragma unroll
        for (int j = 0; j < R; ++j) key[j] = dnf[j] ? kDnfKey + car[j] : rank_key<R>(cum[j], car[j]);
        rank_of<R>(key, d, urank);
      }
#pragma unroll
      for (int j = 0; j < R; ++j) timing[j] = dnf[j] ? kInf : cum[j];
      leader = min_over<R>(timing);
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (!dnf[j]) behind[j] = cum[j] - leader;
      scatter_perm<R>(perm, urank, real, lane);
      int src[R];
      bool has_ahead[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        has_ahead[j] = real[j] && urank[j] > 0;
        src[j] = has_ahead[j] ? perm[urank[j] - 1] : car[j];
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float cum_ahead = gather<R>(cum, src[j]);
        const float ll_ahead = gather<R>(last_lap, src[j]);
        const float ahead_cum = has_ahead[j] ? cum_ahead : 0.0f;
        ahead_ll[j] = has_ahead[j] ? ll_ahead : 0.0f;
        const float gap_ahead = cum[j] - ahead_cum;
        drs[j] = lap_f > 2.0f && !(lap_f <= drs_until) && has_ahead[j] && gap_ahead < 1.0f && !dnf[j];
      }
    }

    // ---- classification: (dnf, dnf_lap desc, cum desc, row) ----------------------
    int active_rank[R], dnf_rank[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      timing[j] = dnf[j] ? kInf : cum[j];
      active_rank[j] = dnf_rank[j] = 0;
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int n = min(32, d - 32 * s);
      for (int l = 0; l < n; ++l) {
        const int c = 32 * s + l;
        const float kc = __shfl_sync(kFull, timing[s], l);
        const float lap_c = __shfl_sync(kFull, dnf_lap[s], l);
        const float cum_c = __shfl_sync(kFull, cum[s], l);
        const bool dnf_c = __shfl_sync(kFull, (int)dnf[s], l);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          active_rank[j] += (kc < timing[j]) || (kc == timing[j] && c < car[j]);
          const bool greater = lap_c > dnf_lap[j] ||
                               (lap_c == dnf_lap[j] && (cum_c > cum[j] || (cum_c == cum[j] && c < car[j])));
          dnf_rank[j] += greater && dnf_c && dnf[j];
        }
      }
    }
    int n_active = 0;
#pragma unroll
    for (int s = 0; s < R; ++s) n_active += __popc(__ballot_sync(kFull, real[s] && !dnf[s]));
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int final_pos = dnf[j] ? n_active + dnf_rank[j] : active_rank[j];
      if (real[j]) atomicAdd(&hist[car[j] * d + final_pos], 1);
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const int c = hist[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

// K1: one race, a 1-D grid over its simulations.
template <int R>
__global__ void race_kernel(const float* __restrict__ pmat, const float* __restrict__ scal_g,
                            const float* __restrict__ grid_log, int* __restrict__ counts,
                            int d, int race_laps, uint32_t key0, uint32_t key1,
                            uint32_t sim_offset, uint32_t n_sims) {
  race_block<R>(pmat, scal_g, grid_log, counts, d, race_laps, key0, key1, sim_offset, n_sims,
                blockIdx.x, gridDim.x);
}

// K2: a season, grid (blocks_per_race, R). Row blockIdx.y is race r: its
// inputs, lap count, key words and histogram; its simulations are 0..n_sims-1
// of its own stream, so race r equals K1 at race r's seed bit for bit.
template <int R>
__global__ void season_kernel(const float* __restrict__ pmat_s,
                              const float* __restrict__ scal_s,
                              const float* __restrict__ grid_log_s,
                              const int* __restrict__ race_laps,
                              const uint32_t* __restrict__ keys, int* __restrict__ counts,
                              int d, uint32_t n_sims) {
  const int r = blockIdx.y;
  race_block<R>(pmat_s + (size_t)r * d * N_PCOLS, scal_s + (size_t)r * N_SCALARS,
                grid_log_s + (size_t)r * d * d, counts + (size_t)r * d * d, d, race_laps[r],
                keys[2 * r], keys[2 * r + 1], 0u, n_sims, blockIdx.x, gridDim.x);
}

// histogram, scalars, and 32 R ints of inverse permutation per warp
size_t shared_bytes(int d, int warps_per_block, int r) {
  return (size_t)(d * d + 32 + 32 * r * warps_per_block) * sizeof(int);
}

// More than 48 KB of dynamic shared memory (the histogram alone is 64 KB at
// D = 128) needs the kernel's opt-in first; a launch over the limit would be
// refused.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int R>
int launch_race(const float* pmat, const float* scal, const float* grid_log, int* counts, int d,
                int race_laps, uint32_t key0, uint32_t key1, uint32_t sim_offset,
                uint32_t n_sims, int warps_per_block, int n_blocks, cudaStream_t stream) {
  const size_t smem = shared_bytes(d, warps_per_block, R);
  const cudaError_t err = allow_shared(race_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  race_kernel<R><<<n_blocks, 32 * warps_per_block, smem, stream>>>(
      pmat, scal, grid_log, counts, d, race_laps, key0, key1, sim_offset, n_sims);
  return (int)cudaGetLastError();
}

template <int R>
int launch_season(const float* pmat_s, const float* scal_s, const float* grid_log_s,
                  const int* race_laps, const uint32_t* keys, int* counts, int n_races, int d,
                  uint32_t n_sims, int warps_per_block, int blocks_per_race,
                  cudaStream_t stream) {
  const size_t smem = shared_bytes(d, warps_per_block, R);
  const cudaError_t err = allow_shared(season_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks_per_race, n_races);
  season_kernel<R><<<grid, 32 * warps_per_block, smem, stream>>>(
      pmat_s, scal_s, grid_log_s, race_laps, keys, counts, d, n_sims);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem, int warps_per_block) {
  int n = 0;
  if (allow_shared(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * warps_per_block, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

template <int R>
int blocks_per_sm_r(int d, int warps_per_block, int season) {
  const size_t smem = shared_bytes(d, warps_per_block, R);
  return season ? blocks_per_sm(season_kernel<R>, smem, warps_per_block)
                : blocks_per_sm(race_kernel<R>, smem, warps_per_block);
}

}  // namespace

// How many blocks of `warps_per_block` warps of K1 (season = 0) or K2
// (season = 1) fit on one SM at once for a field of d drivers, from the
// kernel's registers and shared memory; -1 on a CUDA error.
extern "C" int mcgp_blocks_per_sm(int d, int warps_per_block, int season) {
  if (d < 1 || d > kMaxDrivers || warps_per_block < 1 || warps_per_block > 32) return -1;
  switch ((d + 31) / 32) {
    case 1: return blocks_per_sm_r<1>(d, warps_per_block, season);
    case 2: return blocks_per_sm_r<2>(d, warps_per_block, season);
    case 3: return blocks_per_sm_r<3>(d, warps_per_block, season);
    default: return blocks_per_sm_r<4>(d, warps_per_block, season);
  }
}

// counts (d, d) int32 must be zeroed by the caller; d <= 128. Returns the
// first CUDA error of the shared-memory opt-in and the launch.
extern "C" int mcgp_race_counts(const float* pmat, const float* scal, const float* grid_log,
                                int* counts, int d, int race_laps, uint32_t key0,
                                uint32_t key1, uint32_t sim_offset, uint32_t n_sims,
                                int warps_per_block, int n_blocks, void* stream) {
  if (d < 1 || d > kMaxDrivers || warps_per_block < 1 || warps_per_block > 32 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((d + 31) / 32) {
    case 1:
      return launch_race<1>(pmat, scal, grid_log, counts, d, race_laps, key0, key1, sim_offset,
                            n_sims, warps_per_block, n_blocks, st);
    case 2:
      return launch_race<2>(pmat, scal, grid_log, counts, d, race_laps, key0, key1, sim_offset,
                            n_sims, warps_per_block, n_blocks, st);
    case 3:
      return launch_race<3>(pmat, scal, grid_log, counts, d, race_laps, key0, key1, sim_offset,
                            n_sims, warps_per_block, n_blocks, st);
    default:
      return launch_race<4>(pmat, scal, grid_log, counts, d, race_laps, key0, key1, sim_offset,
                            n_sims, warps_per_block, n_blocks, st);
  }
}

// pmat_s (R, d, 8), scal_s (R, 24), grid_log_s (R, d, d) float32; race_laps
// (R,) int32; keys (R, 2) uint32 key words; counts (R, d, d) int32 zeroed by
// the caller; d <= 128. Returns the first CUDA error of the shared-memory
// opt-in and the launch.
extern "C" int mcgp_season_counts(const float* pmat_s, const float* scal_s,
                                  const float* grid_log_s, const int* race_laps,
                                  const uint32_t* keys, int* counts, int n_races, int d,
                                  uint32_t n_sims, int warps_per_block, int blocks_per_race,
                                  void* stream) {
  if (d < 1 || d > kMaxDrivers || warps_per_block < 1 || warps_per_block > 32 ||
      blocks_per_race < 1 || n_races < 1 || n_races > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((d + 31) / 32) {
    case 1:
      return launch_season<1>(pmat_s, scal_s, grid_log_s, race_laps, keys, counts, n_races, d,
                              n_sims, warps_per_block, blocks_per_race, st);
    case 2:
      return launch_season<2>(pmat_s, scal_s, grid_log_s, race_laps, keys, counts, n_races, d,
                              n_sims, warps_per_block, blocks_per_race, st);
    case 3:
      return launch_season<3>(pmat_s, scal_s, grid_log_s, race_laps, keys, counts, n_races, d,
                              n_sims, warps_per_block, blocks_per_race, st);
    default:
      return launch_season<4>(pmat_s, scal_s, grid_log_s, race_laps, keys, counts, n_races, d,
                              n_sims, warps_per_block, blocks_per_race, st);
  }
}
