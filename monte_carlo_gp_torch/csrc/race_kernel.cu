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
// What bounds it: not bytes, and not float32 operations. Per simulation it
// reads about 1 KB of parameters (a (D, 8) matrix, 24 scalars, a (D, D) grid
// table: 2-68 KB per race, read once per block and cached) and writes
// nothing but shared-memory atomics. A lap is the Philox rounds of seven
// draws, one Box-Muller normal, a few hundred integer compares and selects,
// and three ranks of the field, each an all-pairs count. So the kernel is
// bound by instruction issue and by the latency of its dependent chains:
// ranks, gathers and scans that cross the lanes of a warp.
//
// What the design does about it. A simulation runs on a segment of L lanes
// of a warp, and each lane holds R cars, strided: car i sits in slot i / L
// of segment lane i % L, and in position space position p sits in slot p / L
// of segment lane p % L. The instance is chosen from the field width d alone:
//
//   * d <= 20, the packed instance race_block<2, 3>: G = 3 simulations a
//     warp, each on a segment of L = 10 lanes (lanes 0-9, 10-19, 20-29) with
//     R = 2 cars a lane. Every F1 field since 2010 has 20 cars, and one
//     simulation a warp left lanes 20-31 idle through every instruction of
//     the lap (37.5% of the issued per-car work); three a warp leave 2 of 32
//     (6.25%), and each lane has two independent cars in flight, so their
//     dependent chains overlap. Lanes 30-31 mirror lanes 20-21 of segment 2
//     (the same simulation, rows and values), so every shuffle source is a
//     lane that computes, their shared-memory stores repeat what lanes 20-21
//     store, and only their histogram adds are dropped.
//   * d = 21..128, race_block<R, 1> with R = ceil(d / 32): one simulation a
//     warp, L = 32 (at 22-32 cars 3 x 10 x 2 does not fit, and 2 x 16 x 2
//     packs no better).
//
// G, L and R are template parameters, so the per-car state (~16 values per
// car) is a fully unrolled register array that stays in registers for the
// whole race, and at G = 1 every segment helper below is the plain warp
// collective. Then:
//
//   * Ranks go through shared memory, not shuffles. Each segment owns five
//     rows of L R words: the rank keys, three position-space rows and the DNF
//     laps by car (below). A rank writes every car's key to the key row
//     (padding slots INT_MAX, which exceeds every key), and each lane reads
//     its segment's row back as 16-byte broadcasts, ceil(d / 4) of them,
//     counting against its own R keys in registers: at d = 20 five LDS.128
//     where a shuffle per car took twenty. In the packed instance a row is
//     80 B and a segment's five rows 400 B, so the three segments' broadcasts
//     of one load start at banks 0, 4 and 8: no two share a bank. In the same
//     step every car scatters the values its position needs (time, pace,
//     attack pace; or time and last lap) straight to the row index of its
//     rank, so the inverse permutation, its dependent load and the gathers
//     through it are gone, and the overtake pass's write-back reads its time
//     at its rank the same way.
//   * Segment collectives stand for warp collectives: ballots are shifted and
//     masked to the segment's L bits, the race-control broadcast reads
//     segment lanes 0-3, the leader's minimum and the grid's maximum rotate
//     through the segment (sources sl + 1, 2, 4, 8 mod L: fminf and fmaxf are
//     exact in any order, and the xor butterfly would cross segments), and
//     the overtake prefix-max scan runs shfl_up within the segment, then
//     carries slot s - 1's maximum from segment lane L - 1.
//   * A pass that cannot swap does no work. An overtake pass is live only
//     if the pass before it swapped; that flag is per simulation, so uniform
//     in a segment. A dead pass draws its uniform (the stream must not shift)
//     and, where every segment of the warp is dead, stops there; a dead
//     segment in a warp that runs the pass swaps nothing, which gives every
//     car its own time back, bit for bit. A live pass in which no car of the
//     warp swaps stops after its ballot, before the prefix-max scan and the
//     write-back: with no swap every time is written back unchanged. The swap
//     flags travel as ballots, so the neighbour's flag is a bit of a mask.
//   * More warps stay resident. Latency, not issue, was what the time
//     followed (more resident warps ran faster at the same work), so R = 1
//     is compiled for at most 64 registers (__launch_bounds__ of 1,024
//     threads): four blocks of eight warps fit on an SM, where 80 registers
//     fit three. To fit without spills, what never changes across
//     simulations (the per-car constants) and what is read only at the end
//     (each car's DNF lap) live in shared memory, each lane reading and
//     writing only its own cars' words, so without bank conflicts. R = 4
//     takes blocks of 12 warps (170 registers), where the 64 KB histogram
//     leaves room for one block of 8. The packed instance holds two cars a
//     lane, and its time followed the resident warps too: at 128 registers
//     16 warps fit, at 96 20 (kPackedMaxThreads, chosen by timing). To fit
//     96 without spills it keeps its lanes' cached Philox words in shared
//     memory (8 registers at R = 2) and no `behind` register: it reads the
//     gap to the leader as cum - leader, which for every car that can still
//     move is `behind` bit for bit (both last set together). The instances
//     of one simulation a warp keep `behind`: read as cum - leader there,
//     race_kernel<1> spills 12 B at its 64 registers and both R = 1
//     instances ran 1-2% slower on an H100.
//   * The grid's per-slot argmin of the car index and its empty-column test
//     are ballots, and the leader at the top of a lap is the one the last
//     position update found (nothing moves in between), so those warp
//     reductions are gone too; the classification's all-pairs counts read
//     the field as broadcasts from the same rows.
//
// The arithmetic is the plain version's, unchanged: the same draws in the
// same order (every row draws every time), and every float32 operation in
// the same order; only where values are kept and how they move changed. The
// counts are bitwise those of the kernels before this design
// (tests/data/torch_kernel_golden.npz).
//
// What it does not use: the race has no matrix product, so wgmma and the
// tensor cores have nothing to do; its inputs are 2-68 KB, read once per
// block and cached, so TMA would save nothing. The block's histogram lives
// in shared memory (64 KB at D = 128, so the launches opt in to more than
// 48 KB of dynamic shared memory), so global atomics run once per block,
// not once per simulation. Integer atomics keep the counts bitwise
// deterministic, and the Philox counter is (global sim index, draw block,
// row = driver index, or position index for the overtake draws), so the
// counts do not depend on the launch shape. Warp w of the grid runs
// simulations G w .. G w + G - 1 (segment s the G w + s-th) with a stride of
// G times the grid's warps; a segment past the last simulation runs with
// the others and adds nothing.
//
// The rank keys pack (cumulative time quantized to 2^Q ULP) * M + row, with
// the Pallas kernel's tiers by field size (pallas_engine.py:229-240):
// (Q, M) = (2, 32) for D <= 32, (3, 64) for 33..64, (4, 128) for 65..128.
// The tier follows the capacity L R: 20 and 32 -> (2, 32), 64 -> (3, 64),
// 96 and 128 -> (4, 128).
//
// K2's grid is 2-D, (blocks_per_race, R races): row r of blocks reads race
// r's parameters, scalars, grid table, lap count and key words, and adds into
// race r's histogram. A season's races are uneven (44 to 78 laps in the
// synthetic 2024 season): each block's lap loop runs to its own race's lap
// count, so a short race costs only its own laps, and the wrapper gives each
// race the single-race launch's grid (four whole waves of the blocks that fit
// on the SMs at once), so the season holds many times more short blocks than
// the SMs take at once: the SMs that finish a short race's blocks early take
// queued blocks of other races instead of idling through a ragged tail.
//
// The sharded launch (pallas_engine.py::_sharded_pallas_probs, :1114, and
// the mesh branch of _season_pallas_probs, :962-983) needs no third kernel:
// both K1 and K2 take a first simulation index, so a shard launches K1 or K2
// on its own device for its own simulation range, and the wrapper
// (ops/race_kernel.py::race_counts_sharded, season_counts_sharded) sums the
// shards' int32 histograms with one all-reduce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDrivers = 128;
constexpr int kIKeyBase = 0x3E800000;  // int view of 0.25f
constexpr int kDnfKey = 2100000000;
constexpr int kPadKey = 0x7fffffff;    // above every rank key: padding never counts
constexpr int kWarpRows = 5;           // rank keys, three position-space rows, DNF laps
// The packed instance: fields of up to kPackedDrivers cars, kPackedSims
// simulations a warp of kPackedCars cars a lane.
constexpr int kPackedDrivers = 20;
constexpr int kPackedSims = 3;
constexpr int kPackedCars = 2;
// The packed instance's most threads a block, which bounds its registers:
// 640 -> 96, with no spill, so 20 warps stay resident (5 blocks of 4). 512
// (128 registers, 16 warps) ran 9% slower; 768 (80) spills.
constexpr int kPackedMaxThreads = 640;

// The rank-key tier of a field held R cars per lane.
template <int R>
__host__ __device__ constexpr int q_shift() { return R == 1 ? 2 : (R == 2 ? 3 : 4); }
template <int R>
__host__ __device__ constexpr int row_mult() { return R == 1 ? 32 : (R == 2 ? 64 : 128); }

// The tier of the packed instance is the one of D <= 32: its keys count rows
// (car indices) below 20.
template <int R, int G>
__host__ __device__ constexpr int tier() { return G == 1 ? R : 1; }

// The most threads a block of R cars per lane takes, which bounds its
// registers: 64 at R = 1 (1,024 threads), so 32 warps stay resident on an
// SM; 128 at R = 2; 255 at R = 3; 170 at R = 4, so one block of 12 warps
// fits (at D = 128 the 64 KB histogram keeps two blocks of 8 from fitting).
template <int R, int G>
__host__ __device__ constexpr int max_threads() {
  return G > 1 ? kPackedMaxThreads
               : (R == 1 ? 1024 : (R == 2 ? 512 : (R == 3 ? 256 : 384)));
}

// scalar pack layout (ops/race_kernel.py)
enum {
  PIT_LOSS, OVERTAKE_DELTA, DRS_DELTA, SC_P, VSC_P, RED_P, DIRTY_THRESH,
  DIRTY_PEN, TRACK_COND, CPACE0, CDEG0 = CPACE0 + 5, COPT0 = CDEG0 + 5,
  N_SCALARS = COPT0 + 5
};
// per-driver parameter columns
enum { P_BASE, P_DEG, P_VAR, P_DNF, P_TEAMDNF, P_ACTIVE, N_PCOLS = 8 };
// rows of the block's table of per-car constants (L R by car index)
enum { C_BASE, C_DEG, C_VAR, C_DNF, C_TEAMDNF, C_FACTOR, C_ACTIVE, N_CROWS };
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
// lane's R rows (row = its segment lane + L j). Every lane of the warp calls
// it at the same k, so the refill branch is warp-uniform; each row keeps its
// own four cached words: in registers, or (kShared, the packed instance,
// whose registers are scarcer) in shared memory, word s of slot j at
// cache[32 (4 j + s)] of the lane's column, so a warp's loads hit 32 banks.
template <int R, int L, bool kShared>
struct Stream {
  uint32_t key0, key1, sim, lane;
  uint32_t k;
  uint4 w[R];
  uint32_t* cache;

  __device__ void next(uint32_t (&out)[R]) {
    const uint32_t s = k & 3u;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if constexpr (kShared) {
        if (s == 0u) {
          const uint4 v = philox4x32_10(sim, k >> 2, lane + (uint32_t)L * j, 0u, key0, key1);
          cache[32 * (4 * j + 1)] = v.y;
          cache[32 * (4 * j + 2)] = v.z;
          cache[32 * (4 * j + 3)] = v.w;
          out[j] = v.x;
        } else {
          out[j] = cache[32 * (4 * j + s)];
        }
      } else {
        if (s == 0u) w[j] = philox4x32_10(sim, k >> 2, lane + (uint32_t)L * j, 0u, key0, key1);
        out[j] = s == 0u ? w[j].x : (s == 1u ? w[j].y : (s == 2u ? w[j].z : w[j].w));
      }
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

// The segment of L = 32 / G lanes that runs this lane's simulation, and its
// collectives. At G = 1 the segment is the warp and each collective is the
// plain warp one. At G > 1 lanes G L .. 31 mirror the last segment's first
// lanes (`owner` false): they compute what those lanes compute, so they may
// take part in every shuffle and store, and add nothing to the histogram.
template <int G>
struct Segment {
  static constexpr int L = 32 / G;
  static constexpr unsigned kBits = G == 1 ? kFull : (1u << (G == 1 ? 0 : L)) - 1u;
  int index;   // the segment's simulation in the warp, 0 .. G - 1
  int base;    // its first lane
  int sl;      // this lane's place in it, 0 .. L - 1
  bool owner;  // false for a mirroring lane

  __device__ explicit Segment(int lane) {
    if constexpr (G == 1) {
      index = 0;
      base = 0;
      sl = lane;
      owner = true;
    } else {
      index = lane / L < G - 1 ? lane / L : G - 1;
      base = index * L;
      sl = lane - base;
      if (sl >= L) sl -= L;
      owner = lane < G * L;
    }
  }
  // the segment's bits of a warp ballot, segment lane 0 at bit 0
  __device__ unsigned bits(unsigned ballot) const {
    if constexpr (G == 1) return ballot;
    else return (ballot >> base) & kBits;
  }
  __device__ bool any(bool v) const {
    if constexpr (G == 1) return __any_sync(kFull, v);
    else return bits(__ballot_sync(kFull, v)) != 0u;
  }
  // whether any segment of the warp holds `v`, a value uniform in a segment
  __device__ bool warp_any(bool v) const {
    if constexpr (G == 1) return v;
    else return __any_sync(kFull, v);
  }
  // v of segment lane `src`
  __device__ float shfl(float v, int src) const { return __shfl_sync(kFull, v, base + src); }
  // max / min over the segment: a rotation by 1, 2, 4, ... lanes, each step
  // doubling the span each lane has seen
  __device__ float max(float v) const {
    if constexpr (G == 1) {
      return warp_max(v);
    } else {
#pragma unroll
      for (int o = 1; o < L; o <<= 1) v = fmaxf(v, shfl(v, sl + o < L ? sl + o : sl + o - L));
      return v;
    }
  }
  __device__ float min(float v) const {
    if constexpr (G == 1) {
      return warp_min(v);
    } else {
#pragma unroll
      for (int o = 1; o < L; o <<= 1) v = fminf(v, shfl(v, sl + o < L ? sl + o : sl + o - L));
      return v;
    }
  }
};

// max / min over every car of the segment (the R slots, then the lanes)
template <int R, int G>
__device__ __forceinline__ float max_over(const Segment<G>& seg, const float (&v)[R]) {
  float m = v[0];
#pragma unroll
  for (int j = 1; j < R; ++j) m = fmaxf(m, v[j]);
  return seg.max(m);
}
template <int R, int G>
__device__ __forceinline__ float min_over(const Segment<G>& seg, const float (&v)[R]) {
  float m = v[0];
#pragma unroll
  for (int j = 1; j < R; ++j) m = fminf(m, v[j]);
  return seg.min(m);
}

template <int T>
__device__ __forceinline__ int rank_key(float cum, int row) {
  const int ik = __float_as_int(fmaxf(cum, 0.25f));
  return ((ik - kIKeyBase) >> q_shift<T>()) * row_mult<T>() + row;
}

// f(q) for q = 0 .. ceil(d / 4) - 1: the 16-byte quads of a segment row of N
// words that hold cars 0 .. d - 1. Unrolled for rows of at most 32 words (at
// most 8 quads); a loop above, where unrolling every quad would bloat the
// code past the instruction cache.
template <int N, typename F>
__device__ __forceinline__ void for_each_quad(int d, F f) {
  if constexpr (N <= 32) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      if (4 * q >= d) break;
      f(q);
    }
  } else {
#pragma unroll 1
    for (int q = 0; 4 * q < d; ++q) f(q);
  }
}

// rank[j] = #{c < d : key_c < key[j]}: each of the lane's cars' rank among
// the field's unique keys. The keys go to the segment's key row (padding
// slots kPadKey), and every lane reads the row back as 16-byte broadcasts
// and counts against its own keys in registers. The leading __syncwarp keeps
// the row until every lane is done with its last contents.
template <int R, int L>
__device__ __forceinline__ void rank_of(int* keys, const int (&key)[R], const bool (&real)[R],
                                        int sl, int d, int (&rank)[R]) {
  __syncwarp();
#pragma unroll
  for (int j = 0; j < R; ++j) keys[sl + L * j] = real[j] ? key[j] : kPadKey;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < R; ++j) rank[j] = 0;
  const int4* row = reinterpret_cast<const int4*>(keys);
  for_each_quad<L * R>(d, [&](int q) {
    const int4 k = row[q];
#pragma unroll
    for (int j = 0; j < R; ++j)
      rank[j] += (k.x < key[j]) + (k.y < key[j]) + (k.z < key[j]) + (k.w < key[j]);
  });
}

__device__ __forceinline__ int condition_compound(int track, int remaining) {
  const int dry = remaining > 30 ? HARD : (remaining > 15 ? MEDIUM : SOFT);
  return track == FULL_WET ? WET : (track == DAMP ? INTERMEDIATE : dry);
}

// Shared memory of a block: per warp, per segment kWarpRows rows of L R
// words (and at G > 1 the lanes' 4 R cached Philox words), then the block's
// N_CROWS rows of per-car constants, the scalars (32 words) and the (d, d)
// histogram. The rows come first, and L R is a multiple of 4, so each row is
// 16-byte aligned for the broadcast loads.
__host__ __device__ constexpr int segment_words(int r, int g) { return g * kWarpRows * (32 / g) * r; }
__host__ __device__ constexpr int warp_words(int r, int g) {
  return segment_words(r, g) + (g > 1 ? 32 * 4 * r : 0);
}

// One block's share of one race, the body of both launches: the block's
// warps walk warp indices w in [block * warps_per_block + warp, ceil(n_sims /
// G)) with a stride of n_blocks * warps_per_block, segment s of warp w runs
// simulation sim_offset + G w + s, and the block adds its (d, d) histogram to
// `counts` once at the end. d <= L R.
template <int R, int G>
__device__ __forceinline__ void race_block(const float* __restrict__ pmat,
                                           const float* __restrict__ scal_g,
                                           const float* __restrict__ grid_log,
                                           int* __restrict__ counts, int d, int race_laps,
                                           uint32_t key0, uint32_t key1, uint32_t sim_offset,
                                           uint32_t n_sims, uint32_t block, uint32_t n_blocks) {
  extern __shared__ __align__(16) int smem[];
  constexpr int L = Segment<G>::L;
  constexpr int T = tier<R, G>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_block = blockDim.x >> 5;
  const Segment<G> seg(lane);
  const int sl = seg.sl;
  constexpr int kRow = L * R;
  int* rows = smem + warp * warp_words(R, G);
  int* keys = rows + seg.index * kWarpRows * kRow;
  float* pos_a = reinterpret_cast<float*>(keys + kRow);
  float* pos_b = pos_a + kRow;
  float* pos_c = pos_b + kRow;
  float* dnf_laps = pos_c + kRow;  // by car index
  float* cst = reinterpret_cast<float*>(smem + warps_per_block * warp_words(R, G));
  float* scal = cst + N_CROWS * kRow;
  int* hist = reinterpret_cast<int*>(scal + 32);

  for (int i = threadIdx.x; i < d * d; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x < N_SCALARS) scal[threadIdx.x] = scal_g[threadIdx.x];
  for (int i = lane; i < warp_words(R, G); i += 32) rows[i] = 0;
  // The per-car constants stay in shared memory, not registers: they never
  // change across simulations, and each lane reads its own cars' (no bank
  // conflict), so the body's registers fit in fewer.
  for (int c = threadIdx.x; c < kRow; c += blockDim.x) {
    const bool is_real = c < d;
    const float* row = pmat + c * N_PCOLS;
    const float deg = is_real ? row[P_DEG] : 0.0f;
    cst[C_BASE * kRow + c] = is_real ? row[P_BASE] : 0.0f;
    cst[C_DEG * kRow + c] = deg;
    cst[C_VAR * kRow + c] = is_real ? row[P_VAR] : 0.0f;
    cst[C_DNF * kRow + c] = is_real ? row[P_DNF] : 0.0f;
    cst[C_TEAMDNF * kRow + c] = is_real ? row[P_TEAMDNF] : 0.0f;
    cst[C_FACTOR * kRow + c] = deg > 0.0f ? deg / 0.05f : 1.0f;
    cst[C_ACTIVE * kRow + c] = (is_real && row[P_ACTIVE] > 0.5f) ? 1.0f : 0.0f;
  }
  __syncthreads();

  // slot j of this lane: car (and position) sl + L j; `tenth` of slot s
  // is 0.1 * the position sl + L s
  int car[R];
  bool real[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    car[j] = sl + L * j;
    real[j] = car[j] < d;
  }
  auto car_const = [&](int col, int j) { return cst[col * kRow + sl + L * j]; };
  auto tenth = [&](int s) { return (float)(sl + L * s) * 0.1f; };
  const int track = (int)scal[TRACK_COND];
  const float drs_delta = scal[DRS_DELTA];
  const float overtake_delta = scal[OVERTAKE_DELTA];

  const uint32_t total_warps = n_blocks * warps_per_block;
  const uint32_t n_warp_sims = G == 1 ? n_sims : n_sims / G + (n_sims % G != 0u);
  for (uint32_t w = block * warps_per_block + warp; w < n_warp_sims; w += total_warps) {
    const uint32_t sim = G * w + seg.index;
    // a mirroring lane, or a segment past the last simulation, adds nothing
    const bool counted = G == 1 || (seg.owner && sim < n_sims);
    Stream<R, L, (G > 1)> rng{key0, key1, sim_offset + sim, (uint32_t)sl, 0u, {},
                              reinterpret_cast<uint32_t*>(rows + segment_words(R, G)) + lane};

    // ---- grid: masked Gumbel-max per slot ----------------------------------
    bool remaining[R];
    int start_pos[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      remaining[j] = car_const(C_ACTIVE, j) != 0.0f;
      start_pos[j] = d;
    }
    for (int pos = 0; pos < d; ++pos) {
      float masked[R], u[R], score[R];
      bool live = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float col = real[j] ? grid_log[car[j] * d + pos] : -kInf;
        masked[j] = remaining[j] ? col : -kInf;
        live = live || masked[j] > -kInf / 2;
      }
      // the column is empty when the maximum of `masked` is <= -kInf / 2
      const bool col_empty = !seg.any(live);
      rng.uniform(u);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float logits = (col_empty && remaining[j]) ? 0.0f : masked[j];
        const float uj = fmaxf(u[j], 5.9604645e-8f);
        score[j] = remaining[j] ? logits + (-logf(-logf(uj))) : -kInf;
      }
      const float best = max_over<R>(seg, score);
      // the lowest car index holding the best score: the first slot with
      // one, its lowest lane
      int first = d;
      bool any_left = false;
#pragma unroll
      for (int s = R - 1; s >= 0; --s) {
        const unsigned best_lanes = seg.bits(__ballot_sync(kFull, (score[s] == best) && remaining[s]));
        if (best_lanes) first = L * s + __ffs(best_lanes) - 1;
        any_left = any_left || remaining[s];
      }
      const bool any_remaining = seg.any(any_left);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool take = car[j] == first && any_remaining;
        if (take) start_pos[j] = pos;
        remaining[j] = remaining[j] && !take;
      }
    }

    // ---- car init --------------------------------------------------------------
    int compound[R];
    float age[R], fuel[R], cum[R], last_lap[R], behind[R], laps_done[R];
    float ahead_ll[R];
    bool used_s[R], used_m[R], used_h[R], dnf[R], drs[R];
    // the previous simulation's classification read every car's DNF lap as a
    // broadcast: the votes since then do not order memory, so fence before
    // this simulation clears the row
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool top10 = start_pos[j] < 10;
      compound[j] = track == FULL_WET ? WET : (track == DAMP ? INTERMEDIATE : (top10 ? SOFT : MEDIUM));
      age[j] = (track == DRY && top10) ? 4.0f : 0.0f;
      used_s[j] = compound[j] == SOFT;
      used_m[j] = compound[j] == MEDIUM;
      used_h[j] = compound[j] == HARD;
      fuel[j] = 110.0f;
      cum[j] = last_lap[j] = behind[j] = laps_done[j] = ahead_ll[j] = 0.0f;
      dnf_laps[car[j]] = 0.0f;
      dnf[j] = car_const(C_ACTIVE, j) == 0.0f;  // phantom cars (>= d) are retired from the start
      drs[j] = false;
    }
    float drs_until = 0.0f;

    auto clean_lap_time = [&](int j, int comp, float noise) {
      return car_const(C_BASE, j) + age[j] * scal[CDEG0 + comp] * car_const(C_FACTOR, j) -
             (110.0f - fuel[j]) * 0.03f + scal[CPACE0 + comp] - (drs[j] ? drs_delta : 0.0f) +
             car_const(C_VAR, j) * noise;
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
        const bool lap1_dnf = !dnf[j] && (u_dnf[j] < car_const(C_TEAMDNF, j) * 4.0f);
        const float base_lap = clean_lap_time(j, compound[j], lap_noise[j]);
        const float position = (float)start_pos[j] + 1.0f;
        const float sigma = fminf(1.5f, 0.5f + position * 0.1f);
        float start_delta = sigma * start_noise[j];
        if (position <= 3.0f) start_delta = fminf(start_delta, 1.0f);
        const float lap_time = base_lap - start_delta * 0.5f;
        const bool alive = !dnf[j] && !lap1_dnf;
        dnf[j] = dnf[j] || lap1_dnf;
        if (lap1_dnf) dnf_laps[car[j]] = 1.0f;
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
    // the leader stays the last position update's until the next one: the
    // top of a lap changes neither cum nor dnf before race control reads it
    float leader = min_over<R>(seg, timing);
    int urank[R];
    {
      int key[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!dnf[j]) behind[j] = cum[j] - leader;
        key[j] = dnf[j] ? kDnfKey + car[j] : rank_key<T>(cum[j], car[j]);
      }
      rank_of<R, L>(keys, key, real, sl, d, urank);
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
      const float u_red = seg.shfl(u_rc[0], 0), u_sc = seg.shfl(u_rc[0], 1);
      const float u_vsc = seg.shfl(u_rc[0], 2), u_ref = seg.shfl(u_rc[0], 3);
      const bool is_red = u_red < scal[RED_P];
      const bool is_sc = !is_red && u_sc < scal[SC_P];
      const bool is_vsc = !is_red && !is_sc && u_vsc < scal[VSC_P];
      const bool vsc_refund = is_vsc && u_ref < 0.3f;

      // the rank and the leader carried from the previous position update
      // are this lap's
      float leader_laps = 0.0f;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const unsigned lead = seg.bits(__ballot_sync(kFull, real[s] && urank[s] == 0 && act[s]));
        const float leader_laps_v = seg.shfl(laps_done[s], lead ? __ffs(lead) - 1 : 0);
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
        const bool new_dnf = act[j] && (u_d[j] < car_const(C_DNF, j));
        const bool alive = act[j] && !new_dnf;
        const float clean = clean_lap_time(j, compound[j], lap_noise[j]);
        // the packed instance keeps no `behind` register (see the header):
        // for every car that can still move it equals cum - leader
        const float gap = G > 1 ? cum[j] - leader : behind[j];
        const bool in_dirty = gap > 0.0f && ahead_ll[j] > 0.0f && gap < scal[DIRTY_THRESH];
        const float lap_time = in_dirty ? fmaxf(clean + scal[DIRTY_PEN], ahead_ll[j]) : clean;
        dnf[j] = dnf[j] || new_dnf;
        if (new_dnf) dnf_laps[car[j]] = lap_f;
        if (alive) {
          cum[j] = cum[j] + lap_time;
          last_lap[j] = lap_time;
          age[j] = age[j] + 1.0f;
          fuel[j] = fmaxf(0.0f, fuel[j] - 1.5f);
          laps_done[j] = laps_done[j] + 1.0f;
        }

        // pit stops and the two-dry-compound rule
        const float opt = scal[COPT0 + compound[j]];
        const float deg = car_const(C_DEG, j);
        const float opt_adj =
            deg > 0.05f ? floorf(opt * 0.85f) : (deg < 0.02f ? floorf(opt * 1.1f) : opt);
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

      // overtakes: 3 passes in position space (slot s of segment lane l =
      // position l + L s). pos_a holds the times by position, pos_b the
      // paces, pos_c the attack paces.
      float pace[R], att[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        pace[j] = dnf[j] ? __int_as_float(0x7fc00000) : car_const(C_BASE, j) + age[j] * car_const(C_DEG, j);
        att[j] = pace[j] - (drs[j] ? drs_delta : 0.0f);
      }
      // whether this segment's simulation may still swap: uniform in a segment
      bool pass_active = true;
      const int n_passes = d > 1 ? 3 : 0;
      for (int pass = 0; pass < n_passes; ++pass) {
        float u[R];
        rng.uniform(u);
        // a pass after one without a swap cannot swap: it leaves every time
        // as it is, and only its draw must be taken
        if (!seg.warp_any(pass_active)) continue;
        int okey[R], orank[R];
#pragma unroll
        for (int j = 0; j < R; ++j) okey[j] = rank_key<T>(cum[j], car[j]);
        rank_of<R, L>(keys, okey, real, sl, d, orank);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (real[j]) {
            pos_a[orank[j]] = cum[j];
            pos_b[orank[j]] = pace[j];
            pos_c[orank[j]] = att[j];
          }
        }
        __syncwarp();
        float r_cum[R];
        bool swap[R];
        unsigned swaps[R];
        unsigned any_swap = 0u;
#pragma unroll
        for (int s = 0; s < R; ++s) {
          // attacker at p vs the car at p-1 (NaN pace -> no swap); a dead
          // segment beside live ones swaps nothing
          const int p = sl + L * s;
          r_cum[s] = pos_a[p];
          const float ahead_pace = pos_b[p >= 1 ? p - 1 : 0];
          const float delta = ahead_pace - pos_c[p];
          const float prob = fminf(0.5f, delta * 0.5f);
          swap[s] = (G == 1 || pass_active) && p >= 1 && p < d && delta > overtake_delta &&
                    u[s] < prob;
          swaps[s] = seg.bits(__ballot_sync(kFull, swap[s]));
          any_swap |= swaps[s];
        }
        pass_active = any_swap != 0u;
        // no swap: the chain below gives every position its own time back
        if (!seg.warp_any(pass_active)) continue;
        // closed form of the sequential time-rewrite chain: prefix max of z,
        // a scan within each slot that carries the slot before's maximum
        float z[R];
#pragma unroll
        for (int s = 0; s < R; ++s) z[s] = swap[s] ? -kInf : r_cum[s] + tenth(s);
        const int span = (R == 1 && G == 1) ? d : L;
#pragma unroll
        for (int s = 0; s < R; ++s) {
          for (int dist = 1; dist < span; dist <<= 1) {
            const float up = __shfl_up_sync(kFull, z[s], dist);
            if (sl >= dist) z[s] = fmaxf(z[s], up);
          }
          if (s > 0) z[s] = fmaxf(z[s], seg.shfl(z[s > 0 ? s - 1 : 0], L - 1));
        }
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const float a = swap[s] ? fmaxf(0.1f, z[s] - tenth(s)) : r_cum[s];
          // the swap at position p + 1: this slot's next lane, or lane 0 of
          // the next slot
          const unsigned next = sl < L - 1 ? (swaps[s] >> (sl + 1)) & 1u
                                           : (s + 1 < R ? swaps[s + 1 < R ? s + 1 : s] & 1u : 0u);
          const bool swap_next = next && sl + L * s + 1 < d;
          pos_a[sl + L * s] = swap_next ? fmaxf(0.1f, a - 0.1f) + 0.3f : a;
        }
        __syncwarp();
        // write back: each car reads its position
#pragma unroll
        for (int j = 0; j < R; ++j) cum[j] = pos_a[orank[j]];
      }

      // position / DRS update: pos_a holds the times by position, pos_b the
      // last laps
      {
        int key[R];
#pragma unroll
        for (int j = 0; j < R; ++j) key[j] = dnf[j] ? kDnfKey + car[j] : rank_key<T>(cum[j], car[j]);
        rank_of<R, L>(keys, key, real, sl, d, urank);
      }
#pragma unroll
      for (int j = 0; j < R; ++j) timing[j] = dnf[j] ? kInf : cum[j];
      leader = min_over<R>(seg, timing);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!dnf[j]) behind[j] = cum[j] - leader;
        if (real[j]) {
          pos_a[urank[j]] = cum[j];
          pos_b[urank[j]] = last_lap[j];
        }
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool has_ahead = real[j] && urank[j] > 0;
        const int ahead = has_ahead ? urank[j] - 1 : 0;
        const float ahead_cum = has_ahead ? pos_a[ahead] : 0.0f;
        ahead_ll[j] = has_ahead ? pos_b[ahead] : 0.0f;
        const float gap_ahead = cum[j] - ahead_cum;
        drs[j] = lap_f > 2.0f && !(lap_f <= drs_until) && has_ahead && gap_ahead < 1.0f && !dnf[j];
      }
    }

    // ---- classification: (dnf, dnf_lap desc, cum desc, row) ----------------------
    // every car's timing, DNF lap, time and DNF flag go to the segment's rows
    // by car index; padding slots hold timing kInf and no DNF flag, so they
    // never count against a real car
    float* by_timing = reinterpret_cast<float*>(keys);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      timing[j] = dnf[j] ? kInf : cum[j];
      by_timing[car[j]] = timing[j];
      pos_b[car[j]] = cum[j];
      pos_c[car[j]] = (real[j] && dnf[j]) ? 1.0f : 0.0f;
    }
    __syncwarp();
    int active_rank[R], dnf_rank[R];
    float dnf_lap[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      active_rank[j] = dnf_rank[j] = 0;
      dnf_lap[j] = dnf_laps[car[j]];
    }
    auto count = [&](float kc, float lap_c, float cum_c, float dnf_c, int c) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        active_rank[j] += (kc < timing[j]) || (kc == timing[j] && c < car[j]);
        const bool greater = lap_c > dnf_lap[j] ||
                             (lap_c == dnf_lap[j] && (cum_c > cum[j] || (cum_c == cum[j] && c < car[j])));
        dnf_rank[j] += greater && dnf_c != 0.0f && dnf[j];
      }
    };
    for_each_quad<kRow>(d, [&](int q) {
      const float4 kt = reinterpret_cast<const float4*>(by_timing)[q];
      const float4 kl = reinterpret_cast<const float4*>(dnf_laps)[q];
      const float4 kc = reinterpret_cast<const float4*>(pos_b)[q];
      const float4 kd = reinterpret_cast<const float4*>(pos_c)[q];
      count(kt.x, kl.x, kc.x, kd.x, 4 * q);
      count(kt.y, kl.y, kc.y, kd.y, 4 * q + 1);
      count(kt.z, kl.z, kc.z, kd.z, 4 * q + 2);
      count(kt.w, kl.w, kc.w, kd.w, 4 * q + 3);
    });
    int n_active = 0;
#pragma unroll
    for (int s = 0; s < R; ++s) n_active += __popc(seg.bits(__ballot_sync(kFull, real[s] && !dnf[s])));
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int final_pos = dnf[j] ? n_active + dnf_rank[j] : active_rank[j];
      if (real[j] && counted) atomicAdd(&hist[car[j] * d + final_pos], 1);
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const int c = hist[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

// K1: one race, a 1-D grid over its simulations.
template <int R, int G>
__global__ void __launch_bounds__(max_threads<R, G>())
    race_kernel(const float* __restrict__ pmat, const float* __restrict__ scal_g,
                const float* __restrict__ grid_log, int* __restrict__ counts, int d,
                int race_laps, uint32_t key0, uint32_t key1, uint32_t sim_offset,
                uint32_t n_sims) {
  race_block<R, G>(pmat, scal_g, grid_log, counts, d, race_laps, key0, key1, sim_offset, n_sims,
                   blockIdx.x, gridDim.x);
}

// K2: a season, grid (blocks_per_race, R). Row blockIdx.y is race r: its
// inputs, lap count, key words and histogram; its simulations are
// sim_offset + [0, n_sims) of its own stream, so race r equals K1 at race r's
// seed and the same simulation range bit for bit. A shard of a split season
// (ops/race_kernel.season_counts_sharded) runs its own range of every race.
template <int R, int G>
__global__ void __launch_bounds__(max_threads<R, G>())
    season_kernel(const float* __restrict__ pmat_s, const float* __restrict__ scal_s,
                  const float* __restrict__ grid_log_s, const int* __restrict__ race_laps,
                  const uint32_t* __restrict__ keys, int* __restrict__ counts, int d,
                  uint32_t sim_offset, uint32_t n_sims) {
  const int r = blockIdx.y;
  race_block<R, G>(pmat_s + (size_t)r * d * N_PCOLS, scal_s + (size_t)r * N_SCALARS,
                   grid_log_s + (size_t)r * d * d, counts + (size_t)r * d * d, d, race_laps[r],
                   keys[2 * r], keys[2 * r + 1], sim_offset, n_sims, blockIdx.x, gridDim.x);
}

// the warps' rows, the per-car constants, the scalars and the histogram
size_t shared_bytes(int d, int warps_per_block, int r, int g) {
  return (size_t)(warp_words(r, g) * warps_per_block + N_CROWS * (32 / g) * r + 32 + d * d) *
         sizeof(int);
}

// More than 48 KB of dynamic shared memory (the histogram alone is 64 KB at
// D = 128) needs the kernel's opt-in first; a launch over the limit would be
// refused.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int R, int G>
int launch_race(const float* pmat, const float* scal, const float* grid_log, int* counts, int d,
                int race_laps, uint32_t key0, uint32_t key1, uint32_t sim_offset,
                uint32_t n_sims, int warps_per_block, int n_blocks, cudaStream_t stream) {
  const size_t smem = shared_bytes(d, warps_per_block, R, G);
  const cudaError_t err = allow_shared(race_kernel<R, G>, smem);
  if (err != cudaSuccess) return (int)err;
  race_kernel<R, G><<<n_blocks, 32 * warps_per_block, smem, stream>>>(
      pmat, scal, grid_log, counts, d, race_laps, key0, key1, sim_offset, n_sims);
  return (int)cudaGetLastError();
}

template <int R, int G>
int launch_season(const float* pmat_s, const float* scal_s, const float* grid_log_s,
                  const int* race_laps, const uint32_t* keys, int* counts, int n_races, int d,
                  uint32_t sim_offset, uint32_t n_sims, int warps_per_block,
                  int blocks_per_race, cudaStream_t stream) {
  const size_t smem = shared_bytes(d, warps_per_block, R, G);
  const cudaError_t err = allow_shared(season_kernel<R, G>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks_per_race, n_races);
  season_kernel<R, G><<<grid, 32 * warps_per_block, smem, stream>>>(
      pmat_s, scal_s, grid_log_s, race_laps, keys, counts, d, sim_offset, n_sims);
  return (int)cudaGetLastError();
}

// 0 for a block larger than the kernel's __launch_bounds__: the occupancy
// calculator counts registers and shared memory only, and such a launch fails.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem, int warps_per_block) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  if (32 * warps_per_block > attr.maxThreadsPerBlock) return 0;
  int n = 0;
  if (allow_shared(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * warps_per_block, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

template <int R, int G>
int blocks_per_sm_r(int d, int warps_per_block, int season) {
  const size_t smem = shared_bytes(d, warps_per_block, R, G);
  return season ? blocks_per_sm(season_kernel<R, G>, smem, warps_per_block)
                : blocks_per_sm(race_kernel<R, G>, smem, warps_per_block);
}

}  // namespace

// The instance that runs a field of d drivers: its cars a lane and its
// simulations a warp. Every entry point below dispatches on these; the
// wrapper (ops/race_kernel.py::kernel_tier, which sizes the launches) checks
// its own rule against them when it loads the library.
extern "C" int mcgp_sims_per_warp(int d) { return d <= kPackedDrivers ? kPackedSims : 1; }
extern "C" int mcgp_cars_per_lane(int d) {
  return d <= kPackedDrivers ? kPackedCars : (d + 31) / 32;
}

// How many blocks of `warps_per_block` warps of K1 (season = 0) or K2
// (season = 1) fit on one SM at once for a field of d drivers, from the
// kernel's registers and shared memory; -1 on a CUDA error.
extern "C" int mcgp_blocks_per_sm(int d, int warps_per_block, int season) {
  if (d < 1 || d > kMaxDrivers || warps_per_block < 1 || warps_per_block > 32) return -1;
  if (mcgp_sims_per_warp(d) > 1)
    return blocks_per_sm_r<kPackedCars, kPackedSims>(d, warps_per_block, season);
  switch (mcgp_cars_per_lane(d)) {
    case 1: return blocks_per_sm_r<1, 1>(d, warps_per_block, season);
    case 2: return blocks_per_sm_r<2, 1>(d, warps_per_block, season);
    case 3: return blocks_per_sm_r<3, 1>(d, warps_per_block, season);
    default: return blocks_per_sm_r<4, 1>(d, warps_per_block, season);
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
#define MCGP_LAUNCH_RACE(R, G)                                                               \
  launch_race<R, G>(pmat, scal, grid_log, counts, d, race_laps, key0, key1, sim_offset, n_sims, \
                    warps_per_block, n_blocks, st)
  if (mcgp_sims_per_warp(d) > 1) return MCGP_LAUNCH_RACE(kPackedCars, kPackedSims);
  switch (mcgp_cars_per_lane(d)) {
    case 1: return MCGP_LAUNCH_RACE(1, 1);
    case 2: return MCGP_LAUNCH_RACE(2, 1);
    case 3: return MCGP_LAUNCH_RACE(3, 1);
    default: return MCGP_LAUNCH_RACE(4, 1);
  }
#undef MCGP_LAUNCH_RACE
}

// pmat_s (R, d, 8), scal_s (R, 24), grid_log_s (R, d, d) float32; race_laps
// (R,) int32; keys (R, 2) uint32 key words; counts (R, d, d) int32 zeroed by
// the caller; d <= 128. Every race runs simulations sim_offset + [0, n_sims)
// of its stream. Returns the first CUDA error of the shared-memory opt-in and
// the launch.
extern "C" int mcgp_season_counts(const float* pmat_s, const float* scal_s,
                                  const float* grid_log_s, const int* race_laps,
                                  const uint32_t* keys, int* counts, int n_races, int d,
                                  uint32_t sim_offset, uint32_t n_sims, int warps_per_block,
                                  int blocks_per_race, void* stream) {
  if (d < 1 || d > kMaxDrivers || warps_per_block < 1 || warps_per_block > 32 ||
      blocks_per_race < 1 || n_races < 1 || n_races > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define MCGP_LAUNCH_SEASON(R, G)                                                            \
  launch_season<R, G>(pmat_s, scal_s, grid_log_s, race_laps, keys, counts, n_races, d,       \
                      sim_offset, n_sims, warps_per_block, blocks_per_race, st)
  if (mcgp_sims_per_warp(d) > 1) return MCGP_LAUNCH_SEASON(kPackedCars, kPackedSims);
  switch (mcgp_cars_per_lane(d)) {
    case 1: return MCGP_LAUNCH_SEASON(1, 1);
    case 2: return MCGP_LAUNCH_SEASON(2, 1);
    case 3: return MCGP_LAUNCH_SEASON(3, 1);
    default: return MCGP_LAUNCH_SEASON(4, 1);
  }
#undef MCGP_LAUNCH_SEASON
}
