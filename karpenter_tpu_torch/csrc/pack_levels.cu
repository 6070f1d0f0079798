// K6: the constrained [L, G, T] pack dispatch on Hopper (sm_90a): the round
// loop of every relaxation level in one launch, then the level selection.
//
// Replaces karpenter_tpu/ops/pack_kernel.py::pack_kernel_levels with
// _pack_one_level and _fill_one_node_constrained: a vmap over the L levels of
// a data-dependent lax.while_loop whose every round greedily fills one empty
// node of every instance type under the level's masks (a sequential scan
// over the G' sub-groups, vmapped over the T types), picks one type,
// replicates its fill as often as the counts allow, and stops when every
// pod is placed or set aside; then the strictest level with the fewest
// misses wins. Per level l, group g and type t the scan honours:
//   * usable[l, g, t] = allow[l, g, t] & (vectors[g] <= capacity[t] + 1e-6)
//     & valid[t]; a group no type admits retires into the unschedulable
//     count before the first round;
//   * conflict[g, h]: g is skipped on a node that already holds h;
//   * node_cap[g]: at most this many pods of g a node;
//   * the fill aborts only when the first eligible group (counts > 0,
//     usable) places 0 pods; ineligible and conflicted groups are skipped.
//
// What bounds it on this card: latency, as in K2 (csrc/pack_rounds.cu): a
// round is as long as one type's dependent scan over its groups plus the
// round's fixed steps (the selection across the cluster, the apply), and
// every round depends on the one before; the levels are independent.
//
// What the design does about it: a thread-block cluster a level (L <= 8
// after padding; padded levels repeat the last real one), each running its
// level's whole round loop on the card with no host sync:
//   * the level's types are split over the cluster's blocks, block b owning
//     [b * TB, (b + 1) * TB); inside a block a type's scan is split over
//     `lanes` adjacent lanes by resource axis (lane j the axes j, j + lanes,
//     ...), so a group's n_fit is one division a lane and a shuffle minimum
//     (exact: the minimum does not depend on the order); every lane of a type
//     keeps the node's placed bits, lane 0 its sum, weighted and pen in the
//     reference's order;
//   * each block packs its types' usable masks once into 32-bit words and
//     copies their penalty column, and the conflict rows into 32-bit words per
//     group, so the conflict test is O(G' / 32) word ANDs against the node's
//     `placed` bits (in registers up to G' 256, else in global scratch);
//     groups whose row is empty skip it;
//   * a type's scan visits only its eligible groups, the set bits of the
//     words of groups with pods left (kept by the round's bookkeeping) ANDed
//     with its usable words; the others place nothing and cannot abort;
//   * the weighted dot's 8 lanes (from G' 64 on) are spread over the type's
//     threads and summed in its first;
//   * a block's fills live [G', TB] (consecutive across a warp), twice (by the
//     round's parity), in shared memory while they fit, else in global scratch;
//     its tables (vectors, weights, axis masks, counts, caps, conflict rows,
//     usable words, penalties) go to global scratch too past shared memory,
//     so no G' is refused;
//   * the selection: a block's 64-bit (score, index) key (cost; ffd keys on
//     (largest sum, lowest index)) by a warp reduction and a shared-memory
//     atomic, written into every block of the cluster through distributed
//     shared memory; after cluster.sync() every block takes the minimum over
//     the ranks in order and applies the round itself, reading the chosen
//     type's fills from its owner's shared memory, so every block holds the
//     same counts and no second barrier is needed (the fills and keys are
//     double-buffered: a block a round ahead writes the other half); the
//     cluster's first block writes the round out.
// A second launch (select_kernel) computes each level's misses
// (unschedulable + shortfall + 2^30 on overflow), the first minimum, each
// group's first feasible level, and copies the chosen level's rounds into
// the reference's dense word layout.
//
// Hazards for rounds that are bit-identical to the reference:
//   * n_fit = floor(min_r(remaining / vec) + 1e-4) with a correctly rounded
//     division (__fdiv_rn; never --use_fast_math), a zero remaining taking
//     the select in place of the division's slow path; the float-to-int
//     conversion saturates (an all-zero vector's +inf), as XLA's does.
//   * remaining - n * vec: __fmul_rn and __fsub_rn, never an FMA (the build
//     passes --fmad=false besides).
//   * n = min(count, n_fit, node_cap[g]); placed is set only where n > 0;
//     invalid types fill nothing.
//   * ffd takes the largest sum over all types as the bound and the
//     smallest valid type achieving it (> 0).
//   * cost: score = (price + pen) / max(weighted, 1e-9), +inf where nothing
//     packs, ties to the lowest index. The reference's XLA program on the
//     CPU takes weighted = fills @ group_weight below G' 64 as a sequential
//     chain of fused multiply-adds over ascending g (__fmaf_rn here), from
//     64 on in the vectorised order of weighted_lane / weighted_total, and
//     pen = sum_g fill * penalty as the same chain up to G' 32; past 32 as
//     rounded products summed in windows of 32 consecutive groups, the
//     window sums again in windows of 32 while more than 32 remain, then in
//     order (XLA's tree reduction rewrite). Groups that place nothing add
//     exact zeros and are skipped.
//   * repl = max(min over fill > 0 of counts // fill, 1); a round with no
//     pack retires the first active group's count to unschedulable.
//   * the loop runs while counts remain and iters < MR + G'; a round past MR
//     is dropped, as the reference's scatter drops it, and overflow reports
//     it; num_rounds is min(rounds, MR).
//   * group_weight from the last valid type's capacity floored at 1.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr int kModeFfd = 0;
constexpr int kModeCost = 1;
constexpr int kDefaultSharedLimit = 48 * 1024;
constexpr int kRegisterWords = 8;  // placed bits in registers up to G' 256
constexpr int kWindow = 32;        // XLA's reduce-window size on the CPU
constexpr int kMaxWindowDepth = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kSelectThreads = 256;
constexpr int kOverflowMiss = 1 << 30;
constexpr int kMaxCluster = 16;      // 16 needs the non-portable attribute
constexpr int kPortableCluster = 8;

// Word offsets of one level's rounds: the reference's dense layout (the
// same as K2's).
struct Layout {
  int round_type, round_fill, round_repl, num_rounds, unschedulable, overflow, words;
};

__host__ __device__ inline Layout make_layout(int groups, int max_rounds) {
  Layout l;
  l.round_type = 0;
  l.round_fill = max_rounds;
  l.round_repl = l.round_fill + max_rounds * groups;
  l.num_rounds = l.round_repl + max_rounds;
  l.unschedulable = l.num_rounds + 1;
  l.overflow = l.unschedulable + groups;
  l.words = l.overflow + 1;
  return l;
}

__host__ __device__ inline int bit_words(int groups) { return (groups + 31) / 32; }

// A block's control words, at the front of its shared memory. keys and
// packs are written by every block of the cluster (distributed shared
// memory), one half a round by its parity.
struct Control {
  unsigned long long key;  // this block's best key of the round
  unsigned long long keys[2][kMaxCluster];
  int packs[2][kMaxCluster];
  int largest_valid;  // this block's last valid type
  int largest_all;    // the cluster's
  int first_active, any_active, proceed;
};
constexpr int kControlBytes = 416;
static_assert(sizeof(Control) <= kControlBytes, "Control outgrew its bytes");

// Words of one block's tables: [G, R] vectors, [G] weights, axis masks,
// counts, node caps and packable flags, the [G, W] conflict rows, the
// [W, TB] usable words and the [G, TB] penalties of its types, the [W]
// words of the groups with pods left.
__host__ __device__ inline size_t table_words(int groups, int types_per_block, int dims) {
  const size_t g = groups, tb = types_per_block, w = bit_words(groups);
  return g * dims + 5 * g + g * w + w * tb + g * tb + w;
}

// A block's fills: [2, G, TB] (by the round's parity).
__host__ __device__ inline size_t fill_words(int groups, int types_per_block) {
  return 2 * size_t(groups) * types_per_block;
}

__host__ __device__ inline size_t shared_bytes(int groups, int types_per_block, int dims,
                                               bool fills_in_shared, bool tables_in_shared) {
  size_t bytes = kControlBytes;
  if (tables_in_shared) bytes += sizeof(int) * table_words(groups, types_per_block, dims);
  if (fills_in_shared) bytes += sizeof(int) * fill_words(groups, types_per_block);
  return bytes;
}

// Window levels of pen past 32 groups: 0 up to 32 (one FMA chain), else the
// number of reduce-window passes until at most 32 sums remain.
__host__ __device__ inline int window_depth(int groups) {
  int depth = 0;
  long long remaining = groups;
  while (remaining > kWindow) {
    remaining = (remaining + kWindow - 1) / kWindow;
    ++depth;
  }
  return depth;
}

// a / b for b > 0, with a zero dividend kept off the division's slow path.
__device__ __forceinline__ float div_pos(float a, float b) {
  const unsigned bits = __float_as_uint(a);
  const bool zero = (bits << 1) == 0u;
  const float q = __fdiv_rn(__uint_as_float(zero ? 0x3f800000u : bits), b);
  return zero ? a : q;
}

// weighted = fills @ group_weight from 64 groups on, in the order the
// reference's XLA program on the CPU takes it (ops/pack_kernel.py
// _dot_plan and _weighted_sums): LLVM vectorises the dot 8 lanes by A
// accumulators, a chunk 8 groups. Over 9 rows (types, or levels x types)
// or more, A is 4 and the steps of 32 groups unroll at two steps only;
// over one row likewise, unrolled up to 256 groups; over 2 to 8 rows the
// fills are read with a stride: A is 2 at 64 groups and 4 past it, the
// last step is left to the scalar chain, and the steps unroll up to 256
// groups. Unrolled, a lane is one chain: accumulator 0's chunks over the
// steps in order, then each later accumulator's over the steps 1, 0, 2,
// 3, ...; looped, each accumulator chains its chunks in order and the A
// chains are added in turn. The lanes are summed pairwise, then the groups
// past the vectorised steps chain on. Fused multiply-adds throughout; a
// fill of 0 adds an exact 0. Below 64 groups the order is one chain over
// ascending g, which the scan accumulates. The kernel spreads the 8 lanes
// over a type's threads (weighted_lane) and sums them in its first
// (weighted_total).
constexpr int kDotSteps = 32;
constexpr int kDotLanes = 8;
constexpr int kNarrowRows = 8;
constexpr int kUnrolledGroups = 256;

struct DotPlan {
  int accumulators, steps;
  bool unrolled;
};

__device__ __forceinline__ DotPlan dot_plan(int groups, int rows) {
  DotPlan plan;
  plan.accumulators = 4;
  if (rows > kNarrowRows) {
    plan.steps = groups / kDotSteps;
    plan.unrolled = plan.steps < 4;
  } else if (rows == 1) {
    plan.steps = groups / kDotSteps;
    plan.unrolled = groups <= kUnrolledGroups;
  } else {
    plan.accumulators = groups <= 2 * kDotSteps ? 2 : 4;
    plan.steps = groups / (kDotLanes * plan.accumulators) - 1;
    plan.unrolled = groups <= kUnrolledGroups;
  }
  return plan;
}

// Lane j of the dot's 8: its chain of fused multiply-adds in the
// reference's order. A fill of 0 adds an exact 0 (the chain is never -0),
// so it is skipped.
__device__ __forceinline__ float weighted_lane(const int* fills, int stride, const float* weight,
                                               DotPlan plan, int j) {
  const int step = kDotLanes * plan.accumulators;
  auto term = [&](int g, float acc) {
    const int fill = fills[size_t(g) * stride];
    return fill != 0 ? __fmaf_rn(static_cast<float>(fill), weight[g], acc) : acc;
  };
  float acc = 0.0f;
  if (plan.unrolled) {
    for (int i = 0; i < plan.steps; ++i) acc = term(step * i + j, acc);
    for (int u = 1; u < plan.accumulators; ++u) {
      for (int k = 0; k < plan.steps; ++k) {
        const int i = (plan.steps >= 2 && k < 2) ? 1 - k : k;
        acc = term(step * i + kDotLanes * u + j, acc);
      }
    }
  } else {
    for (int u = 0; u < plan.accumulators; ++u) {
      float chain = 0.0f;
      for (int i = 0; i < plan.steps; ++i) chain = term(step * i + kDotLanes * u + j, chain);
      acc = u == 0 ? chain : __fadd_rn(chain, acc);
    }
  }
  return acc;
}

// The 8 lanes summed pairwise, then the groups past the vectorised steps
// chained on.
__device__ __forceinline__ float weighted_total(const float* lanes, const int* fills, int stride,
                                                const float* weight, int groups, DotPlan plan) {
  float total = __fadd_rn(__fadd_rn(__fadd_rn(lanes[0], lanes[4]), __fadd_rn(lanes[2], lanes[6])),
                          __fadd_rn(__fadd_rn(lanes[1], lanes[5]), __fadd_rn(lanes[3], lanes[7])));
  for (int g = plan.steps * kDotLanes * plan.accumulators; g < groups; ++g) {
    total = __fmaf_rn(static_cast<float>(fills[size_t(g) * stride]), weight[g], total);
  }
  return total;
}

__device__ inline unsigned int orderable(float value) {
  const unsigned int bits = __float_as_uint(value);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ inline unsigned long long warp_min_key(unsigned long long key) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFullMask, key, offset);
    key = other < key ? other : key;
  }
  return key;
}

// kLanes: the lanes that scan one type, a lane an axis (1, 2, 4 or 8).
// kRegisterPlaced: the node's placed bits in registers (G' <= 256), else in
// this thread's column of placed_scratch [W, threads]. kTablesInShared is
// known at compile time so that the scan's table reads are shared-memory
// loads, not generic ones.
template <int kLanes, bool kRegisterPlaced, bool kTablesInShared>
__global__ void __launch_bounds__(kMaxThreads)
pack_levels_kernel(const float* __restrict__ vectors,        // [G, R]
                   const int* __restrict__ level_counts,     // [L, G]
                   const float* __restrict__ capacity,       // [T, R]
                   const unsigned char* __restrict__ valid,  // [T]
                   const float* __restrict__ prices,         // [T]
                   const unsigned char* __restrict__ allow,  // [L, G, T]
                   const float* __restrict__ penalty,        // [L, G, T]
                   const unsigned char* __restrict__ conflict,  // [G, G]
                   const int* __restrict__ node_cap,         // [G]
                   int groups, int types, int dims, int levels, int mode,
                   int* __restrict__ level_out,              // [L, words]
                   int* __restrict__ fill_scratch,           // [L * cluster, 2, G, TB] or null
                   int* __restrict__ table_scratch,          // [L * cluster, table words] or null
                   unsigned* __restrict__ placed_scratch) {  // [L * cluster, W, threads] or null
  constexpr int kAxes = kMaxDims / kLanes;  // the axes one lane holds
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Control* control = reinterpret_cast<Control*>(shared_raw);
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool leader = rank == 0;
  const int level = blockIdx.x / blocks;
  const int slice = level * blocks + rank;  // this block's slice of the scratch
  const int tb = (types + blocks - 1) / blocks;
  const int t0 = rank * tb;
  const int nt = max(0, min(tb, types - t0));  // the types this block owns
  const int words_g = bit_words(groups);
  const size_t table_size = table_words(groups, tb, dims);
  int* tables = kTablesInShared
                    ? reinterpret_cast<int*>(shared_raw + kControlBytes)
                    : table_scratch + size_t(slice) * table_size;
  float* s_vectors = reinterpret_cast<float*>(tables);            // [G, R]
  float* s_weight = s_vectors + size_t(groups) * dims;            // [G]
  int* s_axes = reinterpret_cast<int*>(s_weight + groups);        // [G]
  int* s_counts = s_axes + groups;                                // [G]
  int* s_cap = s_counts + groups;                                 // [G]
  int* s_packable = s_cap + groups;                               // [G]
  unsigned* s_conflict = reinterpret_cast<unsigned*>(s_packable + groups);  // [G, W]
  unsigned* s_usable = s_conflict + size_t(groups) * words_g;     // [W, TB]
  float* s_pen = reinterpret_cast<float*>(s_usable + size_t(words_g) * tb);  // [G, TB]
  unsigned* s_active = reinterpret_cast<unsigned*>(s_pen + size_t(groups) * tb);  // [W]
  const size_t fill_size = fill_words(groups, tb);
  int* fills = fill_scratch == nullptr
                   ? reinterpret_cast<int*>(shared_raw + kControlBytes) +
                         (kTablesInShared ? table_size : 0)
                   : fill_scratch + size_t(slice) * fill_size;  // [2, G, TB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int part = tid % kLanes;  // this lane's share of its type's axes
  const int slot = tid / kLanes;
  const int slots = threads / kLanes;
  const int type_iters = (tb + slots - 1) / slots;
  // The lanes of one type, for their shuffles (they take the same branches).
  const unsigned type_mask =
      kLanes == 32 ? kFullMask : (((1u << kLanes) - 1u) << (lane & ~(kLanes - 1)));
  const int max_rounds = 2 * groups + 8;
  const Layout layout = make_layout(groups, max_rounds);
  int* o = level_out + size_t(level) * layout.words;
  const int* counts_in = level_counts + size_t(level) * groups;
  const unsigned char* allow_l = allow + size_t(level) * groups * types;
  const float* penalty_l = penalty + size_t(level) * groups * types;
  unsigned* placed_column =
      kRegisterPlaced ? nullptr : placed_scratch + size_t(slice) * words_g * threads + tid;
  const int depth = window_depth(groups);

  // Another block's copy of a table word: through distributed shared memory,
  // or its slice of the global scratch past the SM's L1.
  auto remote_int = [&](const int* mine, int b) -> int {
    if (kTablesInShared) return *cluster.map_shared_rank(const_cast<int*>(mine), b);
    return __ldcg(mine + (static_cast<ptrdiff_t>(b) - rank) * static_cast<ptrdiff_t>(table_size));
  };
  // Cell (g, local type) of block b's fills of a round.
  auto remote_fill = [&](int b, int half, int g, int local) -> int {
    const size_t index = size_t(half) * groups * tb + size_t(g) * tb + local;
    if (fill_scratch == nullptr) return cluster.map_shared_rank(fills, b)[index];
    return __ldcg(fill_scratch + size_t(level * blocks + b) * fill_size + index);
  };

  if (leader) {
    for (int i = tid; i < layout.words; i += threads) o[i] = 0;
  }
  for (int i = tid; i < groups * dims; i += threads) s_vectors[i] = vectors[i];
  for (int g = tid; g < groups; g += threads) {
    int axes = 0;
    for (int r = 0; r < dims; ++r) {
      const float v = vectors[g * dims + r];
      if (v > 0.0f) axes |= 1 << r;
      if (v != 0.0f) axes |= 1 << (8 + r);
    }
    unsigned any_conflict = 0;
    for (int w = 0; w < words_g; ++w) {
      unsigned row = 0;
      for (int b = 0; b < 32 && w * 32 + b < groups; ++b) {
        if (conflict[size_t(g) * groups + w * 32 + b] != 0) row |= 1u << b;
      }
      s_conflict[size_t(g) * words_g + w] = row;
      any_conflict |= row;
    }
    if (any_conflict != 0) axes |= 1 << 16;
    s_axes[g] = axes;
    s_cap[g] = node_cap[g];
    s_packable[g] = 0;
  }
  for (int i = tid; i < groups * nt; i += threads) {
    const int g = i / nt;
    const int tl = i - g * nt;
    s_pen[size_t(g) * tb + tl] = penalty_l[size_t(g) * types + t0 + tl];
  }
  if (tid == 0) {
    control->key = kNoKey;
    control->largest_valid = -1;
  }
  __syncthreads();

  // The usable bits of this block's types, [W, TB], and which groups they
  // admit; its last valid type.
  int largest = -1;
  for (int tl = tid; tl < nt; tl += threads) {
    const int t = t0 + tl;
    const bool type_valid = valid[t] != 0;
    if (type_valid) largest = t;
    for (int w = 0; w < words_g; ++w) {
      unsigned bits = 0;
      for (int b = 0; b < 32 && w * 32 + b < groups; ++b) {
        const int g = w * 32 + b;
        bool ok = type_valid && allow_l[size_t(g) * types + t] != 0;
        for (int r = 0; ok && r < dims; ++r) {
          ok = s_vectors[g * dims + r] <= __fadd_rn(capacity[size_t(t) * dims + r], 1e-6f);
        }
        if (ok) {
          bits |= 1u << b;
          s_packable[g] = 1;  // every writer writes 1
        }
      }
      s_usable[size_t(w) * tb + tl] = bits;
    }
  }
  largest = __reduce_max_sync(kFullMask, largest);
  if (lane == 0 && largest >= 0) atomicMax(&control->largest_valid, largest);
  __syncthreads();
  if (!kTablesInShared) __threadfence();
  cluster.sync();
  // Over the cluster: the groups some type admits, the last valid type.
  if (tid == 0) {
    int most = -1;
    for (int b = 0; b < blocks; ++b) {
      most = max(most, cluster.map_shared_rank(&control->largest_valid, b)[0]);
    }
    control->largest_all = most < 0 ? types - 1 : most;
  }
  __syncthreads();
  const int largest_valid = control->largest_all;
  // Groups no type admits retire at once; the weights for cost mode.
  for (int g = tid; g < groups; g += threads) {
    int packable = 0;
    for (int b = 0; b < blocks; ++b) packable |= remote_int(s_packable + g, b);
    const int count = counts_in[g];
    s_counts[g] = packable != 0 ? count : 0;
    if (leader && packable == 0) o[layout.unschedulable + g] = count;
    float weight = -INFINITY;
    for (int r = 0; r < dims; ++r) {
      const float ref = fmaxf(capacity[size_t(largest_valid) * dims + r], 1.0f);
      weight = fmaxf(weight, __fdiv_rn(s_vectors[g * dims + r], ref));
    }
    s_weight[g] = weight;
  }
  __syncthreads();

  int iters = 0;
  int num_rounds = 0;
  auto publish_state = [&]() {
    int total = 0;
    int first = -1;
    for (int base = 0; base < groups; base += 32) {
      const int g = base + lane;
      const int count = g < groups ? s_counts[g] : 0;
      total += count;
      const unsigned active = __ballot_sync(kFullMask, count > 0);
      if (first < 0 && active != 0) first = base + __ffs(active) - 1;
      if (lane == 0) s_active[base >> 5] = active;
    }
    total = __reduce_add_sync(kFullMask, total);
    if (lane == 0) {
      control->first_active = first < 0 ? 0 : first;
      control->any_active = first >= 0;
      control->proceed = total > 0 && iters < max_rounds + groups;
      control->key = kNoKey;
    }
    return total;
  };
  if (warp == 0) publish_state();
  __syncthreads();

  unsigned placed_reg[kRegisterPlaced ? kRegisterWords : 1];

  while (control->proceed) {
    const int half = iters & 1;
    int* round_fills = fills + size_t(half) * groups * tb;
    const bool any_active = control->any_active != 0;
    unsigned long long best = kNoKey;
    int packs_any = 0;

    for (int k = 0; k < type_iters; ++k) {
      const int tl = slot + k * slots;
      if (tl >= nt) break;  // every lane of a type leaves together
      const int t = t0 + tl;
      int* fill_column = round_fills + tl;
      int sum = 0;
      float weighted = 0.0f;
      float pen[kMaxWindowDepth + 1];
#pragma unroll
      for (int d = 0; d <= kMaxWindowDepth; ++d) pen[d] = 0.0f;
      const bool type_valid = valid[t] != 0;
      // Every group places 0 unless the scan below places it.
      if (part == 0) {
        for (int g = 0; g < groups; ++g) fill_column[size_t(g) * tb] = 0;
      }
      if (type_valid && any_active) {
        float remaining[kAxes];
#pragma unroll
        for (int j = 0; j < kAxes; ++j) {
          const int r = part + j * kLanes;
          remaining[j] = r < dims ? capacity[size_t(t) * dims + r] : 0.0f;
        }
        if (kRegisterPlaced) {
#pragma unroll
          for (int w = 0; w < kRegisterWords; ++w) placed_reg[w] = 0u;
        } else {
          for (int w = 0; w < words_g; ++w) placed_column[size_t(w) * threads] = 0u;
        }
        // The scan visits only the eligible groups (pods left, usable on
        // this type), in ascending order: the others place nothing and
        // cannot abort the fill. The first eligible group can hold no
        // conflict (nothing is placed before it): if it places nothing, the
        // fill aborts and every group places 0.
        bool first = true;
        int last_packed = -1;  // pen's windows close lazily between packs
        for (int w = 0; w < words_g; ++w) {
          unsigned bits = s_active[w] & s_usable[size_t(w) * tb + tl];
          while (bits != 0u) {
            const int g = (w << 5) + __ffs(bits) - 1;
            bits &= bits - 1u;
            // Every table word of g up front, so the loads overlap.
            const int axes = s_axes[g];
            const int count = s_counts[g];
            const int cap = s_cap[g];
            const float group_weight = s_weight[g];
            const float group_pen = s_pen[size_t(g) * tb + tl];
            const float* vec = s_vectors + g * dims;
            float mine[kAxes];
#pragma unroll
            for (int j = 0; j < kAxes; ++j) {
              const int r = part + j * kLanes;
              mine[j] = r < dims ? vec[r] : 0.0f;
            }
            bool conflicted = false;
            if (axes & (1 << 16)) {
              const unsigned* row = s_conflict + size_t(g) * words_g;
              unsigned hit = 0;
              if (kRegisterPlaced) {
#pragma unroll
                for (int v = 0; v < kRegisterWords; ++v) {
                  if (v < words_g) hit |= placed_reg[v] & row[v];
                }
              } else {
                for (int v = 0; v < words_g; ++v) hit |= placed_column[size_t(v) * threads] & row[v];
              }
              conflicted = hit != 0;
            }
            if (conflicted) {
              first = false;
              continue;
            }
            float ratio = INFINITY;
#pragma unroll
            for (int j = 0; j < kAxes; ++j) {
              const int r = part + j * kLanes;
              if (r < dims && (axes >> r) & 1) ratio = fminf(ratio, div_pos(remaining[j], mine[j]));
            }
#pragma unroll
            for (int offset = kLanes / 2; offset > 0; offset >>= 1) {
              ratio = fminf(ratio, __shfl_xor_sync(type_mask, ratio, offset));
            }
            const float fit = fmaxf(floorf(__fadd_rn(ratio, 1e-4f)), 0.0f);
            // The conversion saturates (an all-zero vector's +inf).
            const int n = min(min(count, __float2int_rz(fit)), cap);
            if (n == 0) {
              if (first) {
                w = words_g;  // abort: nothing was placed
                break;
              }
              continue;
            }
            first = false;
            const float packed = static_cast<float>(n);
#pragma unroll
            for (int j = 0; j < kAxes; ++j) {
              const int r = part + j * kLanes;
              if (r < dims && (axes >> (8 + r)) & 1) {
                remaining[j] = __fsub_rn(remaining[j], __fmul_rn(packed, mine[j]));
              }
            }
            const unsigned bit = 1u << (g & 31);
            if (kRegisterPlaced) {
#pragma unroll
              for (int v = 0; v < kRegisterWords; ++v) {
                if (v == w) placed_reg[v] |= bit;
              }
            } else {
              placed_column[size_t(w) * threads] |= bit;
            }
            if (part == 0) {
              fill_column[size_t(g) * tb] = n;
              sum += n;
              if (mode == kModeCost) {
                if (groups < 2 * kDotSteps) weighted = __fmaf_rn(packed, group_weight, weighted);
                const float p = group_pen;
                if (depth == 0) {
                  pen[0] = __fmaf_rn(packed, p, pen[0]);
                } else {
                  // Close the windows between the last pack and this one
                  // (an empty window adds an exact 0).
                  if (last_packed >= 0) {
                    int span = kWindow;
                    for (int d = 0; d < depth && last_packed / span != g / span; ++d) {
                      pen[d + 1] = __fadd_rn(pen[d + 1], pen[d]);
                      pen[d] = 0.0f;
                      span *= kWindow;
                    }
                  }
                  last_packed = g;
                  pen[0] = __fadd_rn(pen[0], __fmul_rn(packed, p));
                }
              }
            }
          }
        }
        if (part == 0 && mode == kModeCost) {
          // The windows still open close at the last group.
          for (int d = 0; d < depth; ++d) {
            pen[d + 1] = __fadd_rn(pen[d + 1], pen[d]);
            pen[d] = 0.0f;
          }
        }
        if (mode == kModeCost && groups >= 2 * kDotSteps) {
          // The dot's 8 lanes over the type's threads, summed in its first.
          if (kLanes > 1) __syncwarp(type_mask);  // lane 0's fills are written
          const DotPlan dot = dot_plan(groups, levels * types);
          float mine[kDotLanes / kLanes];
#pragma unroll
          for (int c = 0; c < kDotLanes / kLanes; ++c) {
            mine[c] = weighted_lane(fill_column, tb, s_weight, dot, part + c * kLanes);
          }
          float lanes8[kDotLanes];
#pragma unroll
          for (int j = 0; j < kDotLanes; ++j) {
            lanes8[j] = kLanes == 1 ? mine[j]
                                    : __shfl_sync(type_mask, mine[j / kLanes],
                                                  (lane & ~(kLanes - 1)) + j % kLanes);
          }
          if (part == 0) weighted = weighted_total(lanes8, fill_column, tb, s_weight, groups, dot);
        }
      }
      if (part == 0) {
        unsigned long long key;
        if (mode == kModeCost) {
          const bool packs = sum > 0 && type_valid;
          const float score = packs ? __fdiv_rn(__fadd_rn(prices[t], pen[depth]), fmaxf(weighted, 1e-9f))
                                    : INFINITY;
          packs_any |= packs;
          key = (static_cast<unsigned long long>(orderable(score)) << 32) | static_cast<unsigned>(t);
        } else {
          // The largest sum first, then the lowest index (an invalid type
          // sums 0, so it never holds a positive bound).
          key = (static_cast<unsigned long long>(INT_MAX - sum) << 32) | static_cast<unsigned>(t);
        }
        best = key < best ? key : best;
      }
    }

    // The block's key, then every block's in every block of the cluster.
    best = warp_min_key(best);
    if (lane == 0) atomicMin(&control->key, best);
    const int block_packs = __syncthreads_or(packs_any);
    if (tid == 0) {
      const unsigned long long key = control->key;
      for (int b = 0; b < blocks; ++b) {
        Control* remote = cluster.map_shared_rank(control, b);
        remote->keys[half][rank] = key;
        remote->packs[half][rank] = block_packs;
      }
    }
    if (fill_scratch != nullptr) __threadfence();
    cluster.sync();

    if (warp == 0) {
      unsigned long long key = kNoKey;
      int packs = 0;
      for (int b = 0; b < blocks; ++b) {
        key = control->keys[half][b] < key ? control->keys[half][b] : key;
        packs |= control->packs[half][b];
      }
      const int t_sel = static_cast<int>(key & 0xffffffffull);
      const bool have_pack =
          mode == kModeCost ? packs != 0 : (key != kNoKey && INT_MAX - static_cast<int>(key >> 32) > 0);
      if (have_pack) {
        const int owner = t_sel / tb;
        const int local = t_sel - owner * tb;
        // The chosen fills, read once from the owner up to G' 256.
        const bool cached = groups <= 32 * kRegisterWords;
        int cache[kRegisterWords];
        int repl = INT_MAX;
        if (cached) {
#pragma unroll
          for (int k = 0; k < kRegisterWords; ++k) {
            const int g = lane + 32 * k;
            cache[k] = g < groups ? remote_fill(owner, half, g, local) : 0;
          }
#pragma unroll
          for (int k = 0; k < kRegisterWords; ++k) {
            if (cache[k] > 0) repl = min(repl, s_counts[lane + 32 * k] / cache[k]);
          }
        } else {
          for (int g = lane; g < groups; g += 32) {
            const int fill = remote_fill(owner, half, g, local);
            if (fill > 0) repl = min(repl, s_counts[g] / fill);
          }
        }
        repl = max(__reduce_min_sync(kFullMask, repl), 1);
        const bool write = leader && num_rounds < max_rounds;
        auto take = [&](int g, int fill) {
          if (write) o[layout.round_fill + num_rounds * groups + g] = fill;
          s_counts[g] -= repl * fill;
        };
        if (cached) {
#pragma unroll
          for (int k = 0; k < kRegisterWords; ++k) {
            if (lane + 32 * k < groups) take(lane + 32 * k, cache[k]);
          }
        } else {
          for (int g = lane; g < groups; g += 32) take(g, remote_fill(owner, half, g, local));
        }
        if (lane == 0 && write) {
          o[layout.round_type + num_rounds] = t_sel;
          o[layout.round_repl + num_rounds] = repl;
        }
        ++num_rounds;
      } else {
        // Retire the first group with pods left as unschedulable.
        int first = 0;
        for (int base = 0; base < groups; base += 32) {
          const int g = base + lane;
          const unsigned active = __ballot_sync(kFullMask, g < groups && s_counts[g] > 0);
          if (active != 0) {
            first = base + __ffs(active) - 1;
            break;
          }
        }
        if (lane == 0) {
          if (leader) o[layout.unschedulable + first] += s_counts[first];
          s_counts[first] = 0;
        }
      }
      __syncwarp();
    }
    ++iters;  // every thread: the next round's half is iters & 1
    if (warp == 0) publish_state();
    __syncthreads();
  }

  if (warp == 0) {
    const int total = publish_state();
    if (lane == 0 && leader) {
      o[layout.num_rounds] = min(num_rounds, max_rounds);
      o[layout.overflow] = (total > 0 || num_rounds > max_rounds) ? 1 : 0;
    }
  }
  // No block leaves while another may still read its shared memory.
  cluster.sync();
}

// The level selection, and the chosen level's rounds copied out: every
// block computes the (tiny) selection itself, then copies its share.
// out: [rounds words | chosen level | group_level [G] | level_unsched [L, G]].
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const int* __restrict__ level_out, const int* __restrict__ level_counts,
              int groups, int levels, int* __restrict__ out) {
  __shared__ int s_unsched[8];
  __shared__ int s_assigned[8];
  __shared__ int s_chosen;
  const int tid = threadIdx.x;
  const int max_rounds = 2 * groups + 8;
  const Layout layout = make_layout(groups, max_rounds);
  if (tid < levels) {
    s_unsched[tid] = 0;
    s_assigned[tid] = 0;
  }
  __syncthreads();
  for (int l = 0; l < levels; ++l) {
    int unsched = 0;
    int assigned = 0;
    for (int g = tid; g < groups; g += kSelectThreads) {
      unsched += level_out[size_t(l) * layout.words + layout.unschedulable + g];
      assigned += level_counts[size_t(l) * groups + g];
    }
    unsched = __reduce_add_sync(kFullMask, unsched);
    assigned = __reduce_add_sync(kFullMask, assigned);
    if ((tid & 31) == 0) {
      atomicAdd(&s_unsched[l], unsched);  // int sums: any order, same bits
      atomicAdd(&s_assigned[l], assigned);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int most = INT_MIN;
    for (int l = 0; l < levels; ++l) most = max(most, s_assigned[l]);
    int chosen = 0;
    int best = 0;
    for (int l = 0; l < levels; ++l) {
      const int overflow = level_out[size_t(l) * layout.words + layout.overflow];
      // int32 arithmetic, wrapping as the reference's does.
      const unsigned total = static_cast<unsigned>(s_unsched[l]) +
                             static_cast<unsigned>(most - s_assigned[l]) +
                             static_cast<unsigned>(overflow) * static_cast<unsigned>(kOverflowMiss);
      const int miss = static_cast<int>(total);
      if (l == 0 || miss < best) {
        best = miss;
        chosen = l;
      }
    }
    s_chosen = chosen;
  }
  __syncthreads();
  const int chosen = s_chosen;
  const size_t stride = size_t(gridDim.x) * kSelectThreads;
  const size_t first = size_t(blockIdx.x) * kSelectThreads + tid;
  const int* src = level_out + size_t(chosen) * layout.words;
  for (size_t i = first; i < size_t(layout.words); i += stride) out[i] = src[i];
  int* chosen_out = out + layout.words;
  int* group_level = chosen_out + 1;
  int* level_unsched = group_level + groups;
  if (first == 0) chosen_out[0] = chosen;
  for (size_t g = first; g < size_t(groups); g += stride) {
    int found = levels;
    for (int l = 0; l < levels; ++l) {
      const int* lo = level_out + size_t(l) * layout.words;
      if (lo[layout.unschedulable + g] == 0 && lo[layout.overflow] == 0) {
        found = l;
        break;
      }
    }
    group_level[g] = found;
  }
  for (size_t i = first; i < size_t(levels) * groups; i += stride) {
    const size_t l = i / groups;
    level_unsched[i] = level_out[l * layout.words + layout.unschedulable + (i - l * groups)];
  }
}

}  // namespace

// Words of one level's rounds (the reference's dense layout).
extern "C" int ktt_pack_levels_words(int groups) {
  return make_layout(groups, 2 * groups + 8).words;
}

// Dynamic shared memory of one block of the level kernel, which owns
// types_per_block types.
extern "C" long long ktt_pack_levels_shared_bytes(int groups, int types_per_block, int dims,
                                                  int fills_in_shared, int tables_in_shared) {
  return static_cast<long long>(shared_bytes(groups, types_per_block, dims, fills_in_shared != 0,
                                             tables_in_shared != 0));
}

// Words of one block's slice of the table scratch.
extern "C" long long ktt_pack_levels_table_words(int groups, int types_per_block, int dims) {
  return static_cast<long long>(table_words(groups, types_per_block, dims));
}

// Words of one block's slice of the fill scratch.
extern "C" long long ktt_pack_levels_fill_words(int groups, int types_per_block) {
  return static_cast<long long>(fill_words(groups, types_per_block));
}

namespace {

using LevelsKernel = void (*)(const float*, const int*, const float*, const unsigned char*,
                              const float*, const unsigned char*, const float*,
                              const unsigned char*, const int*, int, int, int, int, int, int*,
                              int*, int*, unsigned*);

template <int kLanes>
LevelsKernel levels_kernel(bool register_placed, bool tables_in_shared) {
  if (register_placed) {
    return tables_in_shared ? pack_levels_kernel<kLanes, true, true>
                            : pack_levels_kernel<kLanes, true, false>;
  }
  return tables_in_shared ? pack_levels_kernel<kLanes, false, true>
                          : pack_levels_kernel<kLanes, false, false>;
}

// The configuration the card last accepted, so the attributes are set and
// the occupancy query runs once per configuration and device. levels_lock
// is held from the check to the launch: another thread's smaller
// configuration would otherwise lower the attribute in between.
struct LevelsAccepted {
  int device = -1, cluster = 0, threads = 0;
  size_t bytes = 0;
  LevelsKernel kernel = nullptr;
};
LevelsAccepted levels_accepted;
std::mutex levels_lock;

}  // namespace

// vectors [G, R] f32, level_counts [L, G] i32, capacity [T, R] f32, valid
// [T] bool, prices [T] f32, allow [L, G, T] bool, penalty [L, G, T] f32,
// conflict [G, G] bool, node_cap [G] i32 (bools one byte each); mode 0 =
// ffd, 1 = cost; L <= 8 clusters of `cluster` blocks (1..16) of `threads`
// threads (a multiple of 32, at most 1,024); block b of a cluster owns the
// types [b * TB, (b + 1) * TB) with TB = ceil(T / cluster), `lanes` (1, 2, 4
// or 8) adjacent threads a type, thread slot i owning the block's types
// i + k * threads / lanes. Scratch from the caller: level_out [L,
// ktt_pack_levels_words] i32; fill_scratch null (the fills in shared memory)
// or [L * cluster, ktt_pack_levels_fill_words] i32; table_scratch null (the
// tables in shared memory) or [L * cluster, ktt_pack_levels_table_words] i32
// (then the fills are in global scratch too); placed_scratch [L * cluster,
// W, threads] u32 with W = ceil(G / 32) when G > 256, else null. out: [words
// + 1 + G + L * G] i32, written by the second launch of `select_blocks`
// blocks. Returns a CUDA error code: the occupancy query's,
// cudaErrorInvalidConfiguration when the card cannot place a cluster, or the
// first launch error.
extern "C" int ktt_pack_levels(const void* vectors, const void* level_counts,
                               const void* capacity, const void* valid, const void* prices,
                               const void* allow, const void* penalty, const void* conflict,
                               const void* node_cap, int groups, int types, int dims,
                               int levels, int mode, int cluster, int lanes, int threads,
                               int select_blocks, void* level_out, void* fill_scratch,
                               void* table_scratch, void* placed_scratch, void* out,
                               void* stream) {
  const bool register_placed = bit_words(groups) <= kRegisterWords;
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims || levels < 1 ||
      levels > 8 || (mode != kModeFfd && mode != kModeCost) || cluster < 1 ||
      cluster > kMaxCluster || (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || select_blocks < 1 ||
      window_depth(groups) > kMaxWindowDepth ||
      (table_scratch != nullptr && fill_scratch == nullptr) ||
      (!register_placed && placed_scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int types_per_block = (types + cluster - 1) / cluster;
  const size_t bytes = shared_bytes(groups, types_per_block, dims, fill_scratch == nullptr,
                                    table_scratch == nullptr);
  const bool tables_in_shared = table_scratch == nullptr;
  LevelsKernel kernel;
  switch (lanes) {
    case 1: kernel = levels_kernel<1>(register_placed, tables_in_shared); break;
    case 2: kernel = levels_kernel<2>(register_placed, tables_in_shared); break;
    case 4: kernel = levels_kernel<4>(register_placed, tables_in_shared); break;
    default: kernel = levels_kernel<8>(register_placed, tables_in_shared); break;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(levels * cluster, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = bytes;
  config.stream = s;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> hold(levels_lock);
  if (levels_accepted.device != device || levels_accepted.cluster != cluster ||
      levels_accepted.threads != threads || levels_accepted.bytes != bytes ||
      levels_accepted.kernel != kernel) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes > kDefaultSharedLimit ? bytes : kDefaultSharedLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cluster > kPortableCluster) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    levels_accepted.device = device;
    levels_accepted.cluster = cluster;
    levels_accepted.threads = threads;
    levels_accepted.bytes = bytes;
    levels_accepted.kernel = kernel;
  }
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(vectors),
      static_cast<const int*>(level_counts), static_cast<const float*>(capacity),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(prices),
      static_cast<const unsigned char*>(allow), static_cast<const float*>(penalty),
      static_cast<const unsigned char*>(conflict), static_cast<const int*>(node_cap), groups,
      types, dims, levels, mode, static_cast<int*>(level_out), static_cast<int*>(fill_scratch),
      static_cast<int*>(table_scratch), static_cast<unsigned*>(placed_scratch));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<select_blocks, kSelectThreads, 0, s>>>(
      static_cast<const int*>(level_out), static_cast<const int*>(level_counts), groups, levels,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
