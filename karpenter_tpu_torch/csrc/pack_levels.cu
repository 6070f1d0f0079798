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
// round is one type's dependent scan over G' groups, and every round depends
// on the one before; the levels are independent.
//
// What the design does about it: one block per level (L <= 8 after padding;
// padded levels repeat the last real one), each running its level's whole
// round loop on the card with no host sync:
//   * a thread owns the types t = tid + k * threads (one each up to 1,024
//     types) and scans each of them; capacity, validity and price are read
//     from global memory (L1) every round;
//   * the usable masks are packed once into 32-bit words per type and the
//     conflict rows into 32-bit words per group, so the conflict test is
//     O(G' / 32) word ANDs against the node's `placed` bits (in registers up
//     to G' 256, else in global scratch); groups whose row is empty skip it;
//   * the fills live [G', T] (consecutive across a warp), in shared memory
//     while they fit, else in global scratch; the group tables (vectors,
//     weights, axis masks, counts, caps, conflict rows) and the [T] sums go
//     to global scratch too past shared memory, so no G' is refused;
//   * the selection is a warp reduction and one shared-memory atomic per
//     warp: a 64-bit (score, index) key for cost, a max then a min index for
//     ffd; warp 0 applies the round.
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
//     64 on in the vectorised order of weighted_in_reference_order, and
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
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxThreads = 1024;
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

struct Control {
  unsigned long long key;  // cost mode's best (score, index)
  int selected;            // ffd mode's lowest type achieving the bound
  int bound;               // ffd mode's largest sum
  int largest_valid;
  int first_active, any_active, proceed;
};

// Words of one block's tables: [G, R] vectors, [G] weights, axis masks,
// counts, node caps and packable flags, the [G, W] conflict rows, the [T]
// sums.
__host__ __device__ inline size_t table_words(int groups, int types, int dims) {
  return size_t(groups) * dims + 5 * size_t(groups) + size_t(groups) * bit_words(groups) +
         types;
}

__host__ __device__ inline size_t shared_bytes(int groups, int types, int dims,
                                               bool fills_in_shared, bool tables_in_shared) {
  size_t bytes = sizeof(Control);
  if (tables_in_shared) bytes += sizeof(int) * table_words(groups, types, dims);
  if (fills_in_shared) bytes += sizeof(int) * size_t(groups) * types;
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
// ascending g, which the scan accumulates.
constexpr int kDotSteps = 32;
constexpr int kDotLanes = 8;
constexpr int kNarrowRows = 8;
constexpr int kUnrolledGroups = 256;

__device__ __forceinline__ float weighted_in_reference_order(const int* fills, int stride,
                                                             const float* weight, int groups,
                                                             int rows) {
  int accumulators = 4;
  int steps;
  bool unrolled;
  if (rows > kNarrowRows) {
    steps = groups / kDotSteps;
    unrolled = steps < 4;
  } else if (rows == 1) {
    steps = groups / kDotSteps;
    unrolled = groups <= kUnrolledGroups;
  } else {
    accumulators = groups <= 2 * kDotSteps ? 2 : 4;
    steps = groups / (kDotLanes * accumulators) - 1;
    unrolled = groups <= kUnrolledGroups;
  }
  const int step = kDotLanes * accumulators;
  float lanes[kDotLanes];
#pragma unroll
  for (int j = 0; j < kDotLanes; ++j) {
    float acc = 0.0f;
    if (unrolled) {
      for (int i = 0; i < steps; ++i) {
        const int g = step * i + j;
        acc = __fmaf_rn(static_cast<float>(fills[size_t(g) * stride]), weight[g], acc);
      }
      for (int u = 1; u < accumulators; ++u) {
        for (int k = 0; k < steps; ++k) {
          const int i = (steps >= 2 && k < 2) ? 1 - k : k;
          const int g = step * i + kDotLanes * u + j;
          acc = __fmaf_rn(static_cast<float>(fills[size_t(g) * stride]), weight[g], acc);
        }
      }
    } else {
      for (int u = 0; u < accumulators; ++u) {
        float chain = 0.0f;
        for (int i = 0; i < steps; ++i) {
          const int g = step * i + kDotLanes * u + j;
          chain = __fmaf_rn(static_cast<float>(fills[size_t(g) * stride]), weight[g], chain);
        }
        acc = u == 0 ? chain : __fadd_rn(chain, acc);
      }
    }
    lanes[j] = acc;
  }
  float total = __fadd_rn(__fadd_rn(__fadd_rn(lanes[0], lanes[4]), __fadd_rn(lanes[2], lanes[6])),
                          __fadd_rn(__fadd_rn(lanes[1], lanes[5]), __fadd_rn(lanes[3], lanes[7])));
  for (int g = steps * step; g < groups; ++g) {
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

// kRegisterPlaced: the node's placed bits in registers (G' <= 256), else in
// this thread's column of placed_scratch [W, threads]. kTablesInShared is
// known at compile time so that the scan's table reads are shared-memory
// loads, not generic ones.
template <bool kRegisterPlaced, bool kTablesInShared>
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
                   int groups, int types, int dims, int mode,
                   int* __restrict__ level_out,              // [L, words]
                   int* __restrict__ fill_scratch,           // [L, G, T] or null
                   int* __restrict__ table_scratch,          // [L, table words] or null
                   unsigned* __restrict__ usable_scratch,    // [L, W, T]
                   unsigned* __restrict__ placed_scratch) {  // [L, W, threads] or null
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Control* control = reinterpret_cast<Control*>(shared_raw);
  const int level = blockIdx.x;
  const int words_g = bit_words(groups);
  int* tables = kTablesInShared
                    ? reinterpret_cast<int*>(control + 1)
                    : table_scratch + size_t(level) * table_words(groups, types, dims);
  float* s_vectors = reinterpret_cast<float*>(tables);            // [G, R]
  float* s_weight = s_vectors + size_t(groups) * dims;            // [G]
  int* s_axes = reinterpret_cast<int*>(s_weight + groups);        // [G]
  int* s_counts = s_axes + groups;                                // [G]
  int* s_cap = s_counts + groups;                                 // [G]
  int* s_packable = s_cap + groups;                               // [G]
  unsigned* s_conflict = reinterpret_cast<unsigned*>(s_packable + groups);  // [G, W]
  int* s_sums = reinterpret_cast<int*>(s_conflict + size_t(groups) * words_g);  // [T]
  int* fills = fill_scratch == nullptr
                   ? s_sums + types
                   : fill_scratch + size_t(level) * groups * types;  // [G, T]
  unsigned* usable = usable_scratch + size_t(level) * words_g * types;  // [W, T]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int max_rounds = 2 * groups + 8;
  const Layout layout = make_layout(groups, max_rounds);
  int* o = level_out + size_t(level) * layout.words;
  const int* counts_in = level_counts + size_t(level) * groups;
  const unsigned char* allow_l = allow + size_t(level) * groups * types;
  const float* penalty_l = penalty + size_t(level) * groups * types;
  unsigned* placed_column =
      kRegisterPlaced ? nullptr : placed_scratch + size_t(level) * words_g * threads + tid;
  const int depth = window_depth(groups);

  for (int i = tid; i < layout.words; i += threads) o[i] = 0;
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
  if (tid == 0) {
    control->key = kNoKey;
    control->selected = INT_MAX;
    control->bound = 0;
    control->largest_valid = -1;
  }
  __syncthreads();

  // The usable bits of this level, [W, T], and which groups some type
  // admits; the last valid type.
  int largest = -1;
  for (int t = tid; t < types; t += threads) {
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
      usable[size_t(w) * types + t] = bits;
    }
  }
  largest = __reduce_max_sync(kFullMask, largest);
  if (lane == 0 && largest >= 0) atomicMax(&control->largest_valid, largest);
  __syncthreads();
  const int largest_valid = control->largest_valid < 0 ? types - 1 : control->largest_valid;
  // Groups no type admits retire at once; the weights for cost mode.
  for (int g = tid; g < groups; g += threads) {
    const int count = counts_in[g];
    if (s_packable[g] != 0) {
      s_counts[g] = count;
    } else {
      s_counts[g] = 0;
      o[layout.unschedulable + g] = count;
    }
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
    }
    total = __reduce_add_sync(kFullMask, total);
    if (lane == 0) {
      control->first_active = first < 0 ? 0 : first;
      control->any_active = first >= 0;
      control->proceed = total > 0 && iters < max_rounds + groups;
      control->key = kNoKey;
      control->selected = INT_MAX;
      control->bound = 0;
    }
    return total;
  };
  if (warp == 0) publish_state();
  __syncthreads();

  unsigned placed_reg[kRegisterPlaced ? kRegisterWords : 1];

  while (control->proceed) {
    const bool any_active = control->any_active != 0;
    unsigned long long best = kNoKey;
    int packs_any = 0;
    int thread_bound = 0;

    for (int t = tid; t < types; t += threads) {
      int sum = 0;
      float weighted = 0.0f;
      float pen[kMaxWindowDepth + 1];
#pragma unroll
      for (int d = 0; d <= kMaxWindowDepth; ++d) pen[d] = 0.0f;
      const bool type_valid = valid[t] != 0;
      if (type_valid && any_active) {
        float remaining[kMaxDims];
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) {
          remaining[r] = r < dims ? capacity[size_t(t) * dims + r] : 0.0f;
        }
        if (kRegisterPlaced) {
#pragma unroll
          for (int w = 0; w < kRegisterWords; ++w) placed_reg[w] = 0u;
        } else {
          for (int w = 0; w < words_g; ++w) placed_column[size_t(w) * threads] = 0u;
        }
        bool seen_eligible = false;
        bool abort = false;
        unsigned usable_word = 0;
        for (int g = 0; g < groups; ++g) {
          if ((g & 31) == 0) usable_word = usable[size_t(g >> 5) * types + t];
          const int count = s_counts[g];
          int n = 0;
          if (!abort && count > 0 && ((usable_word >> (g & 31)) & 1u)) {
            const int axes = s_axes[g];
            bool conflicted = false;
            if (axes & (1 << 16)) {
              const unsigned* row = s_conflict + size_t(g) * words_g;
              unsigned hit = 0;
              if (kRegisterPlaced) {
#pragma unroll
                for (int w = 0; w < kRegisterWords; ++w) {
                  if (w < words_g) hit |= placed_reg[w] & row[w];
                }
              } else {
                for (int w = 0; w < words_g; ++w) hit |= placed_column[size_t(w) * threads] & row[w];
              }
              conflicted = hit != 0;
            }
            if (!conflicted) {
              const float* vec = s_vectors + g * dims;
              float ratio = INFINITY;
#pragma unroll
              for (int r = 0; r < kMaxDims; ++r) {
                if (r < dims && (axes >> r) & 1) ratio = fminf(ratio, div_pos(remaining[r], vec[r]));
              }
              const float fit = fmaxf(floorf(__fadd_rn(ratio, 1e-4f)), 0.0f);
              n = min(min(count, __float2int_rz(fit)), s_cap[g]);  // saturating conversion
              // The first eligible group can hold no conflict (nothing is
              // placed before it): if it places nothing, the fill aborts.
              if (!seen_eligible && n == 0) abort = true;
              if (n > 0) {
                const float packed = static_cast<float>(n);
#pragma unroll
                for (int r = 0; r < kMaxDims; ++r) {
                  if (r < dims && (axes >> (8 + r)) & 1) {
                    remaining[r] = __fsub_rn(remaining[r], __fmul_rn(packed, vec[r]));
                  }
                }
                const unsigned bit = 1u << (g & 31);
                if (kRegisterPlaced) {
#pragma unroll
                  for (int w = 0; w < kRegisterWords; ++w) {
                    if (w == (g >> 5)) placed_reg[w] |= bit;
                  }
                } else {
                  placed_column[size_t(g >> 5) * threads] |= bit;
                }
                sum += n;
                if (mode == kModeCost) {
                  if (groups < 2 * kDotSteps) weighted = __fmaf_rn(packed, s_weight[g], weighted);
                  const float p = penalty_l[size_t(g) * types + t];
                  if (depth == 0) {
                    pen[0] = __fmaf_rn(packed, p, pen[0]);
                  } else {
                    pen[0] = __fadd_rn(pen[0], __fmul_rn(packed, p));
                  }
                }
              }
            }
            seen_eligible = true;
          }
          fills[size_t(g) * types + t] = n;
          // Close the windows that end at g (adding an empty window's 0 is
          // exact, so windows without a pack need no care).
          if (mode == kModeCost && depth > 0) {
            int span = kWindow;
            for (int d = 0; d < depth; ++d) {
              if ((g + 1) % span != 0 && g != groups - 1) break;
              pen[d + 1] = __fadd_rn(pen[d + 1], pen[d]);
              pen[d] = 0.0f;
              span *= kWindow;
            }
          }
        }
        if (mode == kModeCost && groups >= 2 * kDotSteps) {
          weighted = weighted_in_reference_order(fills + t, types, s_weight, groups,
                                                  static_cast<int>(gridDim.x) * types);
        }
      } else {
        for (int g = 0; g < groups; ++g) fills[size_t(g) * types + t] = 0;
      }
      s_sums[t] = sum;
      thread_bound = max(thread_bound, sum);
      if (mode == kModeCost) {
        const bool packs = sum > 0 && type_valid;
        const float total_pen = pen[depth];
        const float score = packs ? __fdiv_rn(__fadd_rn(prices[t], total_pen), fmaxf(weighted, 1e-9f))
                                  : INFINITY;
        packs_any |= packs;
        const unsigned long long key =
            (static_cast<unsigned long long>(orderable(score)) << 32) | static_cast<unsigned>(t);
        best = key < best ? key : best;
      }
    }

    bool have_pack;
    if (mode == kModeCost) {
      best = warp_min_key(best);
      if (lane == 0) atomicMin(&control->key, best);
      have_pack = __syncthreads_or(packs_any) != 0;
    } else {
      // The largest sum over every type bounds the round; the smallest
      // valid type achieving it wins.
      thread_bound = __reduce_max_sync(kFullMask, thread_bound);
      if (lane == 0) atomicMax(&control->bound, thread_bound);
      __syncthreads();
      const int bound = control->bound;
      have_pack = bound > 0;
      int candidate = INT_MAX;
      if (bound > 0) {
        for (int t = tid; t < types; t += threads) {
          if (valid[t] != 0 && s_sums[t] == bound) {
            candidate = t;
            break;
          }
        }
      }
      candidate = __reduce_min_sync(kFullMask, candidate);
      if (lane == 0 && candidate != INT_MAX) atomicMin(&control->selected, candidate);
      __syncthreads();
    }

    if (warp == 0) {
      int t_sel;
      if (mode == kModeCost) {
        t_sel = static_cast<int>(control->key & 0xffffffffull);
      } else {
        t_sel = control->selected;
        if (t_sel == INT_MAX) t_sel = 0;  // jnp.argmax of all-False
      }
      if (have_pack) {
        int repl = INT_MAX;
        for (int g = lane; g < groups; g += 32) {
          const int fill = fills[size_t(g) * types + t_sel];
          if (fill > 0) repl = min(repl, s_counts[g] / fill);
        }
        repl = max(__reduce_min_sync(kFullMask, repl), 1);
        const bool write = num_rounds < max_rounds;
        for (int g = lane; g < groups; g += 32) {
          const int fill = fills[size_t(g) * types + t_sel];
          if (write) o[layout.round_fill + num_rounds * groups + g] = fill;
          s_counts[g] -= repl * fill;
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
          o[layout.unschedulable + first] += s_counts[first];
          s_counts[first] = 0;
        }
      }
      __syncwarp();
      ++iters;
      publish_state();
    }
    __syncthreads();
  }

  if (warp == 0) {
    const int total = publish_state();
    if (lane == 0) {
      o[layout.num_rounds] = min(num_rounds, max_rounds);
      o[layout.overflow] = (total > 0 || num_rounds > max_rounds) ? 1 : 0;
    }
  }
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

// Dynamic shared memory of one block of the level kernel.
extern "C" long long ktt_pack_levels_shared_bytes(int groups, int types, int dims,
                                                  int fills_in_shared, int tables_in_shared) {
  return static_cast<long long>(
      shared_bytes(groups, types, dims, fills_in_shared != 0, tables_in_shared != 0));
}

// Words of one block's slice of the table scratch.
extern "C" long long ktt_pack_levels_table_words(int groups, int types, int dims) {
  return static_cast<long long>(table_words(groups, types, dims));
}

// vectors [G, R] f32, level_counts [L, G] i32, capacity [T, R] f32, valid
// [T] bool, prices [T] f32, allow [L, G, T] bool, penalty [L, G, T] f32,
// conflict [G, G] bool, node_cap [G] i32 (bools one byte each); mode 0 =
// ffd, 1 = cost; L <= 8 blocks of `threads` threads (a multiple of 32, at
// most 1,024), thread i owning types i + k * threads. Scratch from the
// caller: level_out [L, ktt_pack_levels_words] i32; fill_scratch null (the
// fills in shared memory) or [L, G, T] i32; table_scratch null (the tables in
// shared memory) or [L, ktt_pack_levels_table_words] i32 (then the fills are
// in global scratch too); usable_scratch [L, W, T] u32 with W = ceil(G / 32);
// placed_scratch [L, W, threads] u32 when G > 256, else null. out: [words +
// 1 + G + L * G] i32, written by the second launch of `select_blocks`
// blocks. Returns the first launch error.
extern "C" int ktt_pack_levels(const void* vectors, const void* level_counts,
                               const void* capacity, const void* valid, const void* prices,
                               const void* allow, const void* penalty, const void* conflict,
                               const void* node_cap, int groups, int types, int dims,
                               int levels, int mode, int threads, int select_blocks,
                               void* level_out, void* fill_scratch, void* table_scratch,
                               void* usable_scratch, void* placed_scratch, void* out,
                               void* stream) {
  const bool register_placed = bit_words(groups) <= kRegisterWords;
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims || levels < 1 ||
      levels > 8 || (mode != kModeFfd && mode != kModeCost) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || select_blocks < 1 ||
      window_depth(groups) > kMaxWindowDepth ||
      (table_scratch != nullptr && fill_scratch == nullptr) ||
      (!register_placed && placed_scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes =
      shared_bytes(groups, types, dims, fill_scratch == nullptr, table_scratch == nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(const float*, const int*, const float*, const unsigned char*, const float*,
                 const unsigned char*, const float*, const unsigned char*, const int*, int, int,
                 int, int, int*, int*, int*, unsigned*, unsigned*);
  if (register_placed) {
    kernel = table_scratch == nullptr ? pack_levels_kernel<true, true>
                                      : pack_levels_kernel<true, false>;
  } else {
    kernel = table_scratch == nullptr ? pack_levels_kernel<false, true>
                                      : pack_levels_kernel<false, false>;
  }
  if (bytes > kDefaultSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<levels, threads, bytes, s>>>(
      static_cast<const float*>(vectors), static_cast<const int*>(level_counts),
      static_cast<const float*>(capacity), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(prices), static_cast<const unsigned char*>(allow),
      static_cast<const float*>(penalty), static_cast<const unsigned char*>(conflict),
      static_cast<const int*>(node_cap), groups, types, dims, mode,
      static_cast<int*>(level_out), static_cast<int*>(fill_scratch),
      static_cast<int*>(table_scratch), static_cast<unsigned*>(usable_scratch),
      static_cast<unsigned*>(placed_scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<select_blocks, kSelectThreads, 0, s>>>(
      static_cast<const int*>(level_out), static_cast<const int*>(level_counts), groups, levels,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
