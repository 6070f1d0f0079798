// K2: the pack round loop on Hopper (sm_90a), both candidate modes in one
// launch, with or without the reference's fits() early exit (quirk).
//
// Replaces karpenter_tpu/ops/pack_kernel.py::pack_kernel (quirk=False and
// quirk=True) with its per-type fill _fill_one_node: a data-dependent
// lax.while_loop whose
// every round greedily fills one empty node of every instance type (a
// sequential scan over the G pod groups, vmapped over the T types), picks one
// type, replicates its fill as often as the group counts allow, and stops
// when every pod is placed or set aside.
//
// What bounds it on this card: latency. The work is tiny (at the main
// path's 512 types x 16 groups x 8 axes, one round is about 0.3 M fp32
// operations), but every round depends on the one before, and the critical
// path of a round is one type's scan: a chain of G groups, each a correctly
// rounded division per requested axis, a floor, a multiply and a subtract.
//
// What the design does about that: one launch of one block per mode (block 0
// runs mode ffd, block 1 mode cost when both are asked for) runs the whole
// round loop on the device, a persistent loop with no host sync, and keeps
// everything but that one scan off the round's critical path:
//   * one type per thread: a block of up to 1,024 threads, so at T <= 1,024
//     no thread scans two types one after the other (past that, 2 or 4 types
//     a thread, up to T 4,096, and past that ceil(T / 1,024) types a thread
//     whose constants are read from global memory every round);
//   * the per-type constants (capacity, valid, price) are loaded once,
//     before the round loop, into registers; each group's axes are sorted
//     once into two bit masks (divide where vec > 0, subtract where vec !=
//     0), so the scan divides only on the requested axes (3 of 8 on real
//     pods) and the uniform branch skips the rest;
//   * the fills live [G, T], so the threads of a warp write a group's fills
//     to consecutive words (no bank conflicts), in shared memory while they
//     fit, else in a global scratch buffer from the caller; past the fills,
//     the group tables (vectors, weights, axis masks, counts) and the [T]
//     sums go to a second global scratch buffer too, one slice a block, so
//     no group or type count is refused;
//   * the selection is a warp reduction and one shared-memory atomicMin per
//     warp (min is order-free, so the result does not depend on the order
//     the warps arrive in): for cost mode a 64-bit key (the score's bits,
//     made to order as unsigned, then the type index, so ties go to the
//     lowest index), for ffd the lowest type achieving the bound;
//   * a warp applies the round: lane g takes counts[g] / fill[g] and a warp
//     min gives repl; the lanes write the fill row and update the counts; a
//     ballot finds the first active group and a warp sum the total.
// A round costs three block barriers in ffd mode and two in cost mode.
//
// The quirk (kQuirk, the reference's Go-parity mode, pack_kernel.py:79-110
// and :183-193) changes two things and no layout: (a) while a type scans the
// groups largest first, a placement that fails (n < count) stops the scan
// when, on some axis with total > 0, remaining <= smallest + 1e-4, smallest
// being the last active group's vector: each type keeps one `stopped` bit in
// a register, its total > 0 axes as a bit mask in a register, and each
// round warp 0 publishes the last active group, from which every thread
// forms the eight limits once before its scan; (b) a partly packed group
// replicates max((count - 1) / fill, 1) times and a fully packed one once,
// in the round's min-reduction.
//
// Hazards for rounds that are bit-identical to the reference:
//   * n_fit = floor(min_r(remaining / vec) + 1e-4) in IEEE fp32: the
//     division is correctly rounded (__fdiv_rn; the build never passes
//     --use_fast_math); a zero remaining skips the division, whose result
//     it is (vec > 0).
//   * remaining - n * vec must not contract to an FMA: __fmul_rn and
//     __fsub_rn, and the build passes --fmad=false besides. Skipping the
//     update where vec == 0 keeps the bits: n * 0 = 0 and x - 0 = x.
//   * the quirk's smallest + 1e-4 is its own rounded add (__fadd_rn) and
//     the compare reads remaining after that two-operation update.
//   * the float-to-int conversion of n_fit saturates (an all-zero vector
//     gives +inf), as XLA's convert does.
//   * cost mode's weighted = fills @ group_weight in the order of the
//     reference's XLA program on the CPU: below 64 groups one chain of
//     fused multiply-adds over ascending g (__fmaf_rn), from 64 on the
//     vectorised order of weighted_in_reference_order, over the fills the
//     scan wrote.
//   * argmin and argmax ties go to the lowest index, as jnp's do.
//   * an out-of-range round write is dropped, as the reference's scatter
//     drops it; overflow reports the lost round.
//   * every output is int32 in the reference's PackRounds layout, because
//     the compaction and decompact_plan read word offsets.
//
// The epilogue (the pair, both modes, when the caller hands it output
// pointers; off for the quirk's launches and on a mesh for the payload):
// everything the fused solve's tail needs, so that the solve launches no
// kernel after this one but the LP's.
//   * feasibility (block 0, before the round loop, from the staged group
//     vectors): feasible_any[g] = some valid type fits one pod of g, as the
//     reference's feasibility_mask(...).any(1), capacity + 1e-6 its own
//     rounded add (__fadd_rn); a warp ORs its types' answers into the tail
//     of the output buffer, which makes the buffer the whole dense spill
//     [2 x words + G] the reference concatenates. After the loop block 0
//     writes it again as a bool [G], and solvable[g] = feasible_any[g] ?
//     counts[g] : 0 for the LP.
//   * compaction (K4, compact_rounds.cuh): after a block barrier each block
//     writes its own mode's segment of the payload from the rounds it has
//     just written, reading only the rows the loop wrote; block 0 adds the
//     feasibility tail. Neither block waits for the other: a block's
//     segment depends on its own rounds alone. The scan's warp counts reuse
//     the block's tables, which the loop no longer reads.
// The round loop itself is the same code with and without the epilogue, and
// both passes are functions of their own (__noinline__), called where few
// values are live: inlined, they changed the loop's register allocation
// and slowed it by about 8% on an H100 (the pair 0.216 -> 0.234 ms at the
// main path, without the epilogue).

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "compact_rounds.cuh"

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxThreads = 1024;
constexpr int kModeFfd = 0;
constexpr int kModeCost = 1;
constexpr int kDefaultSharedLimit = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

// Word offsets of one mode's PackRounds inside the output buffer: the
// reference's dense spill layout (models/solver.py rounds_ints).
struct Layout {
  int round_type, round_fill, round_repl, num_rounds, unschedulable, overflow,
      words;
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

// The epilogue's outputs: feasible null leaves it off. payload may be null
// with feasible set (a mesh's replicas compact shard by shard instead).
struct Epilogue {
  unsigned char* feasible;  // [G] bool
  int* solvable;            // [G] int32
  int* payload;             // [2 x compaction::mode_words + G] int32, or null
};

// The block's control words at the front of dynamic shared memory.
struct Control {
  unsigned long long key;  // cost mode's best (score, index)
  int selected;            // ffd mode's lowest type achieving the bound
  int largest_valid;
  int first_active, any_active, proceed;
  int last_active;  // the quirk's smallest pod: the last group with pods
};

// Words of one block's tables: the group tables [G, R] vectors, [G]
// weights, axis masks and counts, then the [T] sums.
__host__ __device__ inline size_t table_words(int groups, int types, int dims) {
  return size_t(groups) * dims + 3 * size_t(groups) + types;
}

// Dynamic shared memory of one block: the control words, the tables when
// they live in shared memory, and the [G, T] fills when they do.
// ops/pack_kernel.pack_launch_plan mirrors it.
__host__ __device__ inline size_t shared_bytes(int groups, int types, int dims,
                                               bool fills_in_shared, bool tables_in_shared) {
  size_t bytes = sizeof(Control);
  if (tables_in_shared) bytes += sizeof(int) * table_words(groups, types, dims);
  if (fills_in_shared) bytes += sizeof(int) * size_t(types) * groups;
  return bytes;
}

// a / b for b > 0: the IEEE quotient. The card's division takes its slow
// path for a zero dividend, which a node filled exactly on one axis gives;
// a zero divides as 1.0 instead and the select gives back a itself (0 / b
// is 0 with a's sign when b > 0).
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

// A float's bits, made to order as an unsigned int.
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

// The epilogue's feasibility pass, by every thread of block 0 before the
// round loop: for each group, whether one of the thread's valid types fits
// one pod on every axis, a warp's answer ORed into fits_any[g] (zeroed
// before the block's first barrier; read after the loop's barriers).
__device__ __noinline__ void feasibility_pass(const float* vectors, const float* capacity,
                                              const unsigned char* valid, int groups, int types,
                                              int dims, int* fits_any) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < types; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const bool in = t < types && valid[t] != 0;
    float cap[kMaxDims];
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      cap[r] = in && r < dims ? __fadd_rn(capacity[size_t(t) * dims + r], 1e-6f) : 0.0f;
    }
    for (int g = 0; g < groups; ++g) {
      const float* vec = vectors + g * dims;
      bool fits = in;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) fits = fits && vec[r] <= cap[r];
      }
      if (__any_sync(kFullMask, fits) && lane == 0) atomicOr(fits_any + g, 1);
    }
  }
}

// The epilogue after the round loop, by every thread of the block: a
// barrier (the rounds final, the tables free), the block's mode compacted
// into its payload segment (warp counts in the tables), and block 0's
// feasibility outputs.
__device__ __noinline__ void write_epilogue(Epilogue epilogue, const int* o, const int* fits_any,
                                            const int* counts_in, int groups, int max_rounds,
                                            int* scratch) {
  __syncthreads();
  const Layout layout = make_layout(groups, max_rounds);
  const int payload_words = compaction::mode_words(groups, max_rounds);
  if (epilogue.payload != nullptr) {
    const compaction::Rounds rounds{o + layout.round_type, o + layout.round_fill,
                                    o + layout.round_repl, o + layout.num_rounds,
                                    o + layout.unschedulable, o + layout.overflow};
    compaction::compact_rounds(rounds, groups, max_rounds, o[layout.num_rounds],
                               epilogue.payload + size_t(blockIdx.x) * payload_words, scratch);
  }
  if (blockIdx.x == 0) {
    int* payload_tail =
        epilogue.payload == nullptr ? nullptr : epilogue.payload + 2 * size_t(payload_words);
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int fits = __ldcg(fits_any + g);
      epilogue.feasible[g] = fits != 0;
      epilogue.solvable[g] = fits != 0 ? counts_in[g] : 0;
      if (payload_tail != nullptr) payload_tail[g] = fits;
    }
  }
}

// kTypesPerThread 1, 2 or 4 keeps each type's constants in registers; 0
// streams them from global memory for ceil(T / threads) types a thread.
// kTablesInShared is known at compile time so that the scan's table reads
// are shared-memory loads, not generic ones. kQuirk is the fits() early
// exit; total is read only under it.
template <int kTypesPerThread, bool kTablesInShared, bool kQuirk>
__global__ void __launch_bounds__(kMaxThreads)
pack_rounds_kernel(const float* __restrict__ vectors,
                   const int* __restrict__ counts_in,
                   const float* __restrict__ capacity,
                   const float* __restrict__ total,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ prices, int groups, int types,
                   int dims, int first_mode, int* __restrict__ out,
                   int* __restrict__ fill_scratch, int* __restrict__ table_scratch,
                   Epilogue epilogue) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Control* control = reinterpret_cast<Control*>(shared_raw);
  // The tables: after the control words, or in this block's slice of the
  // global scratch.
  float* s_vectors = kTablesInShared
                         ? reinterpret_cast<float*>(control + 1)
                         : reinterpret_cast<float*>(
                               table_scratch + size_t(blockIdx.x) * table_words(groups, types, dims));
  float* s_weight = s_vectors + groups * dims;                // [G]
  int* s_axes = reinterpret_cast<int*>(s_weight + groups);    // [G]
  int* s_counts = s_axes + groups;                            // [G]
  int* s_sums = s_counts + groups;                            // [T]
  int* fills = fill_scratch == nullptr
                   ? s_sums + types
                   : fill_scratch + size_t(blockIdx.x) * types * groups;  // [G, T]
  constexpr int kCached = kTypesPerThread > 0 ? kTypesPerThread : 1;
  const int per_thread =
      kTypesPerThread > 0 ? kTypesPerThread : (types + blockDim.x - 1) / blockDim.x;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int mode = first_mode + blockIdx.x;
  const int max_rounds = 2 * groups + 8;
  const Layout layout = make_layout(groups, max_rounds);
  int* o = out + size_t(blockIdx.x) * layout.words;

  for (int i = tid; i < layout.words; i += threads) o[i] = 0;
  if (epilogue.feasible != nullptr && blockIdx.x == 0) {
    // The feasibility tail of the dense spill, past both modes' rounds.
    for (int g = tid; g < groups; g += threads) out[2 * size_t(layout.words) + g] = 0;
  }
  for (int i = tid; i < groups * dims; i += threads) s_vectors[i] = vectors[i];
  for (int g = tid; g < groups; g += threads) {
    s_counts[g] = counts_in[g];
    int axes = 0;
    for (int r = 0; r < dims; ++r) {
      const float v = vectors[g * dims + r];
      if (v > 0.0f) axes |= 1 << r;
      if (v != 0.0f) axes |= 1 << (8 + r);
    }
    s_axes[g] = axes;
  }
  if (tid == 0) {
    control->key = kNoKey;
    control->selected = INT_MAX;
    control->largest_valid = -1;
  }
  __syncthreads();
  if (epilogue.feasible != nullptr && blockIdx.x == 0) {
    feasibility_pass(s_vectors, capacity, valid, groups, types, dims, out + 2 * size_t(layout.words));
  }

  // The per-type constants, in registers for the whole loop (streamed from
  // global memory when kTypesPerThread is 0).
  float cap[kCached][kMaxDims];
  bool type_valid[kCached];
  float price[kCached];
  int total_axes[kCached];  // the quirk's axes with total > 0, a bit each
  int largest = -1;
  if (kTypesPerThread > 0) {
#pragma unroll
    for (int k = 0; k < kCached; ++k) {
      const int t = tid + k * threads;
      const bool in = t < types;
      type_valid[k] = in && valid[t] != 0;
      price[k] = in ? prices[t] : INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        cap[k][r] = in && r < dims ? capacity[size_t(t) * dims + r] : 0.0f;
      }
      total_axes[k] = 0;
      if (kQuirk && in) {
        for (int r = 0; r < dims; ++r) {
          if (total[size_t(t) * dims + r] > 0.0f) total_axes[k] |= 1 << r;
        }
      }
      if (type_valid[k]) largest = t;
    }
  } else {
    for (int t = tid; t < types; t += threads) {
      if (valid[t] != 0) largest = t;
    }
  }
  // num_types - 1 - argmax(valid[::-1]): the last valid type, or the last
  // type when none is valid.
  largest = __reduce_max_sync(kFullMask, largest);
  if (lane == 0 && largest >= 0) atomicMax(&control->largest_valid, largest);
  __syncthreads();
  const int largest_valid = control->largest_valid < 0 ? types - 1 : control->largest_valid;
  // Cost-mode group weight: the largest per-axis share of the largest valid
  // type's capacity (with the capacity floored at 1).
  for (int g = tid; g < groups; g += threads) {
    float weight = -INFINITY;
    for (int r = 0; r < dims; ++r) {
      const float ref = fmaxf(capacity[size_t(largest_valid) * dims + r], 1.0f);
      weight = fmaxf(weight, __fdiv_rn(s_vectors[g * dims + r], ref));
    }
    s_weight[g] = weight;
  }

  // Loop state, kept by warp 0 (every lane holds the same values).
  int iters = 0;
  int num_rounds = 0;
  // Warp 0: the total of the counts, the first active group and whether
  // to go on; resets the selection words.
  auto publish_state = [&]() {
    int pods = 0;
    int first = -1;
    int last = -1;
    for (int base = 0; base < groups; base += 32) {
      const int g = base + lane;
      const int count = g < groups ? s_counts[g] : 0;
      pods += count;
      const unsigned active = __ballot_sync(kFullMask, count > 0);
      if (first < 0 && active != 0) first = base + __ffs(active) - 1;
      if (active != 0) last = base + 31 - __clz(active);
    }
    pods = __reduce_add_sync(kFullMask, pods);
    if (lane == 0) {
      control->first_active = first < 0 ? 0 : first;
      control->last_active = last < 0 ? groups - 1 : last;
      control->any_active = first >= 0;
      control->proceed = pods > 0 && iters < max_rounds + groups;
      control->key = kNoKey;
      control->selected = INT_MAX;
    }
    return pods;
  };
  if (warp == 0) publish_state();
  __syncthreads();

  while (control->proceed) {
    const int first_active = control->first_active;
    const bool any_active = control->any_active != 0;
    unsigned long long best = kNoKey;
    int packs_any = 0;
    // The quirk's limits: smallest + 1e-4 on every axis, one rounded add.
    float limit[kMaxDims];
    if (kQuirk) {
      const float* smallest = s_vectors + control->last_active * dims;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) limit[r] = r < dims ? __fadd_rn(smallest[r], 1e-4f) : 0.0f;
    }

#pragma unroll
    for (int k = 0; k < per_thread; ++k) {
      const int t = tid + k * threads;
      if (t >= types) continue;
      // This type's constants: the cached slot, or loaded now.
      const int slot = kTypesPerThread > 0 ? k : 0;
      if (kTypesPerThread == 0) {
        type_valid[0] = valid[t] != 0;
        price[0] = prices[t];
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) {
          cap[0][r] = r < dims ? capacity[size_t(t) * dims + r] : 0.0f;
        }
        total_axes[0] = 0;
        if (kQuirk) {
          for (int r = 0; r < dims; ++r) {
            if (total[size_t(t) * dims + r] > 0.0f) total_axes[0] |= 1 << r;
          }
        }
      }
      int sum = 0;
      float weighted = 0.0f;
      if (type_valid[slot] && any_active) {
        float remaining[kMaxDims];
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) remaining[r] = cap[slot][r];
        // A first active group that cannot place one pod aborts the fill;
        // every earlier group has count 0, so the fill is all zero then.
        // Under the quirk a failed placement on an essentially full node
        // stops the scan: later groups place nothing on this type.
        bool abort = false;
        bool stopped = false;
        for (int g = 0; g < groups; ++g) {
          const int count = s_counts[g];
          int n = 0;
          if (count > 0 && !abort && !stopped) {
            const float* vec = s_vectors + g * dims;
            const int axes = s_axes[g];
            float ratio = INFINITY;
#pragma unroll
            for (int r = 0; r < kMaxDims; ++r) {
              if (r < dims && (axes >> r) & 1) {
                ratio = fminf(ratio, div_pos(remaining[r], vec[r]));
              }
            }
            const float fit = fmaxf(floorf(__fadd_rn(ratio, 1e-4f)), 0.0f);
            n = min(count, __float2int_rz(fit));  // saturating conversion
            if (g == first_active && n == 0) abort = true;
            const float packed = static_cast<float>(n);
#pragma unroll
            for (int r = 0; r < kMaxDims; ++r) {
              if (r < dims && (axes >> (8 + r)) & 1) {
                remaining[r] = __fsub_rn(remaining[r], __fmul_rn(packed, vec[r]));
              }
            }
            if (kQuirk && n < count) {
#pragma unroll
              for (int r = 0; r < kMaxDims; ++r) {
                if (r < dims && ((total_axes[slot] >> r) & 1) && remaining[r] <= limit[r]) {
                  stopped = true;
                }
              }
            }
          }
          fills[size_t(g) * types + t] = n;
          sum += n;
          if (mode == kModeCost && groups < 2 * kDotSteps) {
            weighted = __fmaf_rn(static_cast<float>(n), s_weight[g], weighted);
          }
        }
        if (mode == kModeCost && groups >= 2 * kDotSteps) {
          weighted = weighted_in_reference_order(fills + t, types, s_weight, groups, types);
        }
      } else {
        for (int g = 0; g < groups; ++g) fills[size_t(g) * types + t] = 0;
      }
      s_sums[t] = sum;
      if (mode == kModeCost) {
        const bool packs = sum > 0 && type_valid[slot];
        const float score = packs ? __fdiv_rn(price[slot], fmaxf(weighted, 1e-9f)) : INFINITY;
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
      __syncthreads();
      // The largest valid type's pod count bounds the round; the smallest
      // valid type achieving it wins.
      const int bound = s_sums[largest_valid];
      have_pack = bound > 0;
      int candidate = INT_MAX;
      if (kTypesPerThread > 0) {
#pragma unroll
        for (int k = kCached - 1; k >= 0; --k) {
          const int t = tid + k * threads;
          if (t < types && bound > 0 && type_valid[k] && s_sums[t] == bound) candidate = t;
        }
      } else if (bound > 0) {
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
          if (fill > 0) {
            const int count = s_counts[g];
            // The quirk keeps a partly packed group partly packed: it
            // replicates while its count stays above its fill.
            const int safe = !kQuirk ? count / fill : fill == count ? 1 : max((count - 1) / fill, 1);
            repl = min(repl, safe);
          }
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
    const int pods = publish_state();
    if (lane == 0) {
      o[layout.num_rounds] = min(num_rounds, max_rounds);
      o[layout.overflow] = (pods > 0 || num_rounds > max_rounds) ? 1 : 0;
    }
  }
  if (epilogue.feasible != nullptr) {
    write_epilogue(epilogue, o, out + 2 * size_t(layout.words), counts_in, groups, max_rounds,
                   reinterpret_cast<int*>(s_vectors));
  }
}

template <int kTypesPerThread, bool kTablesInShared, bool kQuirk>
int launch_variant(const void* vectors, const void* counts, const void* capacity,
                   const void* total, const void* valid, const void* prices, int groups,
                   int types, int dims, int first_mode, int num_modes, int threads, void* out,
                   void* fill_scratch, void* table_scratch, Epilogue epilogue, void* stream) {
  const size_t bytes = shared_bytes(groups, types, dims, fill_scratch == nullptr, kTablesInShared);
  if (bytes > kDefaultSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_rounds_kernel<kTypesPerThread, kTablesInShared, kQuirk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pack_rounds_kernel<kTypesPerThread, kTablesInShared, kQuirk>
      <<<num_modes, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(vectors), static_cast<const int*>(counts),
          static_cast<const float*>(capacity), static_cast<const float*>(total),
          static_cast<const unsigned char*>(valid),
          static_cast<const float*>(prices), groups, types, dims, first_mode,
          static_cast<int*>(out), static_cast<int*>(fill_scratch),
          static_cast<int*>(table_scratch), epilogue);
  return static_cast<int>(cudaGetLastError());
}

template <int kTypesPerThread, bool kQuirk>
int launch(const void* vectors, const void* counts, const void* capacity, const void* total,
           const void* valid, const void* prices, int groups, int types, int dims,
           int first_mode, int num_modes, int threads, void* out, void* fill_scratch,
           void* table_scratch, Epilogue epilogue, void* stream) {
  if (table_scratch == nullptr) {
    return launch_variant<kTypesPerThread, true, kQuirk>(
        vectors, counts, capacity, total, valid, prices, groups, types, dims, first_mode,
        num_modes, threads, out, fill_scratch, table_scratch, epilogue, stream);
  }
  return launch_variant<kTypesPerThread, false, kQuirk>(
      vectors, counts, capacity, total, valid, prices, groups, types, dims, first_mode,
      num_modes, threads, out, fill_scratch, table_scratch, epilogue, stream);
}

template <bool kQuirk>
int launch_any(const void* vectors, const void* counts, const void* capacity, const void* total,
               const void* valid, const void* prices, int groups, int types, int dims,
               int first_mode, int num_modes, int threads, int types_per_thread, void* out,
               void* fill_scratch, void* table_scratch, Epilogue epilogue, void* stream) {
  switch (types_per_thread) {
    case 1:
      return launch<1, kQuirk>(vectors, counts, capacity, total, valid, prices, groups, types,
                               dims, first_mode, num_modes, threads, out, fill_scratch,
                               table_scratch, epilogue, stream);
    case 2:
      return launch<2, kQuirk>(vectors, counts, capacity, total, valid, prices, groups, types,
                               dims, first_mode, num_modes, threads, out, fill_scratch,
                               table_scratch, epilogue, stream);
    case 4:
      return launch<4, kQuirk>(vectors, counts, capacity, total, valid, prices, groups, types,
                               dims, first_mode, num_modes, threads, out, fill_scratch,
                               table_scratch, epilogue, stream);
    case 3:
      return cudaErrorInvalidValue;
    default:
      return launch<0, kQuirk>(vectors, counts, capacity, total, valid, prices, groups, types,
                               dims, first_mode, num_modes, threads, out, fill_scratch,
                               table_scratch, epilogue, stream);
  }
}

}  // namespace

// Words of one mode's output; the caller allocates num_modes times this.
extern "C" int ktt_pack_rounds_words(int groups) {
  return make_layout(groups, 2 * groups + 8).words;
}

// Words of the epilogue's payload: both modes' segments, then feasible_any.
extern "C" int ktt_pack_rounds_payload_words(int groups) {
  return 2 * compaction::mode_words(groups, 2 * groups + 8) + groups;
}

// Dynamic shared memory one block needs, with or without the [G, T] fills
// and the tables.
extern "C" long long ktt_pack_rounds_shared_bytes(int groups, int types, int dims,
                                                  int fills_in_shared, int tables_in_shared) {
  return static_cast<long long>(
      shared_bytes(groups, types, dims, fills_in_shared != 0, tables_in_shared != 0));
}

// Words of one block's slice of the table scratch.
extern "C" long long ktt_pack_rounds_table_words(int groups, int types, int dims) {
  return static_cast<long long>(table_words(groups, types, dims));
}

// vectors [G, R] f32, counts [G] i32, capacity and total [T, R] f32, valid
// [T] bool (one byte each), prices [T] f32, out [num_modes, words] i32;
// fill_scratch is null to keep the fills in shared memory, else [num_modes,
// G, T] i32; table_scratch is null to keep the tables in shared memory, else
// [num_modes, ktt_pack_rounds_table_words] i32 (the fills are then in global
// scratch too). Block b runs mode first_mode + b (0 = ffd, 1 = cost) with
// `threads` threads, thread i owning the types i + k * threads for k <
// types_per_thread (1, 2 or 4 cached in registers, more streamed); quirk 1
// takes the reference's fits() early exit and its replication rule, and
// reads total. The epilogue: feasible [G] bool and solvable [G] i32, both
// null or neither, take the feasibility of both modes' launch (first_mode 0,
// num_modes 2), and out then holds G more words, feasible_any as int32;
// payload [ktt_pack_rounds_payload_words] i32 (null: none, the only choice
// without feasible) takes both plans compacted. Returns the launch's
// cudaGetLastError().
extern "C" int ktt_pack_rounds(const void* vectors, const void* counts,
                               const void* capacity, const void* total, const void* valid,
                               const void* prices, int groups, int types,
                               int dims, int first_mode, int num_modes,
                               int threads, int types_per_thread, int quirk,
                               void* out, void* fill_scratch, void* table_scratch,
                               void* feasible, void* solvable, void* payload,
                               void* stream) {
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims ||
      first_mode < kModeFfd || num_modes < 1 ||
      first_mode + num_modes - 1 > kModeCost || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || types_per_thread < 1 ||
      static_cast<long long>(threads) * types_per_thread < types ||
      (table_scratch != nullptr && fill_scratch == nullptr) ||
      (quirk != 0 && total == nullptr) || ((feasible == nullptr) != (solvable == nullptr)) ||
      (payload != nullptr && feasible == nullptr) ||
      (feasible != nullptr && (first_mode != kModeFfd || num_modes != 2))) {
    return cudaErrorInvalidValue;
  }
  const Epilogue epilogue{static_cast<unsigned char*>(feasible), static_cast<int*>(solvable),
                          static_cast<int*>(payload)};
  if (quirk != 0) {
    return launch_any<true>(vectors, counts, capacity, total, valid, prices, groups, types, dims,
                            first_mode, num_modes, threads, types_per_thread, out, fill_scratch,
                            table_scratch, epilogue, stream);
  }
  return launch_any<false>(vectors, counts, capacity, total, valid, prices, groups, types, dims,
                           first_mode, num_modes, threads, types_per_thread, out, fill_scratch,
                           table_scratch, epilogue, stream);
}
