// K3: the LP relaxation on Hopper (sm_90a), every Adam step in one launch of
// one thread-block cluster.
//
// Replaces karpenter_tpu/ops/score_kernel.py::lp_relax_body: a lax.scan of
// `steps` Adam steps (optax.adam(0.25)) on jax.grad(lp_objective), then the
// relaxed plan with the hard max. With F the feasibility mask, c the group
// counts, v the group vectors, K the capacity, p the effective prices and
// s = 20:
//
//   S = softmax_t(where(F, L, -1e9))      x = where(F, c * S, 0)
//   D[t, r] = sum_g x[g, t] * v[g, r]     f = D / max(K, 1e-3)
//   nodes[t] = logsumexp_r(s * f[t, :]) / s      objective = sum_t p * nodes
//
// and its gradient in closed form:
//
//   w[t, r]  = softmax_r(s * f[t, :])     dD = p * w / max(K, 1e-3)
//   dx[g, t] = sum_r v[g, r] * dD[t, r]   dS = where(F, c * dx, 0)
//   dL = where(F, S * (dS - sum_t' S * dS), 0)
//
// What bounds it on this card: latency. At the main path's 16 groups x 512
// types x 8 axes one step is about 0.5 M fp32 operations, nanoseconds at the
// card's rate, but the 300 steps depend on each other, and each step is a
// chain of IEEE divisions, expf and sqrtf per cell with row reductions in
// between. An IEEE division or square root is a short fast path behind a
// branch to a much longer slow path, which a zero or subnormal operand
// takes, so the divisions of one thread do not overlap. On one SM (the
// previous design) a lane walked 16 cells of that chain one after another,
// and each type's 24 divisions: 20 us a step.
//
// What the design does about that: the [G, T] problem is spread over a
// cluster of blocks on neighbouring SMs, partitioned by types: block b of
// the cluster owns the contiguous types [b * TB, (b + 1) * TB) for every
// group, and a thread owns one cell (at the main path: 16 blocks of 512
// threads, 32 types x 16 groups each). The column pass (D, the smooth max,
// w, dD, dS) needs only the cells of a block's own types, and Adam is
// elementwise, so both stay inside the block. Only the row reductions
// cross the blocks, in two exchanges a step: the row dot sum_t S * dS, and
// the softmax's row sum and row max together.
//   * Threads: a block is threads / Q type slots x Q group lanes. The Q
//     lanes of one type sit in adjacent lanes of a warp; lane q owns the
//     groups g = q + k Q of its types, in every pass. Their partial D sums
//     meet by a __shfl_xor butterfly (every lane ends with the same bits).
//   * Columns in three passes: each cell turns the softmax's e into S and
//     adds x * v to its type's D; one lane per (type, requested axis) takes
//     s * f, the smooth max and dD; each cell takes dx and dS. The axes no
//     group requests (5 of 8 on real pods) have D = 0 and meet only v = 0,
//     so they join the smooth max's sum as exp(0 - max) and skip the
//     divisions.
//   * The softmax in one exchange: each cell takes e = exp(L - ref) with ref
//     the row max the previous exchange found (exact at the start), and the
//     blocks exchange their row sums and maxima at once. Adam's step is at
//     most lr * 7.3 under optax's defaults (|m_hat| / sqrt(v_hat) <= (1 -
//     b1) / sqrt(1 - b2) / sqrt(1 - b1^2 / b2)), so exp neither overflows
//     nor loses the row. The exp is taken right after each cell's Adam
//     update, and the division by the row total as the next column pass
//     reads the cell.
//   * State: each block keeps its slice of the logits, both moments, S, dS
//     and the mask in its own shared memory, one cell per thread and slot
//     (cell k of thread i at k * threads + i: no bank conflicts). Past the
//     227 KB a block may hold at every cluster size, the slices go to a
//     global scratch buffer of the same layout. Past thousands of groups
//     the group tables (the vectors, counts, reductions, rows and the two
//     exchange tables) do not fit either: they go to a second global
//     scratch buffer, per block, with one copy of each exchange table for
//     the whole cluster. The wrapper picks the cluster size, the threads
//     and both paths from the sizes alone (ops/score_kernel.lp_launch_plan).
//   * Exchanges through distributed shared memory: each block sums its [G]
//     partials over its warps in warp order and writes the result into its
//     row of every block's gather table (remote stores; nobody waits on a
//     remote load); after cluster.sync() every block combines the rows in
//     rank order, so every block holds the same bits and the result is the
//     same from run to run: no atomics. The row dot and the softmax use two
//     tables in turn: a block writes a table again only after the next
//     barrier, which every reader of the table has reached. With the tables
//     in global scratch, a block writes its row once into the one global
//     table and fences before the barrier (whose arrive releases and whose
//     wait acquires at cluster scope); the order of the sums is the same.
//   * Tensor cores do not serve here: the products are [T, G] x [G, R] at G
//     16 and R 8, and TF32 keeps ten mantissa bits, which the objective's
//     rtol of 1e-4 cannot absorb on demands of tens of thousands of
//     millicores.
// After the loop a last pass writes x and nodes = max_r D / K, and rank 0
// sums the blocks' objective partials in rank order.
//
// Hazards:
//   * masks are selects, never a multiply by 0/1: on infeasible and padded
//     cells p * w / K may be inf or NaN, and the select drops it as the
//     reference's jnp.where does. Padded (invalid) types are infeasible in
//     every row: their cells keep assignment 0 and nodes = max_r 0 / K.
//     They stay in the partition; a block of padded types runs beside the
//     others and costs no latency. An infeasible cell's gradient is 0 in
//     every step, so its moments stay 0 and its logit never moves (L + -0
//     = L): Adam skips it.
//   * Adam follows optax's order of operations, each operation rounded on
//     its own (the build passes --fmad=false and never fast math: expf and
//     logf, IEEE division and square root); the bias corrections
//     1 - b**k come from the caller's [steps, 2] table, the same constants
//     the plain version divides by. A zero dividend or radicand takes the
//     select instead of the slow path, with the same result (div_pos,
//     sqrt_nonneg).
//   * every thread of a warp runs the same loop counts, so the shuffles see
//     full warps; cells out of range contribute 0 (or -inf to a max).
//   * after the last exchange that writes into other blocks, only rank 0
//     receives (the objective), so no block reads or writes the shared
//     memory of a block that has left.
// The order of the sums and the softmax's reference change from the plain
// version's, so the kernel agrees with it to the LP tolerances, not bit for
// bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kDefaultSharedLimit = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kSharpness = 20.0f;
constexpr float kMasked = -1e9f;
constexpr float kCapacityFloor = 1e-3f;
// optax.adam(0.25) defaults; (1 - b) is rounded to fp32 once, as a Python
// scalar is when it multiplies an fp32 tensor.
constexpr float kLearningRate = 0.25f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;

// The launch plan, as the wrapper computed it.
struct Shape {
  int groups, types, dims, steps;
  int types_per_block;  // TB
  int group_lanes;      // Q
  int type_iters;       // ceil(TB / (threads / Q))
  int group_iters;      // ceil(G / Q)
};

__host__ __device__ inline size_t round16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Word offsets of the tables at the front of dynamic shared memory, then
// the bytes of one block's state (in shared memory after the tables, or in
// the caller's scratch). With the group tables in global scratch (the
// G-sized ones: vectors, counts, red_sum, red_max and the rows), their
// offsets are into the block's slice of that scratch (group_words a block),
// and the exchange tables follow all the slices, one copy for the cluster.
// ops/score_kernel._lp_layout mirrors it.
struct Layout {
  size_t vectors, counts, cap, price, requested, column, red_sum, red_max, row_dot,
      row_ref, row_total, gather_dot, gather_soft, gather_obj, table_bytes, cells,
      state_bytes, group_words, global_table_bytes;
};

__host__ __device__ inline Layout make_layout(int groups, int dims, int types_per_block,
                                              int threads, int group_lanes, int cluster,
                                              bool tables_in_shared = true) {
  Layout l;
  const size_t warps = threads / 32;
  size_t w = 0;  // shared words
  size_t g = 0;  // a block's words of global group tables
  size_t& at = tables_in_shared ? w : g;
  l.vectors = at;    at += size_t(groups) * dims;
  l.counts = at;     at += groups;
  l.cap = w;         w += size_t(types_per_block) * dims;
  l.price = w;       w += types_per_block;
  l.requested = w;   w += kMaxDims + 1;
  l.column = w;      w += size_t(types_per_block) * kMaxDims;
  l.red_sum = at;    at += warps * groups;
  l.red_max = at;    at += warps * groups;
  l.row_dot = at;    at += groups;
  l.row_ref = at;    at += groups;
  l.row_total = at;  at += groups;
  l.group_words = g;
  if (tables_in_shared) {
    l.gather_dot = w;  w += size_t(cluster) * groups;
    l.gather_soft = w; w += 2 * size_t(cluster) * groups;
  } else {
    l.gather_dot = size_t(cluster) * g;
    l.gather_soft = l.gather_dot + size_t(cluster) * groups;
  }
  l.global_table_bytes =
      tables_in_shared ? 0 : sizeof(float) * (size_t(cluster) * (g + 3 * size_t(groups)));
  l.gather_obj = w;  w += cluster;
  l.table_bytes = round16(sizeof(float) * w);
  const int type_slots = threads / group_lanes;
  const size_t type_iters = (types_per_block + type_slots - 1) / type_slots;
  const size_t group_iters = (groups + group_lanes - 1) / group_lanes;
  l.cells = type_iters * group_iters * threads;
  l.state_bytes = round16(l.cells * (5 * sizeof(float) + 1));
  return l;
}

// a / b for b > 0: the IEEE quotient. The card's division takes its slow
// path for a zero dividend; a zero divides as 1.0 instead and the select
// gives back a itself (0 / b is 0 with a's sign when b > 0).
__device__ __forceinline__ float div_pos(float a, float b) {
  const unsigned bits = __float_as_uint(a);
  const bool zero = (bits << 1) == 0u;
  const float q = __fdiv_rn(__uint_as_float(zero ? 0x3f800000u : bits), b);
  return zero ? a : q;
}

// sqrtf(a) for a >= 0, the same way round a zero.
__device__ __forceinline__ float sqrt_nonneg(float a) {
  const unsigned bits = __float_as_uint(a);
  const bool zero = (bits << 1) == 0u;
  const float r = __fsqrt_rn(__uint_as_float(zero ? 0x3f800000u : bits));
  return zero ? a : r;
}

// Over the lanes of a warp that share this lane's group lane (lane % Q): a
// butterfly, so every lane ends with the same bits.
__device__ inline float sum_over_type_slots(float value, int group_lanes) {
  for (int offset = group_lanes; offset < 32; offset <<= 1) {
    value += __shfl_xor_sync(kFullMask, value, offset);
  }
  return value;
}

__device__ inline float max_over_type_slots(float value, int group_lanes) {
  for (int offset = group_lanes; offset < 32; offset <<= 1) {
    value = fmaxf(value, __shfl_xor_sync(kFullMask, value, offset));
  }
  return value;
}

// Over the Q adjacent lanes of one type.
__device__ inline float sum_over_group_lanes(float value, int group_lanes) {
  for (int offset = 1; offset < group_lanes; offset <<= 1) {
    value += __shfl_xor_sync(kFullMask, value, offset);
  }
  return value;
}

// kTablesInShared is known at compile time so that the hot loops' table
// reads are shared-memory loads, not generic ones.
template <bool kTablesInShared>
__global__ void __launch_bounds__(kMaxThreads)
lp_relax_kernel(const float* __restrict__ vectors_in,
                const int* __restrict__ counts_in,
                const float* __restrict__ capacity,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ prices,
                const float* __restrict__ bias,  // [steps, 2]
                Shape shape,
                float* __restrict__ assignment,  // [G, T]
                float* __restrict__ nodes_out,   // [T]
                float* __restrict__ objective,   // [1]
                unsigned char* __restrict__ scratch,
                float* __restrict__ table_scratch) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int groups = shape.groups;
  const int types = shape.types;
  const int dims = shape.dims;
  const int lanes_q = shape.group_lanes;
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr bool tables_in_shared = kTablesInShared;
  const Layout layout = make_layout(groups, dims, shape.types_per_block, threads, lanes_q,
                                    blocks, tables_in_shared);

  float* table = reinterpret_cast<float*>(shared_raw);
  // The group tables: in shared memory, or in this block's slice of the
  // global scratch; the exchange tables there are the cluster's one copy.
  float* group_table =
      tables_in_shared ? table : table_scratch + size_t(rank) * layout.group_words;
  float* exchange_table = tables_in_shared ? table : table_scratch;
  float* vectors = group_table + layout.vectors;
  float* counts = group_table + layout.counts;
  float* cap = table + layout.cap;  // max(K, 1e-3) of this block's types
  float* price = table + layout.price;
  // The axes some group requests (v != 0), in ascending order, then their
  // count: on every other axis D = 0, and its w and dD meet only v = 0.
  int* requested = reinterpret_cast<int*>(table + layout.requested);
  // [TB, 8]: D, then dD, of this block's types on the requested axes.
  float* column = table + layout.column;
  float* red_sum = group_table + layout.red_sum;  // [warps, G]
  float* red_max = group_table + layout.red_max;  // [warps, G]
  float* row_dot = group_table + layout.row_dot;
  // The softmax's reference: the row max of the logits as the last softmax
  // saw them (exactly the max at the start).
  float* row_ref = group_table + layout.row_ref;
  float* row_total = group_table + layout.row_total;
  // [cluster, G] row dots, [cluster, G, 2] (block max, block sum), [cluster]
  // objective partials: block b writes row b of every block's copy (of the
  // one global copy when the tables are in global scratch).
  float* gather_dot = exchange_table + layout.gather_dot;
  float* gather_soft = exchange_table + layout.gather_soft;
  float* gather_obj = table + layout.gather_obj;
  // Row `rank` of an exchange table: into every block's copy, or once.
  auto publish = [&](float* gather, size_t index, float value) {
    if (tables_in_shared) {
      for (int b = 0; b < blocks; ++b) cluster.map_shared_rank(gather, b)[index] = value;
    } else {
      gather[index] = value;
    }
  };
  // The cluster barrier; global exchange rows are fenced before it.
  auto exchange_barrier = [&]() {
    if (!tables_in_shared) __threadfence();
    cluster.sync();
  };
  // A row of an exchange table after the barrier; a global one is read past
  // the SM's L1 (__ldcg), which another SM's writes do not update.
  auto gathered = [&](const float* gather, size_t index) {
    return tables_in_shared ? gather[index] : __ldcg(gather + index);
  };

  unsigned char* state = scratch == nullptr
                             ? shared_raw + layout.table_bytes
                             : scratch + size_t(rank) * layout.state_bytes;
  float* logits = reinterpret_cast<float*>(state);
  float* mu = logits + layout.cells;
  float* nu = mu + layout.cells;
  float* share = nu + layout.cells;
  float* d_share = share + layout.cells;
  unsigned char* feasible = reinterpret_cast<unsigned char*>(d_share + layout.cells);

  const int first_type = rank * shape.types_per_block;
  const int block_types = max(0, min(shape.types_per_block, types - first_type));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = tid % lanes_q;
  const int slot = tid / lanes_q;
  const int type_slots = threads / lanes_q;
  const int type_iters = shape.type_iters;
  const int group_iters = shape.group_iters;
  const bool lead = lane < lanes_q;  // the first type slot of the warp
  // Cell (j, k) of this thread: local type slot + j * type_slots, group
  // q + k * Q, stored at (j * group_iters + k) * threads + tid.
  auto cell = [&](int j, int k) { return (j * group_iters + k) * threads + tid; };
  auto local_type = [&](int j) { return slot + j * type_slots; };
  auto group_of = [&](int k) { return q + k * lanes_q; };

  for (int i = tid; i < groups * dims; i += threads) vectors[i] = vectors_in[i];
  for (int g = tid; g < groups; g += threads) counts[g] = static_cast<float>(counts_in[g]);
  for (int i = tid; i < block_types * dims; i += threads) {
    cap[i] = fmaxf(capacity[size_t(first_type) * dims + i], kCapacityFloor);
  }
  for (int i = tid; i < block_types; i += threads) price[i] = prices[first_type + i];
  if (tid == 0) {
    int count = 0;
    for (int r = 0; r < dims; ++r) {
      bool any = false;
      for (int g = 0; g < groups; ++g) any = any || vectors_in[g * dims + r] != 0.0f;
      if (any) requested[count++] = r;
    }
    requested[kMaxDims] = count;
  }
  __syncthreads();
  const int num_requested = requested[kMaxDims];
  const int num_unrequested = dims - num_requested;

  // Feasibility (one pod of g fits an empty t, t valid), the price-density
  // start -log(p / max(max_r K, 1) + 1e-9) broadcast over the groups, and
  // zero moments.
  for (int j = 0; j < type_iters; ++j) {
    const int tl = local_type(j);
    const bool type_in = tl < block_types;
    const int t = first_type + tl;
    float start = 0.0f;
    if (type_in) {
      float widest = -INFINITY;
      for (int r = 0; r < dims; ++r) widest = fmaxf(widest, capacity[size_t(t) * dims + r]);
      start = -logf(price[tl] / fmaxf(widest, 1.0f) + 1e-9f);
    }
    for (int k = 0; k < group_iters; ++k) {
      const int g = group_of(k);
      const int c = cell(j, k);
      bool fits = false;
      if (type_in && g < groups) {
        fits = valid[t] != 0;
        for (int r = 0; r < dims; ++r) {
          fits = fits && vectors[g * dims + r] <= capacity[size_t(t) * dims + r] + 1e-6f;
        }
      }
      feasible[c] = fits;
      logits[c] = start;
      mu[c] = 0.0f;
      nu[c] = 0.0f;
      share[c] = 0.0f;
      d_share[c] = 0.0f;
    }
  }

  // The exchanges: thread g sums the block's warp partials of row g in
  // warp order and writes the block's partial into row `rank` of every
  // block's gather table; after the cluster barrier, thread g combines the
  // rows in rank order. Every block does the same sums in the same order,
  // so every block holds the same bits.
  auto block_partial = [&](const float* red, bool is_max, int g) {
    float value = is_max ? -INFINITY : 0.0f;
#pragma unroll 8
    for (int w = 0; w < warps; ++w) {
      const float part = red[w * groups + g];
      value = is_max ? fmaxf(value, part) : value + part;
    }
    return value;
  };

  // The exact row max of the masked logits, once, as the first reference.
  for (int k = 0; k < group_iters; ++k) {
    const int g = group_of(k);
    float top = -INFINITY;
    for (int j = 0; j < type_iters; ++j) {
      if (local_type(j) < block_types && g < groups) {
        const int c = cell(j, k);
        top = fmaxf(top, feasible[c] ? logits[c] : kMasked);
      }
    }
    top = max_over_type_slots(top, lanes_q);
    if (lead && g < groups) red_max[warp * groups + g] = top;
  }
  __syncthreads();
  for (int g = tid; g < groups; g += threads) {
    const float top = block_partial(red_max, true, g);
    // The dot rows are free until the first step; the softmax's rows are
    // next, so the two exchanges in a row use different rows.
    publish(gather_dot, size_t(rank) * groups + g, top);
  }
  exchange_barrier();
  for (int g = tid; g < groups; g += threads) {
    float top = -INFINITY;
    for (int b = 0; b < blocks; ++b) top = fmaxf(top, gathered(gather_dot, size_t(b) * groups + g));
    row_ref[g] = top;
  }
  __syncthreads();

  // S = softmax_t(where(F, L, -1e9)) over the cluster in one pass: each
  // thread takes e = exp(L - ref) of its cells, with ref the row max the
  // last pass found (the logits move by at most lr * 7.3 a step under
  // Adam's defaults, so exp neither overflows nor loses the row), and keeps
  // e in `share`; the blocks exchange their sums and maxima at once; the
  // maxima become the next reference. The next column pass divides e by
  // the row's total as it reads the cell.
  auto exp_cell = [&](int c, float ref, float& total, float& top) {
    const float masked = feasible[c] ? logits[c] : kMasked;
    const float e = expf(masked - ref);
    share[c] = e;
    total += e;
    top = fmaxf(top, masked);
  };
  auto publish_exp_partials = [&](int g, float total, float top) {
    total = sum_over_type_slots(total, lanes_q);
    top = max_over_type_slots(top, lanes_q);
    if (lead && g < groups) {
      red_sum[warp * groups + g] = total;
      red_max[warp * groups + g] = top;
    }
  };
  auto exchange_softmax = [&]() {
    __syncthreads();
    for (int g = tid; g < groups; g += threads) {
      const float total = block_partial(red_sum, false, g);
      const float top = block_partial(red_max, true, g);
      publish(gather_soft, 2 * (size_t(rank) * groups + g), top);
      publish(gather_soft, 2 * (size_t(rank) * groups + g) + 1, total);
    }
    exchange_barrier();
    for (int g = tid; g < groups; g += threads) {
      float top = -INFINITY;
      float total = 0.0f;
      for (int b = 0; b < blocks; ++b) {
        top = fmaxf(top, gathered(gather_soft, 2 * (size_t(b) * groups + g)));
        total += gathered(gather_soft, 2 * (size_t(b) * groups + g) + 1);
      }
      row_total[g] = total;
      row_ref[g] = top;
    }
    __syncthreads();
  };

  for (int k = 0; k < group_iters; ++k) {
    const int g = group_of(k);
    float total = 0.0f;
    float top = -INFINITY;
    for (int j = 0; j < type_iters; ++j) {
      if (local_type(j) < block_types && g < groups) exp_cell(cell(j, k), row_ref[g], total, top);
    }
    publish_exp_partials(g, total, top);
  }
  exchange_softmax();

  // Lanes of one type in the column pass: a power of two, at least the
  // number of requested axes.
  int axis_lanes = 1;
  while (axis_lanes < num_requested) axis_lanes <<= 1;

  for (int step = 0; step < shape.steps; ++step) {
    // Columns, in three passes over the block.
    // 1. Each cell: S = e / total, x = c * S, and the type's D on the
    //    requested axes over its groups, then the butterfly over its Q
    //    lanes; lane q = 0 writes D[t, :] to `column`.
    for (int j = 0; j < type_iters; ++j) {
      const int tl = local_type(j);
      const bool type_in = tl < block_types;
      float demand[kMaxDims];
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) demand[d] = 0.0f;
      for (int k = 0; k < group_iters; ++k) {
        const int g = group_of(k);
        if (!type_in || g >= groups) continue;
        const int c = cell(j, k);
        const float normalized = div_pos(share[c], row_total[g]);
        share[c] = normalized;
        const float x = feasible[c] ? counts[g] * normalized : 0.0f;
#pragma unroll
        for (int d = 0; d < kMaxDims; ++d) {
          if (d < num_requested) demand[d] += x * vectors[g * dims + requested[d]];
        }
      }
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) {
        if (d < num_requested) demand[d] = sum_over_group_lanes(demand[d], lanes_q);
      }
      if (type_in && q == 0) {
#pragma unroll
        for (int d = 0; d < kMaxDims; ++d) {
          if (d < num_requested) column[tl * kMaxDims + d] = demand[d];
        }
      }
    }
    __syncthreads();
    // 2. One lane per (type, requested axis): s * f, the smooth max's w and
    //    dD over the type's axis lanes; dD replaces D in `column`. On an
    //    axis no group requests, D = 0, s * f = 0 and exp(0 - max) only
    //    joins the sum.
    const int items = block_types * axis_lanes;
    for (int item = tid; item < ((items + 31) & ~31); item += threads) {
      const int tl = item / axis_lanes;
      const int d = item % axis_lanes;
      const bool live = item < items && d < num_requested;
      const int r = live ? requested[d] : 0;
      float scaled = -INFINITY;
      if (live) scaled = div_pos(column[tl * kMaxDims + d], cap[tl * dims + r]) * kSharpness;
      float top = num_unrequested > 0 ? fmaxf(scaled, 0.0f) : scaled;
      for (int offset = 1; offset < axis_lanes; offset <<= 1) {
        top = fmaxf(top, __shfl_xor_sync(kFullMask, top, offset));
      }
      const float e = live ? expf(scaled - top) : 0.0f;
      float total = e;
      for (int offset = 1; offset < axis_lanes; offset <<= 1) {
        total += __shfl_xor_sync(kFullMask, total, offset);
      }
      if (num_unrequested > 0) total += static_cast<float>(num_unrequested) * expf(0.0f - top);
      if (live) {
        column[tl * kMaxDims + d] = div_pos(price[tl] * div_pos(e, total), cap[tl * dims + r]);
      }
    }
    __syncthreads();
    // 3. Each cell: dx = sum_r v[g, r] * dD[t, r] over the requested axes,
    //    dS, and the row dot's partial sum_t S * dS.
    for (int k = 0; k < group_iters; ++k) {
      const int g = group_of(k);
      float partial = 0.0f;
      for (int j = 0; j < type_iters; ++j) {
        const int tl = local_type(j);
        if (tl >= block_types || g >= groups) continue;
        float dx = 0.0f;
        for (int d = 0; d < num_requested; ++d) {
          dx += vectors[g * dims + requested[d]] * column[tl * kMaxDims + d];
        }
        const int c = cell(j, k);
        const float d_s = feasible[c] ? counts[g] * dx : 0.0f;
        d_share[c] = d_s;
        partial += share[c] * d_s;
      }
      partial = sum_over_type_slots(partial, lanes_q);
      if (lead && g < groups) red_sum[warp * groups + g] = partial;
    }

    // The row dot sum_t S * dS over the cluster.
    __syncthreads();
    for (int g = tid; g < groups; g += threads) {
      const float total = block_partial(red_sum, false, g);
      publish(gather_dot, size_t(rank) * groups + g, total);
    }
    exchange_barrier();
    for (int g = tid; g < groups; g += threads) {
      float total = 0.0f;
      for (int b = 0; b < blocks; ++b) total += gathered(gather_dot, size_t(b) * groups + g);
      row_dot[g] = total;
    }
    __syncthreads();

    // The softmax's backward and Adam, cell by cell, then the next
    // softmax's exp. An infeasible cell has gradient 0 in every step, so its
    // moments stay 0 and its logit does not move (L + -0 = L): Adam skips
    // it.
    const float bias_1 = bias[2 * step];
    const float bias_2 = bias[2 * step + 1];
    for (int k = 0; k < group_iters; ++k) {
      const int g = group_of(k);
      float total = 0.0f;
      float top = -INFINITY;
      for (int j = 0; j < type_iters; ++j) {
        if (local_type(j) >= block_types || g >= groups) continue;
        const int c = cell(j, k);
        if (feasible[c]) {
          const float grad = share[c] * (d_share[c] - row_dot[g]);
          const float m = kOneMinusB1 * grad + kB1 * mu[c];
          const float v = kOneMinusB2 * (grad * grad) + kB2 * nu[c];
          mu[c] = m;
          nu[c] = v;
          const float m_hat = div_pos(m, bias_1);
          const float v_hat = div_pos(v, bias_2);
          logits[c] = logits[c] + -kLearningRate * div_pos(m_hat, sqrt_nonneg(v_hat) + kAdamEps);
        }
        exp_cell(c, row_ref[g], total, top);
      }
      publish_exp_partials(g, total, top);
    }
    exchange_softmax();
  }

  // The result: S = e / total, x and the assignment, D on every axis over
  // the type's Q lanes, and the hard max over the axes; lane q = 0 of each
  // type writes its node count and adds its share of the objective.
  float partial = 0.0f;
  for (int j = 0; j < type_iters; ++j) {
    const int tl = local_type(j);
    const bool type_in = tl < block_types;
    float demand[kMaxDims];
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) demand[r] = 0.0f;
    for (int k = 0; k < group_iters; ++k) {
      const int g = group_of(k);
      if (!type_in || g >= groups) continue;
      const int c = cell(j, k);
      const float x = feasible[c] ? counts[g] * div_pos(share[c], row_total[g]) : 0.0f;
      assignment[size_t(g) * types + first_type + tl] = x;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) demand[r] += x * vectors[g * dims + r];
      }
    }
    float most = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      if (r < dims) {
        demand[r] = sum_over_group_lanes(demand[r], lanes_q);
        if (type_in) most = fmaxf(most, demand[r] / cap[tl * dims + r]);
      }
    }
    if (type_in && q == 0) {
      nodes_out[first_type + tl] = most;
      partial += price[tl] * most;
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    partial += __shfl_xor_sync(kFullMask, partial, offset);
  }
  if (lane == 0) red_sum[warp] = partial;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < warps; ++w) total += red_sum[w];
    cluster.map_shared_rank(gather_obj, 0)[rank] = total;
  }
  // After this barrier no block writes into another's shared memory, so
  // the blocks may leave while rank 0 sums.
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float total = 0.0f;
    for (int b = 0; b < blocks; ++b) total += gather_obj[b];
    objective[0] = total;
  }
}

// The last configuration the card accepted, so the attributes are set and
// the occupancy query runs once per configuration and device.
struct Accepted {
  int device = -1, cluster = 0, threads = 0;
  size_t bytes = 0;
  bool tables_in_shared = true;
};
Accepted accepted;
std::mutex accepted_lock;

}  // namespace

// Dynamic shared memory of one block: the tables (without the group tables
// when they live in global scratch), and the state when it lives in shared
// memory.
extern "C" long long ktt_lp_relax_shared_bytes(int groups, int dims, int types_per_block,
                                               int threads, int group_lanes, int cluster,
                                               int state_in_shared, int tables_in_shared) {
  const Layout l = make_layout(groups, dims, types_per_block, threads, group_lanes, cluster,
                               tables_in_shared != 0);
  return static_cast<long long>(l.table_bytes + (state_in_shared ? l.state_bytes : 0));
}

// Bytes of the global table scratch when the group tables live there.
extern "C" long long ktt_lp_relax_table_bytes(int groups, int dims, int types_per_block,
                                              int threads, int group_lanes, int cluster) {
  return static_cast<long long>(
      make_layout(groups, dims, types_per_block, threads, group_lanes, cluster, false)
          .global_table_bytes);
}

// Bytes of one block's state; the global scratch holds cluster times this.
extern "C" long long ktt_lp_relax_state_bytes(int groups, int dims, int types_per_block,
                                              int threads, int group_lanes) {
  return static_cast<long long>(
      make_layout(groups, dims, types_per_block, threads, group_lanes, 1).state_bytes);
}

// vectors [G, R] f32, counts [G] i32, capacity [T, R] f32, valid [T] bool
// (one byte each), prices [T] f32, bias [steps, 2] f32; out assignment
// [G, T] f32, nodes [T] f32, objective [1] f32. One cluster of `cluster`
// blocks (2..16) of `threads` threads (a multiple of 32, at most 512), Q =
// group_lanes (a power of two up to 32); block b owns the types
// [b * TB, (b + 1) * TB) with TB = ceil(T / cluster). scratch is null to
// keep the state in shared memory, else cluster * ktt_lp_relax_state_bytes
// bytes; table_scratch is null to keep the group tables in shared memory,
// else ktt_lp_relax_table_bytes bytes (the state is then in global scratch
// too). All contiguous on the current device. Returns a CUDA error code:
// the occupancy query's, cudaErrorInvalidConfiguration when the card
// cannot place the cluster, or the launch's.
extern "C" int ktt_lp_relax(const void* vectors, const void* counts,
                            const void* capacity, const void* valid,
                            const void* prices, const void* bias, int groups,
                            int types, int dims, int steps, int cluster, int threads,
                            int group_lanes, void* assignment, void* nodes,
                            void* objective, void* scratch, void* table_scratch,
                            void* stream) {
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims || steps < 0 ||
      cluster < 2 || cluster > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || group_lanes < 1 || group_lanes > 32 ||
      (group_lanes & (group_lanes - 1)) != 0 ||
      (table_scratch != nullptr && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Shape shape;
  shape.groups = groups;
  shape.types = types;
  shape.dims = dims;
  shape.steps = steps;
  shape.types_per_block = (types + cluster - 1) / cluster;
  shape.group_lanes = group_lanes;
  const int type_slots = threads / group_lanes;
  shape.type_iters = (shape.types_per_block + type_slots - 1) / type_slots;
  shape.group_iters = (groups + group_lanes - 1) / group_lanes;
  const Layout layout = make_layout(groups, dims, shape.types_per_block, threads, group_lanes,
                                    cluster, table_scratch == nullptr);
  const size_t bytes = layout.table_bytes + (scratch == nullptr ? layout.state_bytes : 0);

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  void (*kernel)(const float*, const int*, const float*, const unsigned char*, const float*,
                 const float*, Shape, float*, float*, float*, unsigned char*, float*) =
      table_scratch == nullptr ? lp_relax_kernel<true> : lp_relax_kernel<false>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> hold(accepted_lock);
    if (accepted.device != device || accepted.cluster != cluster ||
        accepted.threads != threads || accepted.bytes != bytes ||
        accepted.tables_in_shared != (table_scratch == nullptr)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes > kDefaultSharedLimit ? bytes : kDefaultSharedLimit));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (cluster > kPortableCluster) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      accepted.device = device;
      accepted.cluster = cluster;
      accepted.threads = threads;
      accepted.bytes = bytes;
      accepted.tables_in_shared = table_scratch == nullptr;
    }
  }
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(vectors),
      static_cast<const int*>(counts), static_cast<const float*>(capacity),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(prices),
      static_cast<const float*>(bias), shape, static_cast<float*>(assignment),
      static_cast<float*>(nodes), static_cast<float*>(objective),
      static_cast<unsigned char*>(scratch), static_cast<float*>(table_scratch));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
