// K9a: one shard's part of a step of the sharded LP relaxation on Hopper
// (sm_90a).
//
// Replaces the [G, T] bulk of karpenter_tpu/models/solver.py::
// _sharded_fused_kernel, which is lp_relax_body
// (karpenter_tpu/ops/score_kernel.py:77-135) under GSPMD: the logits, both
// Adam moments, the softmax and its backward sharded over a ("groups",
// "types") mesh, with XLA's collectives between. Here a shard owns the
// block [G/g, T/t] of every [G, T] tensor and one Adam step is three
// launches a shard, split where the step needs another shard's numbers;
// the reductions between them run in parallel/collectives.py:
//
//   softmax   (Adam on the cells with grad = S * (dS - dot), from the last
//             step's S, dS and row dot), then e = exp(where(F, L, -1e9) -
//             ref) into `share`, and the block's row max and row sum of e
//             -> max and sum over the types axis;
//   demand    S = e / total (into `share`), x = where(F, c * S, 0), and
//             the block's partial D[t, r] = sum_g x * v[g, r] -> sum over
//             the groups axis;
//   row_dot   per type the smooth max's w = softmax_r(20 * D / max(K,
//             1e-3)) and dD = p * w / max(K, 1e-3); per cell dx = sum_r v *
//             dD and dS = where(F, c * dx, 0) (into `d_share`), and the
//             block's row dot sum_t S * dS -> sum over the types axis.
//
// The softmax takes e against `ref`, the row max the previous step's
// reduction found, as K3 does (csrc/lp_relax.cu): Adam moves a logit by at
// most lr * 7.3 a step, so exp neither overflows nor loses the row. With
// `ref` null the launch only takes the row max (the exact first reference).
// With `assignment` set, demand also writes x (the final pass).
//
// Two routes, chosen by the mesh (parallel/sharded_solver.py):
//
//   * per phase, for a mesh that spans cards: the three kernels above, one
//     launch a phase a shard, with the collectives (and the transport
//     between cards) between them. Launch latency bounds it: a shard's
//     block is small and each launch microseconds of work.
//   * persistent, for a mesh whose shards all lie on one card: the whole LP
//     (the exact first row max, every Adam step, the final pass that writes
//     the relaxed assignment) is one cooperative launch. Each block owns a
//     fixed tile of one shard's block for the whole LP, its logits, moments,
//     S and dS in shared memory while they fit, else in global scratch (at
//     G 2,048 x T 512 they fit; the scratch stays in the 50 MB L2 past
//     that). The three reductions of a step go through exchange buffers
//     with a slot a (shard, tile): [row][slot] for the row max, row sum and
//     row dot, [slot][axis][type] for the demand (so a warp's loads of it
//     coalesce). Every block writes its partials, a grid-wide barrier
//     (cooperative_groups' grid.sync()), then every block that needs a
//     total sums the partials itself in ascending (shard, tile) order, as
//     parallel/collectives.py reduces in ascending shard order. No float
//     atomics, so two launches give the same bits. Three barriers a step
//     (PERF.md §6 gives the time a step); the blocks are at most one an SM
//     (lp_shard_launch_plan), so a cooperative launch holds them all.
//
// Numerics follow K3: the build passes --fmad=false and never fast math
// (expf, IEEE division and square root), optax's order of operations for
// Adam with the caller's bias corrections (1 - b**k), masks as selects.
// Sums run in a fixed order (a block's threads in a shuffle tree, then the
// warps in order), so a launch gives the same bits every time; the order
// differs from the plain versions', so the kernels agree with them to the
// LP tolerances, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDims = 8;
constexpr int kRowThreads = 256;
constexpr int kTypeThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kSharpness = 20.0f;
constexpr float kMasked = -1e9f;
constexpr float kCapacityFloor = 1e-3f;
constexpr float kLearningRate = 0.25f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;

// a / b for b > 0, the IEEE quotient; a zero dividend takes the select,
// not the division's slow path (csrc/lp_relax.cu div_pos).
__device__ __forceinline__ float div_pos(float a, float b) {
  const unsigned bits = __float_as_uint(a);
  const bool zero = (bits << 1) == 0u;
  const float q = __fdiv_rn(__uint_as_float(zero ? 0x3f800000u : bits), b);
  return zero ? a : q;
}

__device__ __forceinline__ float sqrt_nonneg(float a) {
  const unsigned bits = __float_as_uint(a);
  const bool zero = (bits << 1) == 0u;
  const float r = __fsqrt_rn(__uint_as_float(zero ? 0x3f800000u : bits));
  return zero ? a : r;
}

// The block's sum (or max) in a fixed order: a butterfly in each warp,
// then thread 0 over the warps in order. Every thread must call it.
__device__ float block_reduce(float value, bool is_max, float* scratch) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_xor_sync(kFullMask, value, offset);
    value = is_max ? fmaxf(value, other) : value + other;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = value;
  __syncthreads();
  float total = is_max ? -INFINITY : 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      total = is_max ? fmaxf(total, scratch[w]) : total + scratch[w];
    }
  }
  __syncthreads();
  return total;
}

// One block a group row; threads stride over the shard's types.
__global__ void __launch_bounds__(kRowThreads)
lp_shard_softmax_kernel(float* __restrict__ logits, float* __restrict__ mu, float* __restrict__ nu,
                        float* __restrict__ share, const float* __restrict__ d_share,
                        const unsigned char* __restrict__ feasible,
                        const float* __restrict__ row_dot, const float* __restrict__ ref,
                        const float* __restrict__ bias, int types, float* __restrict__ out_max,
                        float* __restrict__ out_sum) {
  __shared__ float scratch[kRowThreads / 32];
  const int g = blockIdx.x;
  const size_t row = size_t(g) * types;
  const bool adam = bias != nullptr;
  const float bias_1 = adam ? bias[0] : 1.0f;
  const float bias_2 = adam ? bias[1] : 1.0f;
  const float dot = adam ? row_dot[g] : 0.0f;
  const float reference = ref != nullptr ? ref[g] : 0.0f;
  float top = -INFINITY;
  float total = 0.0f;
  for (int t = threadIdx.x; t < types; t += blockDim.x) {
    const size_t c = row + t;
    const bool f = feasible[c] != 0;
    float logit = logits[c];
    if (adam && f) {
      const float grad = share[c] * (d_share[c] - dot);
      const float m = kOneMinusB1 * grad + kB1 * mu[c];
      const float v = kOneMinusB2 * (grad * grad) + kB2 * nu[c];
      mu[c] = m;
      nu[c] = v;
      const float m_hat = div_pos(m, bias_1);
      const float v_hat = div_pos(v, bias_2);
      logit = logit + -kLearningRate * div_pos(m_hat, sqrt_nonneg(v_hat) + kAdamEps);
      logits[c] = logit;
    }
    const float masked = f ? logit : kMasked;
    top = fmaxf(top, masked);
    if (ref != nullptr) {
      const float e = expf(masked - reference);
      share[c] = e;
      total += e;
    }
  }
  top = block_reduce(top, true, scratch);
  if (ref != nullptr) total = block_reduce(total, false, scratch);
  if (threadIdx.x == 0) {
    out_max[g] = top;
    if (ref != nullptr) out_sum[g] = total;
  }
}

// One thread a type; each walks the shard's groups in order.
__global__ void __launch_bounds__(kTypeThreads)
lp_shard_demand_kernel(float* __restrict__ share, const unsigned char* __restrict__ feasible,
                       const float* __restrict__ counts, const float* __restrict__ vectors,
                       const float* __restrict__ row_total, int groups, int types, int dims,
                       float* __restrict__ demand, float* __restrict__ assignment) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= types) return;
  float acc[kMaxDims];
#pragma unroll
  for (int r = 0; r < kMaxDims; ++r) acc[r] = 0.0f;
  for (int g = 0; g < groups; ++g) {
    const size_t c = size_t(g) * types + t;
    const float s = div_pos(share[c], row_total[g]);
    share[c] = s;
    const float x = feasible[c] != 0 ? counts[g] * s : 0.0f;
    if (assignment != nullptr) assignment[c] = x;
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      if (r < dims) acc[r] += x * vectors[g * dims + r];
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxDims; ++r) {
    if (r < dims) demand[size_t(t) * dims + r] = acc[r];
  }
}

// One block a group row; threads stride over the shard's types, each
// taking its type's dD from the reduced D.
__global__ void __launch_bounds__(kRowThreads)
lp_shard_row_dot_kernel(const float* __restrict__ share, float* __restrict__ d_share,
                        const unsigned char* __restrict__ feasible, const float* __restrict__ counts,
                        const float* __restrict__ vectors, const float* __restrict__ capacity,
                        const float* __restrict__ prices, const float* __restrict__ demand, int types,
                        int dims, float* __restrict__ out_dot) {
  __shared__ float scratch[kRowThreads / 32];
  const int g = blockIdx.x;
  float v[kMaxDims];
#pragma unroll
  for (int r = 0; r < kMaxDims; ++r) v[r] = r < dims ? vectors[g * dims + r] : 0.0f;
  const float count = counts[g];
  float partial = 0.0f;
  for (int t = threadIdx.x; t < types; t += blockDim.x) {
    float scaled[kMaxDims];
    float floor_cap[kMaxDims];
    float top = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      if (r < dims) {
        floor_cap[r] = fmaxf(capacity[size_t(t) * dims + r], kCapacityFloor);
        scaled[r] = div_pos(demand[size_t(t) * dims + r], floor_cap[r]) * kSharpness;
        top = fmaxf(top, scaled[r]);
      }
    }
    float total = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      if (r < dims) {
        scaled[r] = expf(scaled[r] - top);
        total += scaled[r];
      }
    }
    float dx = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      if (r < dims) dx += v[r] * div_pos(prices[t] * div_pos(scaled[r], total), floor_cap[r]);
    }
    const size_t c = size_t(g) * types + t;
    const float ds = feasible[c] != 0 ? count * dx : 0.0f;
    d_share[c] = ds;
    partial += share[c] * ds;
  }
  partial = block_reduce(partial, false, scratch);
  if (threadIdx.x == 0) out_dot[g] = partial;
}

// --- the persistent route ------------------------------------------------------

constexpr int kPersistThreads = 256;
constexpr int kPersistWarps = kPersistThreads / 32;

// The mesh, one shard's block and its tiling: a shard's [rows, cols] block
// is cut into row_tiles x col_tiles tiles of tile_rows x tile_cols cells
// (the last ones ragged), one block each; block b owns tile b % tiles of
// shard b / tiles (shards in the mesh's flat order, row-major).
struct PersistShape {
  int mesh_rows, mesh_cols;
  int rows, cols, dims;
  int steps;
  int row_tiles, col_tiles, tile_rows, tile_cols;
  int final_pass;
};

// Every [S, rows, cols] tensor is the shards' blocks stacked in the mesh's
// flat order; the group tables stacked by mesh row are the full [G, R] and
// [G], the type tables stacked by mesh column the full [T, R] and [T].
struct PersistArgs {
  const float* vectors;           // [G, R]
  const float* counts;            // [G]
  const float* capacity;          // [T, R]
  const float* prices;            // [T]
  const unsigned char* feasible;  // [S, rows, cols]
  float* logits;                  // [S, rows, cols], in and out
  float* mu;
  float* nu;
  float* share;    // [S, rows, cols] scratch, or null: the state in shared memory
  float* d_share;  // likewise
  const float* bias;   // [steps, 2]
  float* ex_max;       // [G, P], P = mesh_cols * col_tiles
  float* ex_sum;       // [G, P]
  float* ex_dot;       // [G, P]
  float* ex_demand;    // [Q, R, T], Q = mesh_rows * row_tiles
  float* assignment;   // [S, rows, cols], with final_pass
  float* demand_out;   // [T, R]
};

__host__ __device__ inline size_t round16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Byte offsets into a block's shared memory: the tile rows' tables (vectors
// [TR, R], counts, the softmax reference, its row totals, the row dots),
// the tile columns' tables (max(K, 1e-3) [R, TC], prices, dD [R, TC]), then
// the state when it lives there (logits, mu, nu, S, dS [TR, TC] float32,
// the mask [TR, TC] bytes).
struct PersistLayout {
  size_t vec, count, ref, total, dot, cap, price, d_demand;
  size_t logits, mu, nu, share, d_share, feasible;
  size_t table_bytes, state_bytes;
};

__host__ __device__ inline PersistLayout persist_layout(int tile_rows, int tile_cols, int dims) {
  PersistLayout l;
  const size_t tr = tile_rows, tc = tile_cols, cells = tr * tc;
  size_t o = 0;
  l.vec = o;      o += round16(4 * tr * dims);
  l.count = o;    o += round16(4 * tr);
  l.ref = o;      o += round16(4 * tr);
  l.total = o;    o += round16(4 * tr);
  l.dot = o;      o += round16(4 * tr);
  l.cap = o;      o += round16(4 * tc * dims);
  l.price = o;    o += round16(4 * tc);
  l.d_demand = o; o += round16(4 * tc * dims);
  l.table_bytes = o;
  l.logits = o;   o += round16(4 * cells);
  l.mu = o;       o += round16(4 * cells);
  l.nu = o;       o += round16(4 * cells);
  l.share = o;    o += round16(4 * cells);
  l.d_share = o;  o += round16(4 * cells);
  l.feasible = o; o += round16(cells);
  l.state_bytes = o - l.table_bytes;
  return l;
}

// A warp's sum (or max) in a fixed order: every lane ends with the total.
__device__ __forceinline__ float warp_reduce(float value, bool is_max) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_xor_sync(kFullMask, value, offset);
    value = is_max ? fmaxf(value, other) : value + other;
  }
  return value;
}

template <bool kStateInShared>
__global__ void __launch_bounds__(kPersistThreads, 1)
lp_shard_persistent_kernel(PersistArgs a, PersistShape sh) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const PersistLayout layout = persist_layout(sh.tile_rows, sh.tile_cols, sh.dims);
  const int dims = sh.dims;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = sh.row_tiles * sh.col_tiles;
  const int shard = blockIdx.x / tiles;
  const int tile = blockIdx.x - shard * tiles;
  const int rt = tile / sh.col_tiles;
  const int ct = tile - rt * sh.col_tiles;
  const int mesh_row = shard / sh.mesh_cols;
  const int mesh_col = shard - mesh_row * sh.mesh_cols;
  const int r0 = rt * sh.tile_rows;
  const int c0 = ct * sh.tile_cols;
  const int nr = min(sh.tile_rows, sh.rows - r0);
  const int nc = min(sh.tile_cols, sh.cols - c0);
  const int tc = sh.tile_cols;
  const int row0 = mesh_row * sh.rows + r0;  // the tile's first row of [G, ...]
  const int col0 = mesh_col * sh.cols + c0;  // its first column of [T, ...]
  // A row's partials: one a (mesh column, column tile), in that order; a
  // column's: one a (mesh row, row tile).
  const int row_slots = sh.mesh_cols * sh.col_tiles;
  const int row_slot = mesh_col * sh.col_tiles + ct;
  const int col_slots = sh.mesh_rows * sh.row_tiles;
  const int col_slot = mesh_row * sh.row_tiles + rt;
  const size_t cell0 = size_t(shard) * sh.rows * sh.cols + size_t(r0) * sh.cols + c0;

  float* s_vec = reinterpret_cast<float*>(shared_raw + layout.vec);
  float* s_count = reinterpret_cast<float*>(shared_raw + layout.count);
  float* s_ref = reinterpret_cast<float*>(shared_raw + layout.ref);
  float* s_total = reinterpret_cast<float*>(shared_raw + layout.total);
  float* s_dot = reinterpret_cast<float*>(shared_raw + layout.dot);
  float* s_cap = reinterpret_cast<float*>(shared_raw + layout.cap);
  float* s_price = reinterpret_cast<float*>(shared_raw + layout.price);
  float* s_dd = reinterpret_cast<float*>(shared_raw + layout.d_demand);
  // The state: cell (lr, lc) of the tile at [lr * stride + lc].
  const int stride = kStateInShared ? tc : sh.cols;
  float* logits = kStateInShared ? reinterpret_cast<float*>(shared_raw + layout.logits) : a.logits + cell0;
  float* mu = kStateInShared ? reinterpret_cast<float*>(shared_raw + layout.mu) : a.mu + cell0;
  float* nu = kStateInShared ? reinterpret_cast<float*>(shared_raw + layout.nu) : a.nu + cell0;
  float* share = kStateInShared ? reinterpret_cast<float*>(shared_raw + layout.share) : a.share + cell0;
  float* d_share =
      kStateInShared ? reinterpret_cast<float*>(shared_raw + layout.d_share) : a.d_share + cell0;
  unsigned char* feasible_shared = shared_raw + layout.feasible;
  const unsigned char* feas = kStateInShared ? feasible_shared : a.feasible + cell0;

  for (int i = tid; i < nr * dims; i += kPersistThreads) s_vec[i] = a.vectors[size_t(row0) * dims + i];
  for (int lr = tid; lr < nr; lr += kPersistThreads) s_count[lr] = a.counts[row0 + lr];
  for (int i = tid; i < nc * dims; i += kPersistThreads) {
    const int lc = i / dims;
    const int r = i - lc * dims;
    s_cap[r * tc + lc] = fmaxf(a.capacity[size_t(col0) * dims + i], kCapacityFloor);
  }
  for (int lc = tid; lc < nc; lc += kPersistThreads) s_price[lc] = a.prices[col0 + lc];
  if (kStateInShared) {
    for (int i = tid; i < nr * nc; i += kPersistThreads) {
      const int lr = i / nc;
      const int lc = i - lr * nc;
      const size_t src = cell0 + size_t(lr) * sh.cols + lc;
      const int dst = lr * tc + lc;
      logits[dst] = a.logits[src];
      mu[dst] = a.mu[src];
      nu[dst] = a.nu[src];
      feasible_shared[dst] = a.feasible[src];
    }
  }
  __syncthreads();

  // Softmax (a warp a tile row, lanes over its columns): Adam on the cells
  // (with `adam`), then the row max of the masked logits into ex_top and,
  // with `with_ref`, e = exp(masked - ref) into S and its row sum.
  auto softmax_phase = [&](bool adam, bool with_ref, int step, float* ex_top) {
    const float bias_1 = adam ? a.bias[2 * step] : 1.0f;
    const float bias_2 = adam ? a.bias[2 * step + 1] : 1.0f;
    for (int lr = warp; lr < nr; lr += kPersistWarps) {
      const float dot = adam ? s_dot[lr] : 0.0f;
      const float reference = with_ref ? s_ref[lr] : 0.0f;
      float top = -INFINITY;
      float total = 0.0f;
      for (int lc = lane; lc < nc; lc += 32) {
        const int c = lr * stride + lc;
        const bool f = feas[c] != 0;
        float logit = logits[c];
        if (adam && f) {
          const float grad = share[c] * (d_share[c] - dot);
          const float m = kOneMinusB1 * grad + kB1 * mu[c];
          const float v = kOneMinusB2 * (grad * grad) + kB2 * nu[c];
          mu[c] = m;
          nu[c] = v;
          const float m_hat = div_pos(m, bias_1);
          const float v_hat = div_pos(v, bias_2);
          logit = logit + -kLearningRate * div_pos(m_hat, sqrt_nonneg(v_hat) + kAdamEps);
          logits[c] = logit;
        }
        const float masked = f ? logit : kMasked;
        top = fmaxf(top, masked);
        if (with_ref) {
          const float e = expf(masked - reference);
          share[c] = e;
          total += e;
        }
      }
      top = warp_reduce(top, true);
      total = warp_reduce(total, false);
      if (lane == 0) {
        const size_t slot = size_t(row0 + lr) * row_slots + row_slot;
        ex_top[slot] = top;
        if (with_ref) a.ex_sum[slot] = total;
      }
    }
  };

  // After a barrier: the tile rows' totals of a row exchange, the partials
  // combined in ascending (shard, tile) order, read past the SM's L1.
  auto gather_rows = [&](const float* ex, float* dst, bool is_max) {
    for (int lr = tid; lr < nr; lr += kPersistThreads) {
      const float* part = ex + size_t(row0 + lr) * row_slots;
      float value = __ldcg(part);
#pragma unroll 4
      for (int k = 1; k < row_slots; ++k) {
        const float other = __ldcg(part + k);
        value = is_max ? fmaxf(value, other) : value + other;
      }
      dst[lr] = value;
    }
  };

  // Demand (a thread a tile column, walking its rows in order): S = e /
  // total, x = where(F, c * S, 0) (into the assignment with `write_x`), and
  // the tile's partial D[t, r] = sum_g x * v[g, r]. Where the tile is at
  // most half a block wide, two threads take a column, each half its rows;
  // the second half's sums go through s_dd (unused until the next gather)
  // and add to the first's.
  auto demand_rows = [&](int lc, int begin, int end, bool write_x, float* acc) {
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) acc[r] = 0.0f;
    for (int lr = begin; lr < end; ++lr) {
      const int c = lr * stride + lc;
      const float s = div_pos(share[c], s_total[lr]);
      share[c] = s;
      const float x = feas[c] != 0 ? s_count[lr] * s : 0.0f;
      if (write_x) a.assignment[cell0 + size_t(lr) * sh.cols + lc] = x;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) acc[r] += x * s_vec[lr * dims + r];
      }
    }
  };
  auto write_demand = [&](int lc, const float* acc) {
    // [slot, axis, column]: a warp's writes of an axis are consecutive.
    const size_t types = size_t(sh.mesh_cols) * sh.cols;
    float* out = a.ex_demand + size_t(col_slot) * dims * types + col0 + lc;
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      if (r < dims) out[r * types] = acc[r];
    }
  };
  auto demand_phase = [&](bool write_x) {
    float acc[kMaxDims];
    if (2 * nc <= kPersistThreads) {
      const int split = (nr + 1) / 2;
      const bool second = tid >= nc;
      const int lc = second ? tid - nc : tid;
      if (tid < 2 * nc) {
        demand_rows(lc, second ? split : 0, second ? nr : split, write_x, acc);
        if (second) {
#pragma unroll
          for (int r = 0; r < kMaxDims; ++r) {
            if (r < dims) s_dd[r * tc + lc] = acc[r];
          }
        }
      }
      __syncthreads();
      if (tid < nc) {
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) {
          if (r < dims) acc[r] += s_dd[r * tc + lc];
        }
        write_demand(lc, acc);
      }
    } else {
      for (int lc = tid; lc < nc; lc += kPersistThreads) {
        demand_rows(lc, 0, nr, write_x, acc);
        write_demand(lc, acc);
      }
    }
  };

  // One column's D and, with `gradient`, the smooth max's gradient dD =
  // p * softmax_r(20 * D / max(K, 1e-3)) / max(K, 1e-3): `lanes` (1 or 2)
  // adjacent threads a column, thread `half` holding the axes half + lanes
  // * j. Every lane of the warp calls it (a pair exchanges through
  // shuffles); `live` is false past the tile's columns.
  auto column_demand = [&](int lc, bool live, int lanes, int half, bool gradient, bool write_out) {
    // A slot's axes load together (a warp's loads of an axis are
    // consecutive), the slots summed in order.
    const size_t types = size_t(sh.mesh_cols) * sh.cols;
    const float* part = a.ex_demand + col0 + lc;
    float d[kMaxDims];
    float scaled[kMaxDims];
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j) {
      const int r = half + lanes * j;
      d[j] = live && r < dims ? __ldcg(part + r * types) : 0.0f;
    }
#pragma unroll 4
    for (int k = 1; k < col_slots; ++k) {
      const float* slot = part + size_t(k) * dims * types;
#pragma unroll
      for (int j = 0; j < kMaxDims; ++j) {
        const int r = half + lanes * j;
        if (live && r < dims) d[j] += __ldcg(slot + r * types);
      }
    }
    if (write_out && live) {
#pragma unroll
      for (int j = 0; j < kMaxDims; ++j) {
        const int r = half + lanes * j;
        if (r < dims) a.demand_out[size_t(col0 + lc) * dims + r] = d[j];
      }
    }
    if (!gradient) return;
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j) {
      const int r = half + lanes * j;
      if (live && r < dims) {
        scaled[j] = div_pos(d[j], s_cap[r * tc + lc]) * kSharpness;
        top = fmaxf(top, scaled[j]);
      }
    }
    if (lanes == 2) top = fmaxf(top, __shfl_xor_sync(kFullMask, top, 1));
    float total = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j) {
      const int r = half + lanes * j;
      if (live && r < dims) {
        scaled[j] = expf(scaled[j] - top);
        total += scaled[j];
      }
    }
    if (lanes == 2) {
      // The even axes' sum, then the odd axes', in both lanes.
      const float other = __shfl_xor_sync(kFullMask, total, 1);
      total = half == 0 ? total + other : other + total;
    }
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j) {
      const int r = half + lanes * j;
      if (live && r < dims) {
        s_dd[r * tc + lc] = div_pos(s_price[lc] * div_pos(scaled[j], total), s_cap[r * tc + lc]);
      }
    }
  };

  // After a barrier: each tile column's D summed over the groups axis in
  // ascending (shard, tile) order; with `gradient` the smooth max's dD into
  // s_dd, with `write_out` D into demand_out. A tile at most half a block
  // wide takes two threads a column.
  auto gather_demand = [&](bool gradient, bool write_out) {
    if (2 * nc <= kPersistThreads) {
      column_demand(tid >> 1, (tid >> 1) < nc, 2, tid & 1, gradient, write_out);
    } else {
      for (int lc = tid; lc < nc; lc += kPersistThreads) {
        column_demand(lc, true, 1, 0, gradient, write_out);
      }
    }
  };

  // Row dot (a warp a tile row): dx = sum_r v * dD, dS = where(F, c * dx,
  // 0), and the tile's partial sum_t S * dS.
  auto row_dot_phase = [&]() {
    for (int lr = warp; lr < nr; lr += kPersistWarps) {
      float v[kMaxDims];
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) v[r] = r < dims ? s_vec[lr * dims + r] : 0.0f;
      const float count = s_count[lr];
      float partial = 0.0f;
      for (int lc = lane; lc < nc; lc += 32) {
        float dx = 0.0f;
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) {
          if (r < dims) dx += v[r] * s_dd[r * tc + lc];
        }
        const int c = lr * stride + lc;
        const float ds = feas[c] != 0 ? count * dx : 0.0f;
        d_share[c] = ds;
        partial += share[c] * ds;
      }
      partial = warp_reduce(partial, false);
      if (lane == 0) a.ex_dot[size_t(row0 + lr) * row_slots + row_slot] = partial;
    }
  };

  // The exact first reference: the row max alone. Its partials go to
  // ex_dot, which the first row dot rewrites only two barriers later.
  softmax_phase(false, false, 0, a.ex_dot);
  grid.sync();
  gather_rows(a.ex_dot, s_ref, true);
  __syncthreads();
  softmax_phase(false, true, 0, a.ex_max);
  grid.sync();
  gather_rows(a.ex_sum, s_total, false);
  gather_rows(a.ex_max, s_ref, true);
  __syncthreads();
  // A step: demand | row dot | Adam and softmax, a barrier after each. An
  // exchange is read right after the barrier that follows its writes and
  // rewritten only after two more, so one buffer each is enough.
  for (int step = 0; step < sh.steps; ++step) {
    demand_phase(false);
    grid.sync();
    gather_demand(true, step == sh.steps - 1 && !sh.final_pass && col_slot == 0);
    __syncthreads();
    row_dot_phase();
    grid.sync();
    gather_rows(a.ex_dot, s_dot, false);
    __syncthreads();
    softmax_phase(true, true, step, a.ex_max);
    grid.sync();
    gather_rows(a.ex_sum, s_total, false);
    gather_rows(a.ex_max, s_ref, true);
    __syncthreads();
  }
  if (sh.final_pass) {
    demand_phase(true);
    grid.sync();
    // The blocks of the first mesh row's first row tile cover every column
    // once.
    if (col_slot == 0) gather_demand(false, true);
  }
  if (kStateInShared) {
    __syncthreads();
    for (int i = tid; i < nr * nc; i += kPersistThreads) {
      const int lr = i / nc;
      const int lc = i - lr * nc;
      const size_t dst = cell0 + size_t(lr) * sh.cols + lc;
      const int src = lr * tc + lc;
      a.logits[dst] = logits[src];
      a.mu[dst] = mu[src];
      a.nu[dst] = nu[src];
    }
  }
}

// The configuration the card last accepted, so the attribute is set and
// the occupancy query runs once per configuration and device. persist_lock
// is held from the check to the launch: another thread's smaller
// configuration would otherwise lower the attribute in between.
struct PersistAccepted {
  int device = -1;
  size_t bytes = 0;
  bool in_shared = true;
  int resident = 0;
};
PersistAccepted persist_accepted;
std::mutex persist_lock;

using PersistKernel = void (*)(PersistArgs, PersistShape);

// The blocks of the persistent kernel the card holds at once with `bytes`
// of dynamic shared memory: occupancy per SM times the SMs. The caller
// holds persist_lock.
cudaError_t persist_resident(PersistKernel kernel, size_t bytes, bool in_shared, int* resident) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (persist_accepted.device == device && persist_accepted.bytes == bytes &&
      persist_accepted.in_shared == in_shared) {
    *resident = persist_accepted.resident;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes > 48 * 1024 ? bytes : 48 * 1024));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPersistThreads, bytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  persist_accepted.device = device;
  persist_accepted.bytes = bytes;
  persist_accepted.in_shared = in_shared;
  persist_accepted.resident = per_sm * sms;
  *resident = persist_accepted.resident;
  return cudaSuccess;
}

PersistKernel persist_kernel(bool in_shared) {
  return in_shared ? lp_shard_persistent_kernel<true> : lp_shard_persistent_kernel<false>;
}

int row_threads(int types) {
  const int rounded = ((types + 31) / 32) * 32;
  return rounded < kRowThreads ? rounded : kRowThreads;
}

}  // namespace

// One shard's [G', T'] block, row-major, all float32 but the mask (one
// byte a cell). logits, mu, nu and share are updated in place. bias ([2]:
// 1 - b1**k, 1 - b2**k) null skips Adam; else row_dot [G'] is the last
// step's row dot. ref [G'] null takes only the row max (out_sum unused);
// else share gets e = exp(masked - ref) and out_sum [G'] its row sums.
// out_max [G']. Returns the launch's cudaGetLastError().
extern "C" int ktt_lp_shard_softmax(void* logits, void* mu, void* nu, void* share,
                                    const void* d_share, const void* feasible,
                                    const void* row_dot, const void* ref, const void* bias,
                                    int groups, int types, void* out_max, void* out_sum,
                                    void* stream) {
  if (groups <= 0 || types <= 0 || (bias != nullptr && row_dot == nullptr) ||
      (ref != nullptr && out_sum == nullptr)) {
    return cudaErrorInvalidValue;
  }
  lp_shard_softmax_kernel<<<groups, row_threads(types), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(logits), static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<float*>(share), static_cast<const float*>(d_share),
      static_cast<const unsigned char*>(feasible), static_cast<const float*>(row_dot),
      static_cast<const float*>(ref), static_cast<const float*>(bias), types,
      static_cast<float*>(out_max), static_cast<float*>(out_sum));
  return static_cast<int>(cudaGetLastError());
}

// share [G', T'] (e in, S out), feasible [G', T'], counts [G'] float32,
// vectors [G', R], row_total [G']; out demand [T', R] and, unless null,
// assignment [G', T'] (x). R <= 8.
extern "C" int ktt_lp_shard_demand(void* share, const void* feasible, const void* counts,
                                   const void* vectors, const void* row_total, int groups,
                                   int types, int dims, void* demand, void* assignment,
                                   void* stream) {
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims) return cudaErrorInvalidValue;
  const int blocks = (types + kTypeThreads - 1) / kTypeThreads;
  lp_shard_demand_kernel<<<blocks, kTypeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(share), static_cast<const unsigned char*>(feasible),
      static_cast<const float*>(counts), static_cast<const float*>(vectors),
      static_cast<const float*>(row_total), groups, types, dims, static_cast<float*>(demand),
      static_cast<float*>(assignment));
  return static_cast<int>(cudaGetLastError());
}

// share [G', T'] (S), d_share [G', T'] (out dS), feasible, counts [G'],
// vectors [G', R], capacity [T', R], prices [T'], demand [T', R] (the
// reduced D); out_dot [G']. R <= 8.
extern "C" int ktt_lp_shard_row_dot(const void* share, void* d_share, const void* feasible,
                                    const void* counts, const void* vectors,
                                    const void* capacity, const void* prices,
                                    const void* demand, int groups, int types, int dims,
                                    void* out_dot, void* stream) {
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims) return cudaErrorInvalidValue;
  lp_shard_row_dot_kernel<<<groups, row_threads(types), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(share), static_cast<float*>(d_share),
      static_cast<const unsigned char*>(feasible), static_cast<const float*>(counts),
      static_cast<const float*>(vectors), static_cast<const float*>(capacity),
      static_cast<const float*>(prices), static_cast<const float*>(demand), types, dims,
      static_cast<float*>(out_dot));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block of the persistent kernel: the tables,
// and the state when it lives there.
extern "C" long long ktt_lp_shard_persistent_shared_bytes(int tile_rows, int tile_cols, int dims,
                                                          int state_in_shared) {
  const PersistLayout l = persist_layout(tile_rows, tile_cols, dims);
  return static_cast<long long>(l.table_bytes + (state_in_shared != 0 ? l.state_bytes : 0));
}

// The whole sharded LP in one cooperative launch, for a mesh of
// mesh_rows x mesh_cols shards on the current card. vectors [G, R], counts
// [G] float32, capacity [T, R], prices [T]; feasible [S, rows, cols] bytes
// and logits, mu, nu [S, rows, cols] float32 (updated in place), the shards'
// blocks stacked in the mesh's flat order; share and d_share null (the
// state in shared memory) or [S, rows, cols] scratch each; bias [steps, 2];
// exchange buffers ex_max, ex_sum, ex_dot [G, mesh_cols * col_tiles] and
// ex_demand [mesh_rows * row_tiles, R, T]; out assignment [S, rows, cols]
// (with final_pass, else unused) and demand_out [T, R]: the final pass's D,
// or without it the last step's (the state before its update). The grid is
// S x row_tiles x col_tiles blocks of 256 threads. Returns a CUDA error
// code: cudaErrorCooperativeLaunchTooLarge when the card cannot hold the
// grid at once, the occupancy query's or the launch's.
extern "C" int ktt_lp_shard_persistent(const void* vectors, const void* counts,
                                       const void* capacity, const void* prices,
                                       const void* feasible, void* logits, void* mu, void* nu,
                                       void* share, void* d_share, const void* bias,
                                       void* ex_max, void* ex_sum, void* ex_dot,
                                       void* ex_demand, void* assignment, void* demand_out,
                                       int mesh_rows, int mesh_cols, int rows, int cols,
                                       int dims, int steps, int row_tiles, int col_tiles,
                                       int tile_rows, int tile_cols, int final_pass,
                                       void* stream) {
  const bool in_shared = share == nullptr;
  if (mesh_rows < 1 || mesh_cols < 1 || rows < 1 || cols < 1 || dims < 1 || dims > kMaxDims ||
      steps < 0 || row_tiles < 1 || col_tiles < 1 || tile_rows < 1 || tile_cols < 1 ||
      (row_tiles - 1) * tile_rows >= rows || row_tiles * tile_rows < rows ||
      (col_tiles - 1) * tile_cols >= cols || col_tiles * tile_cols < cols ||
      (final_pass != 0 && assignment == nullptr) || (final_pass == 0 && steps < 1) ||
      (in_shared != (d_share == nullptr))) {
    return cudaErrorInvalidValue;
  }
  PersistArgs args;
  args.vectors = static_cast<const float*>(vectors);
  args.counts = static_cast<const float*>(counts);
  args.capacity = static_cast<const float*>(capacity);
  args.prices = static_cast<const float*>(prices);
  args.feasible = static_cast<const unsigned char*>(feasible);
  args.logits = static_cast<float*>(logits);
  args.mu = static_cast<float*>(mu);
  args.nu = static_cast<float*>(nu);
  args.share = static_cast<float*>(share);
  args.d_share = static_cast<float*>(d_share);
  args.bias = static_cast<const float*>(bias);
  args.ex_max = static_cast<float*>(ex_max);
  args.ex_sum = static_cast<float*>(ex_sum);
  args.ex_dot = static_cast<float*>(ex_dot);
  args.ex_demand = static_cast<float*>(ex_demand);
  args.assignment = static_cast<float*>(assignment);
  args.demand_out = static_cast<float*>(demand_out);
  PersistShape shape;
  shape.mesh_rows = mesh_rows;
  shape.mesh_cols = mesh_cols;
  shape.rows = rows;
  shape.cols = cols;
  shape.dims = dims;
  shape.steps = steps;
  shape.row_tiles = row_tiles;
  shape.col_tiles = col_tiles;
  shape.tile_rows = tile_rows;
  shape.tile_cols = tile_cols;
  shape.final_pass = final_pass;
  const PersistLayout layout = persist_layout(tile_rows, tile_cols, dims);
  const size_t bytes = layout.table_bytes + (in_shared ? layout.state_bytes : 0);
  const long long blocks = static_cast<long long>(mesh_rows) * mesh_cols * row_tiles * col_tiles;
  const PersistKernel kernel = persist_kernel(in_shared);
  int resident = 0;
  std::lock_guard<std::mutex> hold(persist_lock);
  cudaError_t err = persist_resident(kernel, bytes, in_shared, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > resident) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args, &shape};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kPersistThreads),
                                    params, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
