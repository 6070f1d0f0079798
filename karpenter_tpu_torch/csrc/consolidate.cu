// K7: consolidation's batched counterfactual solve on Hopper (sm_90a).
//
// Replaces karpenter_tpu/ops/consolidate.py::_counterfactual_body (an XLA
// program: a lax.scan over the pod groups of a [C, N, R] room tensor, the
// replace leg's feasibility over [C, T], the savings and an argmax). For each
// candidate c: start from room = bin_mask[c, n] ? headroom[n] : 0; for each
// group g in order, fit[n] = floor(min over positive axes of room / vec +
// 1e-6) (cnt where that is infinite, never below 0), the first-fit cutoff
// take[n] = clip(cnt - (S[n] - fit[n]), 0, fit[n]) with S the inclusive
// prefix sum of fit over the bins, and room -= take * vec. Then delete_ok,
// the cheapest feasible replacement type, the float32 savings, and over all
// candidates the argmax and the winner's [G, N] plan row.
//
// What bounds it on this card: bytes. The [C, G, N] int32 plan is written
// once (33.6 MB at the real size C 64, G 16, N 8192), against about 60 fp32
// operations per plan cell. Before this design one block a candidate left 68
// of the 132 SMs idle, divided twice per bin and group, and a second launch
// copied the winner's row.
//
// What the design does about it, one launch a sweep:
//   * A thread-block cluster of k blocks a candidate (k the largest of 1, 2,
//     4 and 8 with C * k <= SMs: 2 at C 64; the host's plan). Block r owns
//     the bins [r * S, (r + 1) * S), thread t of it the kBins (4 or 8)
//     contiguous bins from r * S + t * kBins.
//   * The room: only the axes on which some group of the candidate has a
//     positive request (the room on any other axis is never read), in the
//     block's shared memory, one odd-length segment a thread so that the
//     threads of a warp hit distinct banks; the plan puts it in a global
//     scratch buffer only when it does not fit. The caller sizes it for the
//     most axes any candidate requests (max_axes); a candidate that requests
//     more computes nothing, its savings become NaN and best becomes -1.
//   * Per group: each thread computes its bins' fits once, into registers; a
//     warp scan and one block barrier give each warp's offset, and the first
//     warp pushes the block's total (with the previous group's placed count)
//     into every block of the cluster over distributed shared memory; after
//     one cluster barrier every block adds the totals of the ranks below it.
//     The exchange slots are double-buffered by the group's parity. Then the
//     take pass reads the fits back from registers, updates the room and
//     stores the takes as int4. A group with no pods to place (a padded
//     group) places nothing and leaves the room as it is: the cluster
//     stores its zeros and skips it, barriers and all.
//   * The replace leg's argmin over T is split over the cluster's blocks and
//     closed in rank 0, lowest index on ties.
//   * The last cluster to finish (a ticket: fence, then an atomic on a
//     counter the last one resets) takes the argmax over the candidates'
//     savings and copies the winner's [G, N] row into the eager buffer with
//     int4 loads and stores.
//
// Hazards for outputs that are bit-identical to the reference:
//   * The reference's prefix sum is a sequential float32 fold. Fits are
//     whole numbers >= 0: while a row's total stays below 2^24 every partial
//     sum is exact in any order, so the warp, block and cluster offsets are
//     exact. The float32 cluster total reaches 2^24 exactly when the true
//     total does (rounding is monotone and 2^24 is a float), and every block
//     sums the exchanged totals in rank order, so all agree on it. Past it,
//     the cluster folds the row bin by bin as the reference does: every
//     block stores its fits' bits in the plan row, rank 0's first thread
//     folds, every block reads its inclusive sums back. Exact too, not a
//     fallback.
//   * Division correctly rounded (__fdiv_rn; no fast math); room - take*vec
//     is two roundings (__fmul_rn, __fsub_rn; the build passes --fmad=false);
//     floor(x + 1e-6) in float32.
//   * argmin and argmax take the first index; a candidate with no feasible
//     type gets type 0 at price +inf; with every candidate at -inf the
//     argmax is 0. A computed savings is never NaN (fmaxf of a price or
//     -inf), so NaN is free to mark a candidate past max_axes.
//   * delete_ok compares the float32 of the exact integer sum of takes with
//     cnt - 0.5, as the reference's float32 sum, which is exact while a
//     group's count stays below 2^24.
//   * Demand is summed over the groups in ascending order.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mutex>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxThreads = 1024;
constexpr int kWarpsMax = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kSharedLimit = 232448;  // 227 KB, a block's most on sm_90
constexpr int kMaxDevices = 64;
constexpr float kExactSum = 16777216.0f;  // 2^24

// One rank's contribution to a group, pushed into every block of its cluster.
struct Exchange {
  float total;       // the block's sum of this group's fits
  int pad;
  long long placed;  // the block's placed pods of the previous group
};

// The block's control words, at the start of its dynamic shared memory; the
// room follows at kControlBytes.
struct Control {
  float warp_total[2][kWarpsMax];       // by group parity: each warp's fit sum, then its offset
  long long warp_placed[2][kWarpsMax];  // by group parity: each warp's placed pods
  Exchange exchange[2][kMaxCluster];    // by group parity: each rank's, pushed by that rank
  float tail_price[kMaxCluster];        // rank 0: each rank's cheapest feasible type
  int tail_type[kMaxCluster];
  long long tail_placed[kMaxCluster];   // rank 0: each rank's placed pods of the last group
  float red_price[kWarpsMax];           // each warp's cheapest feasible type
  int red_type[kWarpsMax];
  float demand[kMaxDims];
  int axis[kMaxDims];
  int axes;
  int last;     // this cluster took the last ticket
  int best;     // the last cluster's argmax
  int unsized;  // some candidate requested more than max_axes axes
};

constexpr int kControlBytes = (sizeof(Control) + 15) / 16 * 16;

// Floats of one thread's room segment for `axes` tracked axes: odd, so that
// the segments of neighbouring threads start in distinct banks.
__host__ __device__ inline int room_words(int bins_per_thread, int axes) {
  return bins_per_thread * axes | 1;
}

// Smaller score wins; equal scores go to the lower index (jnp.argmin).
__device__ inline void keep_smaller(float& score, int& index, float other_score,
                                    int other_index) {
  if (other_score < score || (other_score == score && other_index < index)) {
    score = other_score;
    index = other_index;
  }
}

// Larger score wins; equal scores go to the lower index (jnp.argmax).
__device__ inline void keep_larger(float& score, int& index, float other_score,
                                   int other_index) {
  if (other_score > score || (other_score == score && other_index < index)) {
    score = other_score;
    index = other_index;
  }
}

__device__ inline long long warp_sum(long long value) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    value += __shfl_xor_sync(0xffffffffu, value, offset);
  }
  return value;
}

__device__ inline void warp_keep_smaller(float& score, int& index) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    keep_smaller(score, index, __shfl_xor_sync(0xffffffffu, score, offset),
                 __shfl_xor_sync(0xffffffffu, index, offset));
  }
}

__device__ inline void warp_keep_larger(float& score, int& index) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    keep_larger(score, index, __shfl_xor_sync(0xffffffffu, score, offset),
                __shfl_xor_sync(0xffffffffu, index, offset));
  }
}

// One bin's fit for the current group: floor(min over positive axes of
// room / max(vec, 1e-9) + 1e-6), cnt where that is infinite, at least 0. A
// bin with room <= 0 on a requested axis fits 0 without a division: that
// axis's ratio is <= 0, so the minimum plus 1e-6 floors to at most 0.
template <int kAxes>
__device__ inline float bin_fit(const float* room, const float* vec, int axes,
                                float cnt) {
  bool full = false;
#pragma unroll
  for (int a = 0; a < kAxes; ++a) {
    if (a < axes) full |= vec[a] > 0.0f && room[a] <= 0.0f;
  }
  if (full) return 0.0f;
  float ratio = INFINITY;
#pragma unroll
  for (int a = 0; a < kAxes; ++a) {
    if (a < axes && vec[a] > 0.0f) {
      ratio = fminf(ratio, __fdiv_rn(room[a], fmaxf(vec[a], 1e-9f)));
    }
  }
  float fit = floorf(__fadd_rn(ratio, 1e-6f));
  if (isinf(fit)) fit = cnt;
  return fmaxf(fit, 0.0f);
}

// dst[i] = src[i] for i < words, by `count` threads of which this is `index`:
// int4 loads from the 16-byte-aligned src, int4 stores from the first
// aligned word of dst (a head of up to 3 words and a tail go one by one).
// src was written by other blocks of this launch: its loads skip L1.
__device__ void copy_row(const int* __restrict__ src, int* __restrict__ dst, long long words,
                         long long index, long long count) {
  const bool vector = (reinterpret_cast<uintptr_t>(src) & 15) == 0 && words % 4 == 0;
  if (!vector) {
    for (long long i = index; i < words; i += count) dst[i] = __ldcg(src + i);
    return;
  }
  const int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) / 4 % 4);
  if (head >= words) {
    for (long long i = index; i < words; i += count) dst[i] = __ldcg(src + i);
    return;
  }
  const long long quads = (words - head) / 4;
  if (index < head) dst[index] = __ldcg(src + index);
  for (long long i = head + 4 * quads + index; i < words; i += count) dst[i] = __ldcg(src + i);
  const int4* from = reinterpret_cast<const int4*>(src);
  int4* to = reinterpret_cast<int4*>(dst + head);
  // dst words head + 4q .. head + 4q + 3 are src words of quads q and q + 1;
  // four of them a thread in flight at once.
  constexpr int kUnroll = 4;
  for (long long base = index; base < quads; base += kUnroll * count) {
    int4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = base + u * count;
      if (q < quads) {
        a[u] = __ldcg(from + q);
        b[u] = head == 0 ? a[u] : __ldcg(from + q + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = base + u * count;
      if (q >= quads) break;
      switch (head) {
        case 0: to[q] = a[u]; break;
        case 1: to[q] = make_int4(a[u].y, a[u].z, a[u].w, b[u].x); break;
        case 2: to[q] = make_int4(a[u].z, a[u].w, b[u].x, b[u].y); break;
        default: to[q] = make_int4(a[u].w, b[u].x, b[u].y, b[u].z); break;
      }
    }
  }
}

// kBins bins a thread; kAxes the launch's max_axes, the bound of every loop
// over a candidate's requested axes.
template <int kBins, int kAxes>
__global__ void __launch_bounds__(kMaxThreads)
counterfactual_kernel(const float* __restrict__ pod_vectors,
                      const int* __restrict__ pod_counts,
                      const float* __restrict__ headroom,
                      const unsigned char* __restrict__ bin_mask,
                      const float* __restrict__ type_capacity,
                      const float* __restrict__ type_prices,
                      const unsigned char* __restrict__ type_valid,
                      const float* __restrict__ node_prices,
                      const unsigned char* __restrict__ cand_valid,
                      int candidates, int groups, int dims, int bins, int types,
                      int max_axes, int slice, int* __restrict__ takes,
                      int* __restrict__ eager, float* __restrict__ savings,
                      float* __restrict__ room_scratch, unsigned* __restrict__ ticket) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Control* ctl = reinterpret_cast<Control*>(shared_raw);
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / k;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  const int first_bin = rank * slice + tid * kBins;
  // The bins this thread owns, and whether it stores them as one int4 a 4
  // (it owns all kBins and the rows are 16-byte aligned: N a multiple of
  // 4). The store guard is taken from the unclamped span, and the empty asm
  // keeps ptxas from fusing it with the clamp below: fused, the guard became
  // the predicate output of the clamp instruction (VIMNMX.RELU), and threads
  // past N stored zeros into the next row.
  int span = min(rank * slice + slice, bins) - first_bin;
  const bool vector_store = span >= kBins && (bins & 3) == 0;
  asm volatile("" : "+r"(span));
  const int owned = max(0, min(kBins, span));

  // The axes on which some group of this candidate asks for a positive
  // amount (a ballot of the first warp over G x R), and the demand of each
  // axis summed over the groups in ascending order.
  if (warp == 0) {
    unsigned mask = 0;
    const float* vectors = pod_vectors + size_t(c) * groups * dims;
    for (int i = lane; i < groups * dims; i += 32) {
      if (vectors[i] > 0.0f) mask |= 1u << (i % dims);
    }
    mask = __reduce_or_sync(0xffffffffu, mask);
    if (lane == 0) {
      int axes = 0;
      for (int a = 0; a < dims; ++a) {
        if ((mask >> a) & 1u) ctl->axis[axes++] = a;
      }
      ctl->axes = axes;
      ctl->last = 0;
      ctl->unsized = 0;
    }
  }
  if (warp == (warps > 1 ? 1 : 0) && lane < dims) {
    float demand = 0.0f;
    for (int g = 0; g < groups; ++g) {
      const size_t row = size_t(c) * groups + g;
      demand = __fadd_rn(demand, __fmul_rn(pod_vectors[row * dims + lane],
                                           static_cast<float>(pod_counts[row])));
    }
    ctl->demand[lane] = demand;
  }
  // Every block of the cluster has started (distributed shared memory is
  // safe from here) and sees its own control words.
  cluster.sync();
  const int axes = ctl->axes;
  const bool sized = axes <= max_axes;

  // Replace leg, this block's share of the types: the warp's cheapest
  // feasible one (the block's and the cluster's are taken at the tail).
  {
    const int share = (types + k - 1) / k;
    const int t_end = min(types, (rank + 1) * share);
    float best_price = INFINITY;
    int best_type = INT_MAX;
    for (int t = rank * share + tid; t < t_end; t += threads) {
      bool fits = type_valid[size_t(c) * types + t] != 0;
      for (int r = 0; r < dims; ++r) {
        fits &= ctl->demand[r] <= __fadd_rn(type_capacity[size_t(t) * dims + r], 1e-6f);
      }
      keep_smaller(best_price, best_type, fits ? type_prices[t] : INFINITY, t);
    }
    warp_keep_smaller(best_price, best_type);
    if (lane == 0) {
      ctl->red_price[warp] = best_price;
      ctl->red_type[warp] = best_type;
    }
  }

  float* room = room_scratch == nullptr
                    ? reinterpret_cast<float*>(shared_raw + kControlBytes)
                    : room_scratch + size_t(blockIdx.x) * threads * room_words(kBins, max_axes);
  room += size_t(tid) * room_words(kBins, axes);  // this thread's segment: [kBins][axes]

  long long placed = 0;  // this thread's placed pods of the last group placed
  float cnt = 0.0f;      // that group's count
  int step = 0;          // the groups placed so far: the exchange's parity
  bool delete_ok = true;  // kept by rank 0's first thread
  if (sized) {
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      if (j < owned) {
        const int n = first_bin + j;
        const bool open = bin_mask[size_t(c) * bins + n] != 0;
#pragma unroll
        for (int a = 0; a < kAxes; ++a) {
          if (a < axes) room[j * axes + a] = open ? headroom[size_t(n) * dims + ctl->axis[a]] : 0.0f;
        }
      }
    }

    for (int g = 0; g < groups; ++g) {
      const size_t row = size_t(c) * groups + g;
      int* take_row = takes + row * bins;
      const int count = pod_counts[row];
      if (count <= 0) {
        // Nothing to place (a padded group): every take is 0 and the room
        // stays as it is, so the cluster skips the group, exchange and all
        // (every block of the cluster reads the same count).
        if (vector_store) {
#pragma unroll
          for (int q = 0; q < kBins / 4; ++q) {
            reinterpret_cast<int4*>(take_row + first_bin)[q] = make_int4(0, 0, 0, 0);
          }
        } else if (owned > 0) {
#pragma unroll
          for (int j = 0; j < kBins; ++j) {
            if (j < owned) take_row[first_bin + j] = 0;
          }
        }
        continue;
      }
      const int parity = step & 1;
      ++step;
      float vec[kAxes > 0 ? kAxes : 1];
#pragma unroll
      for (int a = 0; a < kAxes; ++a) {
        vec[a] = a < axes ? pod_vectors[row * dims + ctl->axis[a]] : 0.0f;
      }
      const float cnt_before = cnt;
      cnt = static_cast<float>(count);

      float fit[kBins];
      float local = 0.0f;
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        fit[j] = j < owned ? bin_fit<kAxes>(room + j * axes, vec, axes, cnt) : 0.0f;
        local = __fadd_rn(local, fit[j]);
      }
      float inclusive = local;
      for (int offset = 1; offset < 32; offset <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, inclusive, offset);
        if (lane >= offset) inclusive = __fadd_rn(inclusive, other);
      }
      const float before_lane = __shfl_up_sync(0xffffffffu, inclusive, 1);
      const long long warp_placed = warp_sum(placed);
      if (lane == 31) ctl->warp_total[parity][warp] = inclusive;
      if (lane == 0) ctl->warp_placed[parity][warp] = warp_placed;
      __syncthreads();
      if (warp == 0) {
        const float mine = lane < warps ? ctl->warp_total[parity][lane] : 0.0f;
        float scan = mine;
        for (int offset = 1; offset < 32; offset <<= 1) {
          const float other = __shfl_up_sync(0xffffffffu, scan, offset);
          if (lane >= offset) scan = __fadd_rn(scan, other);
        }
        const float before = __shfl_up_sync(0xffffffffu, scan, 1);
        if (lane < warps) ctl->warp_total[parity][lane] = lane > 0 ? before : 0.0f;
        const float total = __shfl_sync(0xffffffffu, scan, warps - 1);
        const long long block_placed =
            warp_sum(lane < warps ? ctl->warp_placed[parity][lane] : 0LL);
        if (lane < k) {
          Exchange* slot = cluster.map_shared_rank(&ctl->exchange[parity][rank], lane);
          slot->total = total;
          slot->placed = block_placed;
        }
      }
      cluster.sync();
      float offset = 0.0f;
      float total = 0.0f;
      long long cluster_placed = 0;
      for (int b = 0; b < k; ++b) {
        const float block_total = ctl->exchange[parity][b].total;
        if (b < rank) offset = __fadd_rn(offset, block_total);
        total = __fadd_rn(total, block_total);
        cluster_placed += ctl->exchange[parity][b].placed;
      }
      if (step > 1 && rank == 0 && tid == 0) {
        delete_ok &= __ll2float_rn(cluster_placed) >= __fsub_rn(cnt_before, 0.5f);
      }
      const bool exact = total < kExactSum;
      float running = __fadd_rn(__fadd_rn(offset, ctl->warp_total[parity][warp]),
                                lane > 0 ? before_lane : 0.0f);
      if (!exact) {
        // The sequential float32 fold of the reference, through the plan
        // row: each block stores its fits' bits, rank 0's first thread
        // folds, each block reads its inclusive sums back.
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          if (j < owned) take_row[first_bin + j] = __float_as_int(fit[j]);
        }
        __threadfence();
        cluster.sync();
        if (rank == 0 && tid == 0) {
          float acc = 0.0f;
          for (int n = 0; n < bins; ++n) {
            acc = __fadd_rn(acc, __int_as_float(__ldcg(take_row + n)));
            take_row[n] = __float_as_int(acc);
          }
          __threadfence();
        }
        cluster.sync();
      }
      int out[kBins];
      placed = 0;
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        out[j] = 0;
        if (j < owned) {
          float inclusive_sum;
          if (exact) {
            running = __fadd_rn(running, fit[j]);
            inclusive_sum = running;
          } else {
            inclusive_sum = __int_as_float(__ldcg(take_row + first_bin + j));
          }
          const float before = __fsub_rn(inclusive_sum, fit[j]);
          const float take = fminf(fmaxf(__fsub_rn(cnt, before), 0.0f), fit[j]);
          if (take > 0.0f) {  // room - 0 * vec is the room
            float* bin_room = room + j * axes;
#pragma unroll
            for (int a = 0; a < kAxes; ++a) {
              if (a < axes) bin_room[a] = __fsub_rn(bin_room[a], __fmul_rn(take, vec[a]));
            }
          }
          out[j] = __float2int_rz(take);
          placed += out[j];
        }
      }
      if (vector_store) {
        int4* quads = reinterpret_cast<int4*>(take_row + first_bin);
#pragma unroll
        for (int q = 0; q < kBins / 4; ++q) {
          quads[q] = make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
        }
      } else if (owned > 0) {
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          if (j < owned) take_row[first_bin + j] = out[j];
        }
      }
    }
  }

  // Tail: the last group's placed pods and the block's cheapest type, into
  // rank 0; this thread's plan stores ordered before the cluster's ticket.
  __threadfence();
  const int parity = step & 1;
  {
    const long long warp_placed = warp_sum(placed);
    if (lane == 0) ctl->warp_placed[parity][warp] = warp_placed;
  }
  __syncthreads();
  if (warp == 0) {
    const long long block_placed = warp_sum(lane < warps ? ctl->warp_placed[parity][lane] : 0LL);
    float price = lane < warps ? ctl->red_price[lane] : INFINITY;
    int type = lane < warps ? ctl->red_type[lane] : INT_MAX;
    warp_keep_smaller(price, type);
    if (lane == 0) {
      Control* root = cluster.map_shared_rank(ctl, 0);
      root->tail_placed[rank] = block_placed;
      root->tail_price[rank] = price;
      root->tail_type[rank] = type;
    }
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    long long last_placed = 0;
    float best_price = INFINITY;
    int best_type = INT_MAX;
    for (int b = 0; b < k; ++b) {
      last_placed += ctl->tail_placed[b];
      keep_smaller(best_price, best_type, ctl->tail_price[b], ctl->tail_type[b]);
    }
    delete_ok &= __ll2float_rn(last_placed) >= __fsub_rn(cnt, 0.5f);
    delete_ok &= sized;
    const bool valid = cand_valid[c] != 0;
    const float price = node_prices[c];
    const float savings_delete = (delete_ok && valid) ? price : -INFINITY;
    const float margin = __fsub_rn(price, best_price);
    const float savings_replace =
        (isfinite(best_price) && margin > 1e-6f && valid) ? margin : -INFINITY;
    // A candidate past max_axes computed nothing: NaN flags it.
    savings[c] = sized ? fmaxf(savings_delete, savings_replace) : NAN;
    eager[c] = delete_ok ? 1 : 0;
    eager[candidates + c] = best_type;
    eager[2 * candidates + c] = __float_as_int(best_price);
    __threadfence();
    const bool last = atomicAdd(ticket, 1u) == static_cast<unsigned>(candidates - 1);
    if (last) atomicExch(ticket, 0u);  // ready for the next launch
    for (int b = 0; b < k; ++b) cluster.map_shared_rank(ctl, b)->last = last ? 1 : 0;
  }
  cluster.sync();
  if (!ctl->last) return;

  // The last cluster: every candidate's savings and plan are in memory. The
  // argmax (first index of the maximum; 0 when every candidate is at -inf;
  // -1 when some candidate was flagged), then the winner's row.
  __threadfence();
  float score = -INFINITY;
  int index = INT_MAX;
  bool unsized = false;
  for (int i = tid; i < candidates; i += threads) {
    const float s = __ldcg(savings + i);
    unsized |= isnan(s);
    keep_larger(score, index, s, i);
  }
  warp_keep_larger(score, index);
  if (__any_sync(0xffffffffu, unsized) && lane == 0) ctl->unsized = 1;
  if (lane == 0) {
    ctl->red_price[warp] = score;
    ctl->red_type[warp] = index;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < warps; ++w) keep_larger(score, index, ctl->red_price[w], ctl->red_type[w]);
    ctl->best = index == INT_MAX ? 0 : index;
    if (rank == 0) eager[3 * candidates] = ctl->unsized ? -1 : ctl->best;
  }
  __syncthreads();
  if (ctl->unsized) return;
  const long long plan = static_cast<long long>(groups) * bins;
  copy_row(takes + ctl->best * plan, eager + 3 * candidates + 1, plan,
           static_cast<long long>(rank) * threads + tid, static_cast<long long>(k) * threads);
}

using Kernel = void (*)(const float*, const int*, const float*, const unsigned char*,
                        const float*, const float*, const unsigned char*, const float*,
                        const unsigned char*, int, int, int, int, int, int, int, int*, int*,
                        float*, float*, unsigned*);

// The kernel for kBins bins a thread and a room of max_axes (0 to 8) axes.
template <int kBins>
Kernel kernel_for(int max_axes) {
  switch (max_axes) {
    case 0: return counterfactual_kernel<kBins, 0>;
    case 1: return counterfactual_kernel<kBins, 1>;
    case 2: return counterfactual_kernel<kBins, 2>;
    case 3: return counterfactual_kernel<kBins, 3>;
    case 4: return counterfactual_kernel<kBins, 4>;
    case 5: return counterfactual_kernel<kBins, 5>;
    case 6: return counterfactual_kernel<kBins, 6>;
    case 7: return counterfactual_kernel<kBins, 7>;
    default: return counterfactual_kernel<kBins, 8>;
  }
}

// The shared-memory attribute is set once a process for each device and
// kernel; `attribute_lock` guards the flags.
bool attribute_set[kMaxDevices][2][kMaxDims + 1];
std::mutex attribute_lock;

}  // namespace

// Bytes of the control words at the start of a block's dynamic shared memory.
extern "C" int ktt_consolidate_control_bytes() { return kControlBytes; }

// pod_vectors [C, G, R] f32, pod_counts [C, G] i32, headroom [N, R] f32,
// bin_mask [C, N] bool, type_capacity [T, R] f32, type_prices [T] f32,
// type_valid [C, T] bool, node_prices [C] f32, cand_valid [C] bool (bools
// one byte each). The plan (ops/consolidate_kernel.counterfactual_launch_plan):
// clusters of `cluster` (1, 2, 4 or 8) blocks of `threads` threads (a
// multiple of 32, at most 1,024), block r of a candidate's cluster owning
// the bins [r * slice, (r + 1) * slice), thread t of it `bins_per_thread`
// (4 or 8) from there; `shared_bytes` of dynamic shared memory (the control
// words, and the room when room_scratch is null). takes [C, G, N] i32;
// eager [3C + 1 + G*N] i32 (delete_ok, replace_type, replace_price's bits,
// best, the winner's row); savings [C] f32 scratch; max_axes at least the
// count of axes on which any one candidate's groups request a positive
// amount (else best = -1); room_scratch null, or [C * cluster, threads,
// bins_per_thread * max_axes | 1] f32; ticket one u32 that is 0 and that the
// launch leaves 0. Returns a CUDA error code: the attribute's, the launch's,
// or cudaErrorInvalidValue for arguments outside the kernel.
extern "C" int ktt_consolidate(const void* pod_vectors, const void* pod_counts,
                               const void* headroom, const void* bin_mask,
                               const void* type_capacity, const void* type_prices,
                               const void* type_valid, const void* node_prices,
                               const void* cand_valid, int candidates, int groups,
                               int dims, int bins, int types, int max_axes, int cluster,
                               int threads, int bins_per_thread, int slice,
                               long long shared_bytes, void* takes, void* eager,
                               void* savings, void* room_scratch, void* ticket,
                               void* stream) {
  const long long room_bytes =
      4LL * threads * room_words(bins_per_thread, max_axes);
  if (candidates <= 0 || groups <= 0 || dims <= 0 || dims > kMaxDims || bins <= 0 ||
      types <= 0 || max_axes < 0 || max_axes > dims ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (bins_per_thread != 4 && bins_per_thread != 8) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || slice <= 0 ||
      slice % bins_per_thread != 0 || static_cast<long long>(threads) * bins_per_thread < slice ||
      static_cast<long long>(cluster) * slice < bins || shared_bytes > kSharedLimit ||
      shared_bytes < kControlBytes + (room_scratch == nullptr ? room_bytes : 0) ||
      ticket == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int variant = bins_per_thread == 4 ? 0 : 1;
  Kernel kernel = variant == 0 ? kernel_for<4>(max_axes) : kernel_for<8>(max_axes);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> hold(attribute_lock);
    if (!attribute_set[device][variant][max_axes]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSharedLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      attribute_set[device][variant][max_axes] = true;
    }
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(candidates * cluster, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(pod_vectors),
      static_cast<const int*>(pod_counts), static_cast<const float*>(headroom),
      static_cast<const unsigned char*>(bin_mask), static_cast<const float*>(type_capacity),
      static_cast<const float*>(type_prices), static_cast<const unsigned char*>(type_valid),
      static_cast<const float*>(node_prices), static_cast<const unsigned char*>(cand_valid),
      candidates, groups, dims, bins, types, max_axes, slice, static_cast<int*>(takes),
      static_cast<int*>(eager), static_cast<float*>(savings), static_cast<float*>(room_scratch),
      static_cast<unsigned*>(ticket));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
