// K2: the pack round loop on Hopper (sm_90a), both candidate modes in one
// launch.
//
// Replaces karpenter_tpu/ops/pack_kernel.py::pack_kernel (quirk=False) with
// its per-type fill _fill_one_node: a data-dependent lax.while_loop whose
// every round greedily fills one empty node of every instance type (a
// sequential scan over the G pod groups, vmapped over the T types), picks one
// type, replicates its fill as often as the group counts allow, and stops
// when every pod is placed or set aside.
//
// What bounds it on this card: latency, twice over. The work is tiny (at the
// main path's 512 types x 16 groups x 8 axes, one round is about 0.3 M fp32
// operations), but every round depends on the one before, and in eager
// PyTorch each round would be dozens of launches plus one host sync to test
// the loop condition.
//
// What the design does about that: one launch of one block per mode (block 0
// runs mode ffd, block 1 mode cost when both are asked for) runs the whole
// round loop on the device, a persistent loop with no host sync. Each thread
// owns the types t = threadIdx.x + k * blockDim.x and runs the group scan for
// them with its eight remaining-capacity values in registers; the group
// vectors and counts live in shared memory, and so do the [T, G] fills while
// they fit (32 KB at 512 x 16), else a global scratch buffer from the caller.
// A block reduction selects the type, and thread 0 applies the round.
//
// Hazards for rounds that are bit-identical to the reference:
//   * n_fit = floor(min_r(remaining / vec) + 1e-4) in IEEE fp32: the
//     division is correctly rounded (__fdiv_rn; the build never passes
//     --use_fast_math).
//   * remaining - n * vec must not contract to an FMA: __fmul_rn and
//     __fsub_rn, and the build passes --fmad=false besides.
//   * the float-to-int conversion of n_fit saturates (an all-zero vector
//     gives +inf), as XLA's convert does.
//   * cost mode's weighted = fills @ group_weight is a sequential fp32 sum
//     over g in ascending order, as in the plain version.
//   * argmin and argmax ties go to the lowest index, as jnp's do.
//   * every output is int32 in the reference's PackRounds layout, because
//     the compaction and decompact_plan read word offsets.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kModeFfd = 0;
constexpr int kModeCost = 1;
constexpr int kDefaultSharedLimit = 48 * 1024;

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

__host__ __device__ inline size_t shared_bytes(int groups, int types, int dims,
                                               bool fills_in_shared) {
  size_t bytes = sizeof(float) * (size_t(groups) * dims + groups)  // vectors, weights
                 + sizeof(int) * (size_t(groups) + types);          // counts, sums
  if (fills_in_shared) bytes += sizeof(int) * size_t(types) * groups;
  return bytes;
}

// Smaller score wins; equal scores go to the lower index (jnp.argmin).
__device__ inline void keep_better(float& score, int& index, float other_score,
                                   int other_index) {
  if (other_score < score || (other_score == score && other_index < index)) {
    score = other_score;
    index = other_index;
  }
}

// Block-wide argmin of (score, index). Every thread of the block must call
// it; the result is returned to every thread.
__device__ int block_argmin(float score, int index, float* red_score,
                            int* red_index) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    keep_better(score, index, __shfl_down_sync(0xffffffffu, score, offset),
                __shfl_down_sync(0xffffffffu, index, offset));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red_* may still be read from the previous call
  if (lane == 0) {
    red_score[warp] = score;
    red_index[warp] = index;
  }
  __syncthreads();
  score = lane < kWarps ? red_score[lane] : INFINITY;
  index = lane < kWarps ? red_index[lane] : INT_MAX;
  for (int offset = 16; offset > 0; offset >>= 1) {
    keep_better(score, index, __shfl_down_sync(0xffffffffu, score, offset),
                __shfl_down_sync(0xffffffffu, index, offset));
  }
  return __shfl_sync(0xffffffffu, index, 0);  // each warp reduced the same values
}

__global__ void __launch_bounds__(kBlock)
pack_rounds_kernel(const float* __restrict__ vectors,
                   const int* __restrict__ counts_in,
                   const float* __restrict__ capacity,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ prices, int groups, int types,
                   int dims, int first_mode, int* __restrict__ out,
                   int* __restrict__ fill_scratch) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  float* s_vectors = reinterpret_cast<float*>(shared_raw);  // [G, R]
  float* s_weight = s_vectors + groups * dims;               // [G]
  int* s_counts = reinterpret_cast<int*>(s_weight + groups); // [G]
  int* s_sums = s_counts + groups;                           // [T]
  int* fills = fill_scratch == nullptr
                   ? s_sums + types
                   : fill_scratch + size_t(blockIdx.x) * types * groups;  // [T, G]

  __shared__ float red_score[kWarps];
  __shared__ int red_index[kWarps];
  __shared__ int s_largest_valid, s_first_active, s_any_active, s_continue;

  const int tid = threadIdx.x;
  const int mode = first_mode + blockIdx.x;
  const int max_rounds = 2 * groups + 8;
  const Layout layout = make_layout(groups, max_rounds);
  int* o = out + size_t(blockIdx.x) * layout.words;

  for (int i = tid; i < layout.words; i += kBlock) o[i] = 0;
  for (int i = tid; i < groups * dims; i += kBlock) s_vectors[i] = vectors[i];
  for (int g = tid; g < groups; g += kBlock) s_counts[g] = counts_in[g];
  if (tid == 0) {
    // num_types - 1 - argmax(valid[::-1]): the last valid type, or the last
    // type when none is valid.
    int largest = types - 1;
    for (int t = types - 1; t >= 0; --t) {
      if (valid[t]) {
        largest = t;
        break;
      }
    }
    s_largest_valid = largest;
  }
  __syncthreads();
  const int largest_valid = s_largest_valid;
  // Cost-mode group weight: the largest per-axis share of the largest valid
  // type's capacity (with the capacity floored at 1).
  for (int g = tid; g < groups; g += kBlock) {
    float weight = -INFINITY;
    for (int r = 0; r < dims; ++r) {
      const float ref = fmaxf(capacity[largest_valid * dims + r], 1.0f);
      weight = fmaxf(weight, __fdiv_rn(s_vectors[g * dims + r], ref));
    }
    s_weight[g] = weight;
  }

  // Loop state kept by thread 0 alone.
  int iters = 0;
  int num_rounds = 0;
  if (tid == 0) {
    int total = 0, first = -1;
    for (int g = 0; g < groups; ++g) {
      total += s_counts[g];
      if (first < 0 && s_counts[g] > 0) first = g;
    }
    s_first_active = first < 0 ? 0 : first;
    s_any_active = first >= 0;
    s_continue = total > 0 && iters < max_rounds + groups;
  }
  __syncthreads();

  while (s_continue) {
    const int first_active = s_first_active;
    const bool any_active = s_any_active;
    float best_score = INFINITY;
    int best_index = INT_MAX;
    int packs_any = 0;

    for (int t = tid; t < types; t += kBlock) {
      int* row = fills + size_t(t) * groups;
      int sum = 0;
      float weighted = 0.0f;
      if (valid[t] && any_active) {
        float remaining[kMaxDims];
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) {
          remaining[r] = r < dims ? capacity[t * dims + r] : 0.0f;
        }
        // A first active group that cannot place one pod aborts the fill;
        // every earlier group has count 0, so the fill is all zero then.
        bool abort = false;
        for (int g = 0; g < groups; ++g) {
          const int count = s_counts[g];
          int n = 0;
          if (count > 0 && !abort) {
            const float* vec = s_vectors + g * dims;
            float ratio = INFINITY;
#pragma unroll
            for (int r = 0; r < kMaxDims; ++r) {
              if (r < dims && vec[r] > 0.0f) {
                ratio = fminf(ratio, __fdiv_rn(remaining[r], vec[r]));
              }
            }
            const float fit = fmaxf(floorf(__fadd_rn(ratio, 1e-4f)), 0.0f);
            n = min(count, __float2int_rz(fit));  // saturating conversion
            if (g == first_active && n == 0) abort = true;
            const float packed = static_cast<float>(n);
#pragma unroll
            for (int r = 0; r < kMaxDims; ++r) {
              if (r < dims) remaining[r] = __fsub_rn(remaining[r], __fmul_rn(packed, vec[r]));
            }
          }
          row[g] = n;
          sum += n;
          if (mode == kModeCost) {
            weighted = __fadd_rn(weighted, __fmul_rn(static_cast<float>(n), s_weight[g]));
          }
        }
      } else {
        for (int g = 0; g < groups; ++g) row[g] = 0;
      }
      s_sums[t] = sum;
      if (mode == kModeCost) {
        const bool packs = sum > 0 && valid[t];
        const float score =
            packs ? __fdiv_rn(prices[t], fmaxf(weighted, 1e-9f)) : INFINITY;
        packs_any |= packs;
        keep_better(best_score, best_index, score, t);  // t ascends per thread
      }
    }
    __syncthreads();

    int t_sel;
    bool have_pack;
    if (mode == kModeFfd) {
      // The largest valid type's pod count bounds the round; the smallest
      // type achieving it wins.
      const int bound = s_sums[largest_valid];
      have_pack = bound > 0;
      float score = INFINITY;
      int index = INT_MAX;
      for (int t = tid; t < types; t += kBlock) {
        if (bound > 0 && valid[t] && s_sums[t] == bound) {
          score = 0.0f;
          index = t;
          break;
        }
      }
      t_sel = block_argmin(score, index, red_score, red_index);
      if (t_sel == INT_MAX) t_sel = 0;  // jnp.argmax of all-False
    } else {
      have_pack = __syncthreads_or(packs_any) != 0;
      t_sel = block_argmin(best_score, best_index, red_score, red_index);
    }

    if (tid == 0) {
      const int* fill = fills + size_t(t_sel) * groups;
      if (have_pack) {
        int repl = INT_MAX;
        for (int g = 0; g < groups; ++g) {
          if (fill[g] > 0) repl = min(repl, s_counts[g] / fill[g]);
        }
        repl = max(repl, 1);
        // An out-of-range round write is dropped, as the reference's scatter
        // drops it; overflow reports the lost round.
        if (num_rounds < max_rounds) {
          o[layout.round_type + num_rounds] = t_sel;
          for (int g = 0; g < groups; ++g) {
            o[layout.round_fill + num_rounds * groups + g] = fill[g];
          }
          o[layout.round_repl + num_rounds] = repl;
        }
        for (int g = 0; g < groups; ++g) s_counts[g] -= repl * fill[g];
        ++num_rounds;
      } else {
        // Retire the first group with pods left as unschedulable.
        int first = 0;
        for (int g = 0; g < groups; ++g) {
          if (s_counts[g] > 0) {
            first = g;
            break;
          }
        }
        o[layout.unschedulable + first] += s_counts[first];
        s_counts[first] = 0;
      }
      ++iters;
      int total = 0, first = -1;
      for (int g = 0; g < groups; ++g) {
        total += s_counts[g];
        if (first < 0 && s_counts[g] > 0) first = g;
      }
      s_first_active = first < 0 ? 0 : first;
      s_any_active = first >= 0;
      s_continue = total > 0 && iters < max_rounds + groups;
    }
    __syncthreads();
  }

  if (tid == 0) {
    int total = 0;
    for (int g = 0; g < groups; ++g) total += s_counts[g];
    o[layout.num_rounds] = min(num_rounds, max_rounds);
    o[layout.overflow] = (total > 0 || num_rounds > max_rounds) ? 1 : 0;
  }
}

}  // namespace

// Words of one mode's output; the caller allocates num_modes times this.
extern "C" int ktt_pack_rounds_words(int groups) {
  return make_layout(groups, 2 * groups + 8).words;
}

// Dynamic shared memory one block needs, with or without the [T, G] fills.
extern "C" long long ktt_pack_rounds_shared_bytes(int groups, int types, int dims,
                                                  int fills_in_shared) {
  return static_cast<long long>(shared_bytes(groups, types, dims, fills_in_shared != 0));
}

// vectors [G, R] f32, counts [G] i32, capacity [T, R] f32, valid [T] bool
// (one byte each), prices [T] f32, out [num_modes, words] i32; fill_scratch
// is null to keep the fills in shared memory, else [num_modes, T, G] i32.
// Block b runs mode first_mode + b (0 = ffd, 1 = cost). Returns the launch's
// cudaGetLastError().
extern "C" int ktt_pack_rounds(const void* vectors, const void* counts,
                               const void* capacity, const void* valid,
                               const void* prices, int groups, int types,
                               int dims, int first_mode, int num_modes,
                               void* out, void* fill_scratch, void* stream) {
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims ||
      first_mode < kModeFfd || num_modes < 1 ||
      first_mode + num_modes - 1 > kModeCost) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = shared_bytes(groups, types, dims, fill_scratch == nullptr);
  if (bytes > kDefaultSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pack_rounds_kernel<<<num_modes, kBlock, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), static_cast<const int*>(counts),
      static_cast<const float*>(capacity), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(prices), groups, types, dims, first_mode,
      static_cast<int*>(out), static_cast<int*>(fill_scratch));
  return static_cast<int>(cudaGetLastError());
}
