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
// operations per plan cell.
//
// What the design does about it, simple first:
//   * Launch 1, one block per candidate. Thread t owns the contiguous bins
//     [t*B, (t+1)*B). A candidate's room is 256 KB at N 8192 x 8 axes, the
//     size of an SM's whole register file, so it cannot live in registers:
//     the block keeps only the axes on which some group of the candidate has
//     a positive request (the room on any other axis is never read), in
//     shared memory, one odd-length segment per thread so that the threads
//     of a warp hit distinct banks. The caller sizes the room for the most
//     axes any candidate requests (max_axes); past the shared limit the same
//     layout lives in a global scratch buffer from the caller. A candidate
//     that requests more axes than max_axes computes nothing: its savings
//     become NaN, and launch 2 then writes best = -1.
//   * Per group: each thread sums its bins' fits, a block-wide scan gives its
//     offset, then it recomputes each fit, takes, updates the room and
//     writes takes[c, g, :].
//   * The replace leg reduces over T in the same block.
//   * Launch 2, one block: the argmax over candidates and the copy of the
//     winner's row into the eager buffer that the host fetches.
//
// Hazards for outputs that are bit-identical to the reference:
//   * The reference's prefix sum is a sequential float32 fold. Fits are
//     whole numbers >= 0: while a row's total stays below 2^24 every partial
//     sum is exact in any order, and the block scan is used. The float32 scan
//     total reaches 2^24 exactly when the true total does (rounding is
//     monotone and 2^24 is a float), and then thread 0 folds the row bin by
//     bin, as the reference does. That path is exact too, not a fallback.
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
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxThreads = 1024;
constexpr int kWarpsMax = kMaxThreads / 32;
constexpr int kArgBlock = 1024;
constexpr int kDefaultSharedLimit = 48 * 1024;
constexpr float kExactSum = 16777216.0f;  // 2^24

__host__ __device__ inline int block_threads(int bins) {
  const int rounded = (bins + 31) / 32 * 32;
  return rounded < kMaxThreads ? rounded : kMaxThreads;
}

__host__ __device__ inline int bins_per_thread(int bins, int threads) {
  return (bins + threads - 1) / threads;
}

// Floats of one thread's room segment for `axes` tracked axes: odd, so that
// the segments of neighbouring threads start in distinct banks.
__host__ __device__ inline long long room_words(int per_thread, int axes) {
  return static_cast<long long>(per_thread) * axes | 1;
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

// Block-wide exclusive scan of one float per thread; every thread gets its
// offset and the block total. Exact when the values are whole numbers whose
// total is below 2^24. Every thread of the block must call it.
__device__ float block_exclusive_scan(float value, float* s_warp, float& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float inclusive = value;
  for (int offset = 1; offset < 32; offset <<= 1) {
    const float other = __shfl_up_sync(0xffffffffu, inclusive, offset);
    if (lane >= offset) inclusive = __fadd_rn(inclusive, other);
  }
  __syncthreads();  // s_warp may still be read from the previous call
  if (lane == 31) s_warp[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    float w = lane < warps ? s_warp[lane] : 0.0f;
    for (int offset = 1; offset < 32; offset <<= 1) {
      const float other = __shfl_up_sync(0xffffffffu, w, offset);
      if (lane >= offset) w = __fadd_rn(w, other);
    }
    if (lane < warps) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[warps - 1];
  const float before_warp = warp > 0 ? s_warp[warp - 1] : 0.0f;
  return __fadd_rn(before_warp, __fsub_rn(inclusive, value));
}

// Block-wide sum of one integer per thread, returned to every thread.
__device__ long long block_sum(long long value, long long* s_warp) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    value += __shfl_down_sync(0xffffffffu, value, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = value;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < warps; ++w) total += s_warp[w];
  return total;
}

// One bin's fit for the current group: floor(min over positive axes of
// room / max(vec, 1e-9) + 1e-6), cnt where that is infinite, at least 0.
__device__ inline float bin_fit(const float* room, const float* vec, int axes,
                                float cnt) {
  float ratio = INFINITY;
#pragma unroll
  for (int a = 0; a < kMaxDims; ++a) {
    if (a < axes && vec[a] > 0.0f) {
      ratio = fminf(ratio, __fdiv_rn(room[a], fmaxf(vec[a], 1e-9f)));
    }
  }
  float fit = floorf(__fadd_rn(ratio, 1e-6f));
  if (isinf(fit)) fit = cnt;
  return fmaxf(fit, 0.0f);
}

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
                      int max_axes, long long shared_bytes, int* __restrict__ takes,
                      int* __restrict__ eager, float* __restrict__ savings,
                      float* __restrict__ room_scratch) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  __shared__ float s_scan[kWarpsMax];
  __shared__ long long s_sum[kWarpsMax];
  __shared__ float s_red_score[kWarpsMax];
  __shared__ int s_red_index[kWarpsMax];
  __shared__ int s_axis[kMaxDims];
  __shared__ int s_axes;
  __shared__ float s_demand[kMaxDims];
  __shared__ int s_delete_ok;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int per_thread = bins_per_thread(bins, threads);
  const int first_bin = tid * per_thread;

  // The axes on which some group of this candidate asks for a positive
  // amount; the room on any other axis is never read.
  if (tid == 0) {
    int axes = 0;
    for (int a = 0; a < dims; ++a) {
      bool active = false;
      for (int g = 0; g < groups; ++g) {
        active |= pod_vectors[(size_t(c) * groups + g) * dims + a] > 0.0f;
      }
      if (active) s_axis[axes++] = a;
    }
    s_axes = axes;
    s_delete_ok = 1;
  }
  __syncthreads();
  const int axes = s_axes;
  if (axes > max_axes) {
    // The caller sized the room for fewer axes than this candidate requests.
    if (tid == 0) savings[c] = NAN;
    return;
  }
  const long long segment = room_words(per_thread, axes);
  float* room = (static_cast<long long>(threads) * segment * 4 <= shared_bytes)
                    ? reinterpret_cast<float*>(shared_raw)
                    : room_scratch + size_t(c) * threads * room_words(per_thread, max_axes);
  room += size_t(tid) * segment;  // this thread's segment: [per_thread][axes]

  for (int k = 0; k < per_thread; ++k) {
    const int n = first_bin + k;
    if (n >= bins) break;
    const bool open = bin_mask[size_t(c) * bins + n] != 0;
    for (int a = 0; a < axes; ++a) {
      room[k * axes + a] = open ? headroom[size_t(n) * dims + s_axis[a]] : 0.0f;
    }
  }

  for (int g = 0; g < groups; ++g) {
    const size_t row = size_t(c) * groups + g;
    float vec[kMaxDims];
#pragma unroll
    for (int a = 0; a < kMaxDims; ++a) {
      vec[a] = a < axes ? pod_vectors[row * dims + s_axis[a]] : 0.0f;
    }
    const float cnt = static_cast<float>(pod_counts[row]);
    int* take_row = takes + row * bins;

    float local = 0.0f;
    for (int k = 0; k < per_thread; ++k) {
      if (first_bin + k >= bins) break;
      local = __fadd_rn(local, bin_fit(room + k * axes, vec, axes, cnt));
    }
    float total;
    float running = block_exclusive_scan(local, s_scan, total);
    const bool exact = total < kExactSum;
    if (!exact) {
      // The sequential float32 fold of the reference, through the plan row:
      // each thread stores its fits' bits, thread 0 folds, each thread reads
      // its inclusive sums back.
      for (int k = 0; k < per_thread; ++k) {
        const int n = first_bin + k;
        if (n >= bins) break;
        take_row[n] = __float_as_int(bin_fit(room + k * axes, vec, axes, cnt));
      }
      __syncthreads();
      if (tid == 0) {
        float acc = 0.0f;
        for (int n = 0; n < bins; ++n) {
          acc = __fadd_rn(acc, __int_as_float(take_row[n]));
          take_row[n] = __float_as_int(acc);
        }
      }
      __syncthreads();
    }
    long long placed = 0;
    for (int k = 0; k < per_thread; ++k) {
      const int n = first_bin + k;
      if (n >= bins) break;
      float* bin_room = room + k * axes;
      const float fit = bin_fit(bin_room, vec, axes, cnt);
      float inclusive;
      if (exact) {
        running = __fadd_rn(running, fit);
        inclusive = running;
      } else {
        inclusive = __int_as_float(take_row[n]);
      }
      const float before = __fsub_rn(inclusive, fit);
      const float take = fminf(fmaxf(__fsub_rn(cnt, before), 0.0f), fit);
#pragma unroll
      for (int a = 0; a < kMaxDims; ++a) {
        if (a < axes) bin_room[a] = __fsub_rn(bin_room[a], __fmul_rn(take, vec[a]));
      }
      const int whole = __float2int_rz(take);
      take_row[n] = whole;
      placed += whole;
    }
    placed = block_sum(placed, s_sum);
    if (tid == 0 && !(__ll2float_rn(placed) >= __fsub_rn(cnt, 0.5f))) {
      s_delete_ok = 0;
    }
  }

  // Replace leg: the candidate's total demand, summed over the groups in
  // ascending order, against each type's capacity.
  if (tid < dims) {
    float demand = 0.0f;
    for (int g = 0; g < groups; ++g) {
      const size_t row = size_t(c) * groups + g;
      demand = __fadd_rn(demand, __fmul_rn(pod_vectors[row * dims + tid],
                                           static_cast<float>(pod_counts[row])));
    }
    s_demand[tid] = demand;
  }
  __syncthreads();
  float best_price = INFINITY;
  int best_type = INT_MAX;
  for (int t = tid; t < types; t += threads) {
    bool fits = type_valid[size_t(c) * types + t] != 0;
    for (int r = 0; r < dims; ++r) {
      fits &= s_demand[r] <= __fadd_rn(type_capacity[size_t(t) * dims + r], 1e-6f);
    }
    keep_smaller(best_price, best_type, fits ? type_prices[t] : INFINITY, t);
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    keep_smaller(best_price, best_type,
                 __shfl_down_sync(0xffffffffu, best_price, offset),
                 __shfl_down_sync(0xffffffffu, best_type, offset));
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    s_red_score[warp] = best_price;
    s_red_index[warp] = best_type;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (threads >> 5); ++w) {
      keep_smaller(best_price, best_type, s_red_score[w], s_red_index[w]);
    }
    const bool delete_ok = s_delete_ok != 0;
    const bool valid = cand_valid[c] != 0;
    const float price = node_prices[c];
    const float savings_delete = (delete_ok && valid) ? price : -INFINITY;
    const float margin = __fsub_rn(price, best_price);
    const float savings_replace =
        (isfinite(best_price) && margin > 1e-6f && valid) ? margin : -INFINITY;
    savings[c] = fmaxf(savings_delete, savings_replace);
    eager[c] = delete_ok ? 1 : 0;
    eager[candidates + c] = best_type;
    eager[2 * candidates + c] = __float_as_int(best_price);
  }
}

// The argmax over candidates (first index of the maximum) and the copy of
// the winner's [G, N] plan row into the eager buffer; best = -1 and no row
// when some candidate requested more axes than the room was sized for.
__global__ void __launch_bounds__(kArgBlock)
winner_kernel(const float* __restrict__ savings, const int* __restrict__ takes,
              int candidates, int groups, int bins, int* __restrict__ eager) {
  __shared__ float s_score[kArgBlock / 32];
  __shared__ int s_index[kArgBlock / 32];
  __shared__ int s_best;
  __shared__ int s_unsized;
  const int tid = threadIdx.x;
  if (tid == 0) s_unsized = 0;
  __syncthreads();
  float score = -INFINITY;
  int index = INT_MAX;
  for (int c = tid; c < candidates; c += kArgBlock) {
    if (isnan(savings[c])) s_unsized = 1;
    keep_larger(score, index, savings[c], c);
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    keep_larger(score, index, __shfl_down_sync(0xffffffffu, score, offset),
                __shfl_down_sync(0xffffffffu, index, offset));
  }
  if ((tid & 31) == 0) {
    s_score[tid >> 5] = score;
    s_index[tid >> 5] = index;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kArgBlock / 32; ++w) keep_larger(score, index, s_score[w], s_index[w]);
    // Every candidate at -inf gives index 0, as jnp.argmax does.
    s_best = index == INT_MAX ? 0 : index;
    eager[3 * candidates] = s_unsized ? -1 : s_best;
  }
  __syncthreads();
  if (s_unsized) return;
  const size_t plan = size_t(groups) * bins;
  const int* row = takes + size_t(s_best) * plan;
  int* out = eager + 3 * candidates + 1;
  for (size_t i = tid; i < plan; i += kArgBlock) out[i] = row[i];
}

}  // namespace

// Threads per block of the candidate kernel for `bins` bins.
extern "C" int ktt_consolidate_threads(int bins) { return block_threads(bins); }

// Floats of one thread's room segment with `axes` axes tracked; the scratch
// buffer holds candidates x threads x this.
extern "C" long long ktt_consolidate_room_words(int bins, int axes) {
  return room_words(bins_per_thread(bins, block_threads(bins)), axes);
}

// pod_vectors [C, G, R] f32, pod_counts [C, G] i32, headroom [N, R] f32,
// bin_mask [C, N] bool, type_capacity [T, R] f32, type_prices [T] f32,
// type_valid [C, T] bool, node_prices [C] f32, cand_valid [C] bool (bools
// one byte each). takes [C, G, N] i32; eager [3C + 1 + G*N] i32 (delete_ok,
// replace_type, replace_price's bits, best, the winner's row); savings [C]
// f32 scratch; max_axes at least the count of axes on which any one
// candidate's groups request a positive amount (else best = -1);
// room_scratch null, or [C, threads, room_words(N, max_axes)] f32 for rooms
// past shared_bytes of dynamic shared memory. Returns the launches'
// cudaGetLastError().
extern "C" int ktt_consolidate(const void* pod_vectors, const void* pod_counts,
                               const void* headroom, const void* bin_mask,
                               const void* type_capacity, const void* type_prices,
                               const void* type_valid, const void* node_prices,
                               const void* cand_valid, int candidates, int groups,
                               int dims, int bins, int types, int max_axes,
                               long long shared_bytes,
                               void* takes, void* eager, void* savings,
                               void* room_scratch, void* stream) {
  if (candidates <= 0 || groups <= 0 || dims <= 0 || dims > kMaxDims || bins <= 0 ||
      types <= 0 || max_axes < 0 || max_axes > dims || shared_bytes < 0) {
    return cudaErrorInvalidValue;
  }
  const int threads = block_threads(bins);
  const long long worst = 4LL * threads * room_words(bins_per_thread(bins, threads), max_axes);
  if (worst > shared_bytes && room_scratch == nullptr) return cudaErrorInvalidValue;
  if (shared_bytes > kDefaultSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        counterfactual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  counterfactual_kernel<<<candidates, threads, shared_bytes, s>>>(
      static_cast<const float*>(pod_vectors), static_cast<const int*>(pod_counts),
      static_cast<const float*>(headroom), static_cast<const unsigned char*>(bin_mask),
      static_cast<const float*>(type_capacity), static_cast<const float*>(type_prices),
      static_cast<const unsigned char*>(type_valid), static_cast<const float*>(node_prices),
      static_cast<const unsigned char*>(cand_valid), candidates, groups, dims, bins, types,
      max_axes, shared_bytes, static_cast<int*>(takes), static_cast<int*>(eager),
      static_cast<float*>(savings), static_cast<float*>(room_scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_kernel<<<1, kArgBlock, 0, s>>>(static_cast<const float*>(savings),
                                        static_cast<const int*>(takes), candidates,
                                        groups, bins, static_cast<int*>(eager));
  return static_cast<int>(cudaGetLastError());
}
