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
// What bounds it on this card: launch latency. A shard's block is small
// (at the main path's G 16 x T 512 on a 2x4 mesh, 8 x 128 cells) and each
// launch is microseconds of work; a step is three launches a shard plus
// the reductions' small tensor ops, 300 steps one after another. What the
// design does about it: one launch a phase (the most between two
// reductions), every state tensor updated in place, no host sync in the
// loop. Fewer phases or a CUDA graph over the step is later work.
//
// Numerics follow K3: the build passes --fmad=false and never fast math
// (expf, IEEE division and square root), optax's order of operations for
// Adam with the caller's bias corrections (1 - b**k), masks as selects.
// Sums run in a fixed order (a block's threads in a shuffle tree, then the
// warps in order), so a launch gives the same bits every time; the order
// differs from the plain versions', so the kernels agree with them to the
// LP tolerances, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

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
