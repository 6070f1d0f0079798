// K3: the LP relaxation on Hopper (sm_90a), every Adam step in one launch.
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
// types x 8 axes one step is about 0.5 M fp32 operations on 170 KB of state,
// nanoseconds of arithmetic at the card's rate, but the 300 steps depend on
// each other, and in eager PyTorch each step was ~50 launches behind
// autograd.
//
// What the design does about that: one block runs the whole loop with no host
// sync. The [G, T] state (logits, Adam's two moments, S, dS, the mask) lives
// in shared memory while it fits (170 KB at 16 x 512), else in a global
// scratch buffer from the caller; the code is the same for both. A step is
// two passes with one __syncthreads after each:
//   * columns: one thread per type t sums D[t, :] over the groups in
//     ascending order, takes w and dD in registers, and writes dS[:, t];
//   * rows: one warp per group g takes the row dot sum_t S * dS, applies the
//     Adam update to its row, and takes the next step's softmax of the row.
//     The same lane owns the same cells in every pass of a row, so the row
//     pass needs no block barrier inside it.
// After the loop a last column pass writes x, nodes = max_r D / K and the
// objective.
//
// Hazards:
//   * masks are selects, never a multiply by 0/1: on infeasible and padded
//     cells p * w / K may be inf or NaN, and the select drops it as the
//     reference's jnp.where does;
//   * Adam follows optax's order of operations, each operation rounded on
//     its own (the build passes --fmad=false and never fast math: expf and
//     logf, IEEE division and square root); the bias corrections
//     1 - b**k come from the caller's [steps, 2] table, the same constants
//     the plain version divides by;
//   * softmax and logsumexp subtract the maximum first, as torch's do.
// Sums are taken in another order than torch's, so the kernel agrees with
// the plain version to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kBlock = 512;
constexpr int kWarps = kBlock / 32;
constexpr int kDefaultSharedLimit = 48 * 1024;
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

// Byte offsets of the state inside the workspace.
struct Layout {
  size_t logits, mu, nu, share, d_share, counts, vectors, feasible, bytes;
};

__host__ __device__ inline Layout make_layout(int groups, int types, int dims) {
  const size_t cells = size_t(groups) * types;
  Layout l;
  l.logits = 0;
  l.mu = l.logits + sizeof(float) * cells;
  l.nu = l.mu + sizeof(float) * cells;
  l.share = l.nu + sizeof(float) * cells;
  l.d_share = l.share + sizeof(float) * cells;
  l.counts = l.d_share + sizeof(float) * cells;
  l.vectors = l.counts + sizeof(float) * groups;
  l.feasible = l.vectors + sizeof(float) * size_t(groups) * dims;
  l.bytes = l.feasible + cells;
  l.bytes = (l.bytes + 15) & ~size_t(15);
  return l;
}

__device__ inline float warp_max(float value) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    value = fmaxf(value, __shfl_xor_sync(0xffffffffu, value, offset));
  }
  return value;
}

// A butterfly: every lane adds the same two operands at every level, so
// every lane ends with the same bits.
__device__ inline float warp_sum(float value) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    value += __shfl_xor_sync(0xffffffffu, value, offset);
  }
  return value;
}

// S[g, :] = softmax_t(where(F, L, -1e9)) for one row, by one warp; lane l
// owns the cells t = l + 32 k.
__device__ inline void row_softmax(const float* logits, const unsigned char* feasible,
                                   float* share, int types, int lane) {
  float top = -INFINITY;
  for (int t = lane; t < types; t += 32) {
    top = fmaxf(top, feasible[t] ? logits[t] : kMasked);
  }
  top = warp_max(top);
  float total = 0.0f;
  for (int t = lane; t < types; t += 32) {
    const float e = expf((feasible[t] ? logits[t] : kMasked) - top);
    share[t] = e;
    total += e;
  }
  total = warp_sum(total);
  for (int t = lane; t < types; t += 32) share[t] = share[t] / total;
}

__global__ void __launch_bounds__(kBlock)
lp_relax_kernel(const float* __restrict__ vectors_in,
                const int* __restrict__ counts_in,
                const float* __restrict__ capacity,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ prices,
                const float* __restrict__ bias,  // [steps, 2]
                int groups, int types, int dims, int steps,
                float* __restrict__ assignment,  // [G, T]
                float* __restrict__ nodes_out,   // [T]
                float* __restrict__ objective,   // [1]
                unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  __shared__ float red[kWarps];
  unsigned char* ws = scratch == nullptr ? shared_raw : scratch;
  const Layout layout = make_layout(groups, types, dims);
  float* logits = reinterpret_cast<float*>(ws + layout.logits);
  float* mu = reinterpret_cast<float*>(ws + layout.mu);
  float* nu = reinterpret_cast<float*>(ws + layout.nu);
  float* share = reinterpret_cast<float*>(ws + layout.share);
  float* d_share = reinterpret_cast<float*>(ws + layout.d_share);
  float* counts = reinterpret_cast<float*>(ws + layout.counts);
  float* vectors = reinterpret_cast<float*>(ws + layout.vectors);
  unsigned char* feasible = ws + layout.feasible;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < groups * dims; i += kBlock) vectors[i] = vectors_in[i];
  for (int g = tid; g < groups; g += kBlock) counts[g] = static_cast<float>(counts_in[g]);
  __syncthreads();

  // Feasibility (one pod of g fits an empty t, t valid), the price-density
  // start -log(p / max(max_r K, 1) + 1e-9) broadcast over the groups, and
  // zero moments.
  for (int t = tid; t < types; t += kBlock) {
    float widest = -INFINITY;
    for (int r = 0; r < dims; ++r) widest = fmaxf(widest, capacity[t * dims + r]);
    const float density = prices[t] / fmaxf(widest, 1.0f);
    const float start = -logf(density + 1e-9f);
    for (int g = 0; g < groups; ++g) {
      bool fits = valid[t] != 0;
      for (int r = 0; r < dims; ++r) {
        fits = fits && vectors[g * dims + r] <= capacity[t * dims + r] + 1e-6f;
      }
      const size_t c = size_t(g) * types + t;
      feasible[c] = fits;
      logits[c] = start;
      mu[c] = 0.0f;
      nu[c] = 0.0f;
    }
  }
  __syncthreads();
  for (int g = warp; g < groups; g += kWarps) {
    const size_t row = size_t(g) * types;
    row_softmax(logits + row, feasible + row, share + row, types, lane);
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    // Columns: D[t, :], w, dD in registers, then dS[:, t].
    for (int t = tid; t < types; t += kBlock) {
      float cap[kMaxDims], demand[kMaxDims];
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        cap[r] = r < dims ? fmaxf(capacity[t * dims + r], kCapacityFloor) : 1.0f;
        demand[r] = 0.0f;
      }
      for (int g = 0; g < groups; ++g) {
        const size_t c = size_t(g) * types + t;
        const float x = feasible[c] ? counts[g] * share[c] : 0.0f;
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) {
          if (r < dims) demand[r] += x * vectors[g * dims + r];
        }
      }
      float top = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) {
          demand[r] = demand[r] / cap[r] * kSharpness;  // reused as s * f
          top = fmaxf(top, demand[r]);
        }
      }
      float total = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) {
          demand[r] = expf(demand[r] - top);  // reused as exp(s * f - max)
          total += demand[r];
        }
      }
      const float price = prices[t];
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) demand[r] = price * (demand[r] / total) / cap[r];  // dD
      }
      for (int g = 0; g < groups; ++g) {
        float dx = 0.0f;
#pragma unroll
        for (int r = 0; r < kMaxDims; ++r) {
          if (r < dims) dx += vectors[g * dims + r] * demand[r];
        }
        const size_t c = size_t(g) * types + t;
        d_share[c] = feasible[c] ? counts[g] * dx : 0.0f;
      }
    }
    __syncthreads();

    // Rows: the softmax's backward, Adam, and the next softmax.
    const float bias_1 = bias[2 * step];
    const float bias_2 = bias[2 * step + 1];
    for (int g = warp; g < groups; g += kWarps) {
      const size_t row = size_t(g) * types;
      float partial = 0.0f;
      for (int t = lane; t < types; t += 32) partial += share[row + t] * d_share[row + t];
      const float row_dot = warp_sum(partial);
      for (int t = lane; t < types; t += 32) {
        const size_t c = row + t;
        const float grad = feasible[c] ? share[c] * (d_share[c] - row_dot) : 0.0f;
        const float m = kOneMinusB1 * grad + kB1 * mu[c];
        const float v = kOneMinusB2 * (grad * grad) + kB2 * nu[c];
        mu[c] = m;
        nu[c] = v;
        const float m_hat = m / bias_1;
        const float v_hat = v / bias_2;
        logits[c] = logits[c] + -kLearningRate * (m_hat / (sqrtf(v_hat) + kAdamEps));
      }
      row_softmax(logits + row, feasible + row, share + row, types, lane);
    }
    __syncthreads();
  }

  // The result, with the hard max over the axes.
  float partial = 0.0f;
  for (int t = tid; t < types; t += kBlock) {
    float demand[kMaxDims];
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) demand[r] = 0.0f;
    for (int g = 0; g < groups; ++g) {
      const size_t c = size_t(g) * types + t;
      const float x = feasible[c] ? counts[g] * share[c] : 0.0f;
      assignment[c] = x;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) demand[r] += x * vectors[g * dims + r];
      }
    }
    float most = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxDims; ++r) {
      if (r < dims) most = fmaxf(most, demand[r] / fmaxf(capacity[t * dims + r], kCapacityFloor));
    }
    nodes_out[t] = most;
    partial += prices[t] * most;
  }
  partial = warp_sum(partial);
  if (lane == 0) red[warp] = partial;
  __syncthreads();
  if (warp == 0) {
    float total = lane < kWarps ? red[lane] : 0.0f;
    total = warp_sum(total);
    if (lane == 0) objective[0] = total;
  }
}

}  // namespace

// Bytes of the [G, T] state; the caller keeps it in shared memory (scratch
// null) or passes a global buffer of this size.
extern "C" long long ktt_lp_relax_workspace_bytes(int groups, int types, int dims) {
  return static_cast<long long>(make_layout(groups, types, dims).bytes);
}

// vectors [G, R] f32, counts [G] i32, capacity [T, R] f32, valid [T] bool
// (one byte each), prices [T] f32, bias [steps, 2] f32; out assignment
// [G, T] f32, nodes [T] f32, objective [1] f32; scratch null or
// ktt_lp_relax_workspace_bytes bytes. All contiguous on the current device.
// Returns the launch's cudaGetLastError().
extern "C" int ktt_lp_relax(const void* vectors, const void* counts,
                            const void* capacity, const void* valid,
                            const void* prices, const void* bias, int groups,
                            int types, int dims, int steps, void* assignment,
                            void* nodes, void* objective, void* scratch,
                            void* stream) {
  if (groups <= 0 || types <= 0 || dims <= 0 || dims > kMaxDims || steps < 0) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = scratch == nullptr ? make_layout(groups, types, dims).bytes : 0;
  if (bytes > kDefaultSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        lp_relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lp_relax_kernel<<<1, kBlock, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), static_cast<const int*>(counts),
      static_cast<const float*>(capacity), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(prices), static_cast<const float*>(bias), groups,
      types, dims, steps, static_cast<float*>(assignment), static_cast<float*>(nodes),
      static_cast<float*>(objective), static_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
