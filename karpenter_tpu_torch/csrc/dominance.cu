// K1: capacity-dominance pricing on Hopper (sm_90a).
//
// Replaces karpenter_tpu/ops/pallas_kernels.py::_dominance_prices_pallas
// (pl.pallas_call over the body _dominance_kernel): for every type t,
//
//   effective[t] = min over t' of prices[t']
//                  where capacity[t', r] >= capacity[t, r] - 1e-6 for every r.
//
// What bounds it on this card: nothing but latency. At the main path's padded
// shape ([512, 8] capacity, [512] prices) the whole problem is 20 KB and about
// 2.4 M compare-and-min operations, tens of nanoseconds at the card's fp32
// rate, so one launch costs more than the work.
//
// What the design does about that: it is one launch with no host work and no
// intermediate in device memory, spread over the card. One warp owns one row
// t (a block holds `rows` of them: ops/cuda_kernels.dominance_launch_plan
// makes about one block an SM, 128 blocks of 4 rows at T 512). Every lane
// keeps the row's eight thresholds cap[t, r] - 1e-6 in registers, strides
// over t' reading capacity as two float4 a row (through L1: the blocks of an
// SM read the same 16 KB), and keeps a running minimum; a butterfly of
// shuffles closes the row. The TPU kernel built the [T', T] mask one resource
// axis at a time in VMEM; here the mask never exists at all.
//
// The result equals the plain version exactly: the kernel only subtracts one
// constant (an IEEE fp32 subtraction, __fsub_rn), compares and takes minimums,
// and a minimum does not depend on the order it is taken in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxRows = 32;  // warps a block

__global__ void __launch_bounds__(kMaxRows * 32)
dominance_kernel(const float* __restrict__ capacity,
                 const float* __restrict__ prices,
                 float* __restrict__ out,
                 int num_types,
                 int dims) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (t >= num_types) return;  // a whole warp: no shuffle below is left short

  // Axes past `dims` compare against -inf, which always holds.
  float threshold[kMaxDims];
#pragma unroll
  for (int r = 0; r < kMaxDims; ++r) {
    threshold[r] = r < dims ? __fsub_rn(__ldg(capacity + size_t(t) * dims + r), 1e-6f)
                            : -INFINITY;
  }
  float best = INFINITY;
  if (dims == kMaxDims && (reinterpret_cast<uintptr_t>(capacity) & 15) == 0) {
    const float4* rows = reinterpret_cast<const float4*>(capacity);
    for (int u = lane; u < num_types; u += 32) {
      const float4 lo = __ldg(rows + 2 * u);
      const float4 hi = __ldg(rows + 2 * u + 1);
      const bool dominates = lo.x >= threshold[0] && lo.y >= threshold[1] &&
                             lo.z >= threshold[2] && lo.w >= threshold[3] &&
                             hi.x >= threshold[4] && hi.y >= threshold[5] &&
                             hi.z >= threshold[6] && hi.w >= threshold[7];
      if (dominates) best = fminf(best, __ldg(prices + u));
    }
  } else {
    for (int u = lane; u < num_types; u += 32) {
      bool dominates = true;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        if (r < dims) dominates &= __ldg(capacity + size_t(u) * dims + r) >= threshold[r];
      }
      if (dominates) best = fminf(best, __ldg(prices + u));
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    best = fminf(best, __shfl_xor_sync(0xffffffffu, best, offset));
  }
  if (lane == 0) out[t] = best;
}

}  // namespace

// capacity [T, dims] fp32, prices [T] fp32, out [T] fp32, all contiguous on
// the current device; `rows` (1 to 32) warps a block, one row t a warp.
// Returns the launch's cudaGetLastError().
extern "C" int ktt_dominance_prices(const void* capacity, const void* prices,
                                    void* out, int num_types, int dims, int rows,
                                    void* stream) {
  if (num_types <= 0 || dims <= 0 || dims > kMaxDims || rows < 1 || rows > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  const int blocks = (num_types + rows - 1) / rows;
  dominance_kernel<<<blocks, rows * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(capacity), static_cast<const float*>(prices),
      static_cast<float*>(out), num_types, dims);
  return static_cast<int>(cudaGetLastError());
}
