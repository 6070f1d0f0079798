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
// intermediate in device memory. One thread owns one row t and keeps its eight
// thresholds cap[t, r] - 1e-6 in registers; the block walks t' in tiles staged
// in shared memory (capacity [TILE, 8] plus prices), every thread of the block
// reading the same t' at once (a shared-memory broadcast), and keeps a running
// minimum. The TPU kernel built the [T', T] mask one resource axis at a time in
// VMEM; here the mask never exists at all.
//
// The result equals the plain version exactly: the kernel only subtracts one
// constant (an IEEE fp32 subtraction, __fsub_rn), compares and takes minimums,
// and a minimum does not depend on the order it is taken in.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kBlock = 128;
constexpr int kTile = 128;

__global__ void __launch_bounds__(kBlock)
dominance_kernel(const float* __restrict__ capacity,
                 const float* __restrict__ prices,
                 float* __restrict__ out,
                 int num_types,
                 int dims) {
  __shared__ float tile_cap[kTile * kMaxDims];
  __shared__ float tile_price[kTile];

  const int t = blockIdx.x * kBlock + threadIdx.x;
  const bool live = t < num_types;

  // Axes past `dims` compare 0 >= -inf, which always holds.
  float threshold[kMaxDims];
#pragma unroll
  for (int r = 0; r < kMaxDims; ++r) {
    threshold[r] = (live && r < dims)
                       ? __fsub_rn(capacity[t * dims + r], 1e-6f)
                       : -INFINITY;
  }

  float best = INFINITY;
  for (int base = 0; base < num_types; base += kTile) {
    const int count = min(kTile, num_types - base);
    for (int i = threadIdx.x; i < kTile * kMaxDims; i += kBlock) {
      const int u = i / kMaxDims;
      const int r = i % kMaxDims;
      tile_cap[i] = (u < count && r < dims) ? capacity[(base + u) * dims + r] : 0.0f;
    }
    for (int u = threadIdx.x; u < kTile; u += kBlock) {
      tile_price[u] = u < count ? prices[base + u] : INFINITY;
    }
    __syncthreads();
    for (int u = 0; u < count; ++u) {
      bool dominates = true;
#pragma unroll
      for (int r = 0; r < kMaxDims; ++r) {
        dominates &= tile_cap[u * kMaxDims + r] >= threshold[r];
      }
      if (dominates) best = fminf(best, tile_price[u]);
    }
    __syncthreads();
  }
  if (live) out[t] = best;
}

}  // namespace

// capacity [T, dims] fp32, prices [T] fp32, out [T] fp32, all contiguous on
// the current device. Returns the launch's cudaGetLastError().
extern "C" int ktt_dominance_prices(const void* capacity, const void* prices,
                                    void* out, int num_types, int dims,
                                    void* stream) {
  if (num_types <= 0 || dims <= 0 || dims > kMaxDims) return cudaErrorInvalidValue;
  const int blocks = (num_types + kBlock - 1) / kBlock;
  dominance_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(capacity), static_cast<const float*>(prices),
      static_cast<float*>(out), num_types, dims);
  return static_cast<int>(cudaGetLastError());
}
