// K10: the interruption-forecast price penalty on Hopper (sm_90a).
//
// Replaces karpenter_tpu/market/forecast.py::penalize_prices_jnp, the jax
// mirror of the numpy column that build_fleet publishes for spot fleets:
//
//   out[t] = float32(prices[t] + (prices[t] * risks[t]) * weight)
//
// The reference computes the column on the host in numpy and feeds those bits
// to the device solve and to every host mirror alike; its jax version is a
// tripwire that must give the same bits. So must this kernel: every product
// and the sum are rounded on their own (__fmul_rn, __fadd_rn, which nvcc never
// contracts into a fused multiply-add), in numpy's order.
//
// What bounds it on this card: bytes, and before them latency. At the main
// path's padded T 512 it reads two [T] float32 columns and writes one, 6 KB,
// about 2 ns at 3.35 TB/s; a launch costs microseconds.
//
// What the design does about that: one launch, one thread a type, no shared
// memory and nothing staged: the smallest launch that does the work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
penalize_kernel(const float* __restrict__ prices,
                const float* __restrict__ risks,
                float weight,
                float* __restrict__ out,
                int num_types) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= num_types) return;
  const float price = prices[t];
  const float penalty = __fmul_rn(__fmul_rn(price, risks[t]), weight);
  out[t] = __fadd_rn(price, penalty);
}

}  // namespace

// prices [T] fp32, risks [T] fp32, out [T] fp32, all contiguous on the
// current device. Returns the launch's cudaGetLastError().
extern "C" int ktt_penalize_prices(const void* prices, const void* risks,
                                   float weight, void* out, int num_types,
                                   void* stream) {
  if (num_types <= 0) return cudaErrorInvalidValue;
  const int blocks = (num_types + kBlock - 1) / kBlock;
  penalize_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prices), static_cast<const float*>(risks),
      weight, static_cast<float*>(out), num_types);
  return static_cast<int>(cudaGetLastError());
}
