// K8: the incremental encode's masked scatter and fill-0 gather on Hopper
// (sm_90a).
//
// Replaces karpenter_tpu/ops/incremental.py::_scatter_rows and _scatter_vals
// (dst.at[idx].set(rows, mode="drop")) and ::_gather_rows
// (take(src, perm, mode="fill", fill_value=0)). The device-resident cluster
// state (models/cluster_state.py) keeps one slot row per pod group or node;
// a flush writes the changed rows into a new generation of each slot array
// (scatter), and each sweep's sorted group view reads the live rows in
// order (gather). Index vectors are bucket-padded with an out-of-range
// sentinel: the scatter drops those lanes, and the gather reads zeros.
//
//   scatter: out[idx[i], r] = rows[i, r]   where 0 <= idx[i] < dst_rows
//   gather:  out[i, r] = src[perm[i], r]   where 0 <= perm[i] < src_rows,
//            else 0
//
// The scatter writes into `out`, which the wrapper makes as a copy of dst:
// the reference's scatter is functional, and an older generation a
// consumer still holds must stay readable. The kernel computes only the
// scattered rows.
//
// What bounds it on this card: latency. A flush moves a few KB (one sweep's
// changed rows, bucket-padded); a view of 2,048 groups reads 72 KB. Both
// are a microsecond of bandwidth, below one launch.
//
// What the design does about that: one thread per (index, element), the
// element index fastest so a row's elements are neighbouring threads and
// neighbouring addresses; no shared memory, no synchronisation, one launch
// per array. The kernels move bits (templated on 4-byte and 1-byte
// elements: float32, int32, bool), so they match their plain versions bit
// for bit. Duplicate in-range indices are not supported: the state never
// produces them (a set of dirty slots, sorted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(T* __restrict__ out, const int* __restrict__ idx, const T* __restrict__ rows,
               int count, int width, int dst_rows) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= static_cast<long long>(count) * width) return;
  const int i = static_cast<int>(k / width);
  const int r = static_cast<int>(k % width);
  const int slot = idx[i];
  if (slot < 0 || slot >= dst_rows) return;  // the sentinel: dropped
  out[static_cast<long long>(slot) * width + r] = rows[k];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(T* __restrict__ out, const T* __restrict__ src, const int* __restrict__ perm,
              int count, int width, int src_rows) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= static_cast<long long>(count) * width) return;
  const int i = static_cast<int>(k / width);
  const int r = static_cast<int>(k % width);
  const int slot = perm[i];
  out[k] = (slot >= 0 && slot < src_rows) ? src[static_cast<long long>(slot) * width + r]
                                          : T(0);
}

inline int blocks_for(long long elements) {
  return static_cast<int>((elements + kThreads - 1) / kThreads);
}

}  // namespace

// out already holds a copy of dst ([dst_rows, width] elements of elem_bytes
// bytes); rows is [count, width]. Returns the launch error (0 on success).
extern "C" int ktt_scatter_rows(void* out, const void* idx, const void* rows, int count,
                                int width, int dst_rows, int elem_bytes, void* stream) {
  if (count < 0 || width < 1 || dst_rows < 0 || (elem_bytes != 4 && elem_bytes != 1)) {
    return cudaErrorInvalidValue;
  }
  const long long elements = static_cast<long long>(count) * width;
  if (elements == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    scatter_kernel<uint32_t><<<blocks_for(elements), kThreads, 0, s>>>(
        static_cast<uint32_t*>(out), static_cast<const int*>(idx),
        static_cast<const uint32_t*>(rows), count, width, dst_rows);
  } else {
    scatter_kernel<uint8_t><<<blocks_for(elements), kThreads, 0, s>>>(
        static_cast<uint8_t*>(out), static_cast<const int*>(idx),
        static_cast<const uint8_t*>(rows), count, width, dst_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// out is [count, width]; src is [src_rows, width]. Returns the launch error.
extern "C" int ktt_gather_rows(void* out, const void* src, const void* perm, int count,
                               int width, int src_rows, int elem_bytes, void* stream) {
  if (count < 0 || width < 1 || src_rows < 0 || (elem_bytes != 4 && elem_bytes != 1)) {
    return cudaErrorInvalidValue;
  }
  const long long elements = static_cast<long long>(count) * width;
  if (elements == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    gather_kernel<uint32_t><<<blocks_for(elements), kThreads, 0, s>>>(
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(src),
        static_cast<const int*>(perm), count, width, src_rows);
  } else {
    gather_kernel<uint8_t><<<blocks_for(elements), kThreads, 0, s>>>(
        static_cast<uint8_t*>(out), static_cast<const uint8_t*>(src),
        static_cast<const int*>(perm), count, width, src_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
