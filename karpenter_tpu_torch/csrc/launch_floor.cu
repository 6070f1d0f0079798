// The card's launch floor: an empty kernel, launched as every kernel of the
// port is (ctypes, the operands' device made current, its current stream).
//
// Replaces no TPU kernel. It does no work, so its device time and the CUDA
// events around its wrapper are the least any one launch of the port can
// cost on this card: the yardstick for a kernel of a few microseconds, such
// as K10 (csrc/forecast.cu), that has no consumer kernel to fold into.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One block of one thread on `stream`. Returns the launch's
// cudaGetLastError().
extern "C" int ktt_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
