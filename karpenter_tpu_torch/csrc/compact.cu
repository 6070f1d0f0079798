// K4: the plan compaction of the fused cost solve on Hopper (sm_90a).
//
// Replaces karpenter_tpu/ops/pack_kernel.py::compact_plan with its
// _compact_rounds (an XLA program: per mode a sum, a cumsum, a where, two
// scatters that drop indices past the entry budget, the int32 casts, and a
// concatenate). One launch writes the whole int32 payload that the host
// fetches: for each of the two modes the segments [round_type, round_repl,
// num_rounds, unschedulable, overflow, nnz, entry_idx, entry_fill], then
// feasible_any. entry_idx lists the row-major r*G+g indices of the nonzero
// round_fill cells in ascending order and entry_fill their values; nnz counts
// every nonzero cell, also those past the budget, whose entries are dropped.
//
// What bounds it on this card: launch latency. At the main path's G = 16 the
// input is 2 x 40 x 16 fill cells and the payload under 3 KB.
//
// What the design does about it: one launch of two blocks, one per mode, in
// place of some thirty PyTorch launches and a cat. A block walks the MR x G
// cells in tiles of its threads; per tile a warp ballot and a scan over the
// warps' counts give each nonzero cell its position, so the entries come out
// in ascending order. Large group counts (up to 2056 x 1024 cells) loop over
// more tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

struct Rounds {
  const int* round_type;     // [MR]
  const int* round_fill;     // [MR, G]
  const int* round_repl;     // [MR]
  const int* num_rounds;     // []
  const int* unschedulable;  // [G]
  const int* overflow;       // []
};

__host__ __device__ inline int entry_budget(int max_rounds) { return 4 * max_rounds; }

__host__ __device__ inline int mode_words(int groups, int max_rounds) {
  return 2 * max_rounds + 1 + groups + 1 + 1 + 2 * entry_budget(max_rounds);
}

__global__ void __launch_bounds__(kBlock)
compact_kernel(Rounds ffd, Rounds cost, const unsigned char* __restrict__ feasible_any,
               int groups, int max_rounds, int* __restrict__ out) {
  __shared__ int s_warp_count[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Rounds r = blockIdx.x == 0 ? ffd : cost;
  const int budget = entry_budget(max_rounds);
  int* o = out + size_t(blockIdx.x) * mode_words(groups, max_rounds);
  int* o_repl = o + max_rounds;
  int* o_num_rounds = o_repl + max_rounds;
  int* o_unschedulable = o_num_rounds + 1;
  int* o_overflow = o_unschedulable + groups;
  int* o_nnz = o_overflow + 1;
  int* o_idx = o_nnz + 1;
  int* o_fill = o_idx + budget;

  for (int i = tid; i < max_rounds; i += kBlock) {
    o[i] = r.round_type[i];
    o_repl[i] = r.round_repl[i];
  }
  for (int g = tid; g < groups; g += kBlock) o_unschedulable[g] = r.unschedulable[g];
  if (tid == 0) {
    *o_num_rounds = *r.num_rounds;
    *o_overflow = *r.overflow;
  }
  for (int i = tid; i < budget; i += kBlock) {
    o_idx[i] = 0;
    o_fill[i] = 0;
  }
  if (blockIdx.x == 0) {
    int* o_feasible = out + 2 * size_t(mode_words(groups, max_rounds));
    for (int g = tid; g < groups; g += kBlock) o_feasible[g] = feasible_any[g] ? 1 : 0;
  }
  __syncthreads();  // the zeroed entries before any thread scatters into them

  const int cells = max_rounds * groups;
  int running = 0;  // nonzero cells in the tiles before this one
  for (int base = 0; base < cells; base += kBlock) {
    const int i = base + tid;
    const int value = i < cells ? r.round_fill[i] : 0;
    const unsigned nonzero = __ballot_sync(0xffffffffu, value != 0);
    if (lane == 0) s_warp_count[warp] = __popc(nonzero);
    __syncthreads();
    int position = running + __popc(nonzero & ((1u << lane) - 1u));
    int tile = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) position += s_warp_count[w];
      tile += s_warp_count[w];
    }
    if (value != 0 && position < budget) {
      o_idx[position] = i;
      o_fill[position] = value;
    }
    running += tile;
    __syncthreads();  // s_warp_count is rewritten by the next tile
  }
  if (tid == 0) *o_nnz = running;
}

}  // namespace

// int32 words of the payload: two modes' segments, then feasible_any [G].
extern "C" int ktt_compact_words(int groups) {
  const int max_rounds = 2 * groups + 8;
  return 2 * mode_words(groups, max_rounds) + groups;
}

// fields: for the ffd then the cost mode, the int32 pointers round_type
// [MR], round_fill [MR, G], round_repl [MR], num_rounds [], unschedulable [G],
// overflow [] (12 pointers); feasible_any [G] bool (one byte each); out
// [ktt_compact_words(G)] int32. MR = 2G + 8. Returns the launch's
// cudaGetLastError().
extern "C" int ktt_compact_plan(const void* const* fields, const void* feasible_any,
                                int groups, void* out, void* stream) {
  if (groups <= 0) return cudaErrorInvalidValue;
  const int* const* f = reinterpret_cast<const int* const*>(fields);
  const Rounds ffd{f[0], f[1], f[2], f[3], f[4], f[5]};
  const Rounds cost{f[6], f[7], f[8], f[9], f[10], f[11]};
  compact_kernel<<<2, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ffd, cost, static_cast<const unsigned char*>(feasible_any), groups, 2 * groups + 8,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
