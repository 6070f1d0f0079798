// K9b: the shard-local plan compaction of the sharded cost solve on Hopper
// (sm_90a).
//
// Replaces karpenter_tpu/ops/pack_kernel.py::_compact_entry_block under
// _compact_rounds_sharded and compact_plan_sharded (:709-777): shard_map
// splits the [MR, G] fill matrix of each candidate plan into one contiguous
// block of G / W groups per device of a W-device mesh, and each device
// compacts its block with the same prefix sum and scatter as the
// single-device compaction, against a block-local entry budget. One launch
// here compacts one shard's block of both modes' fills (block b, mode b):
// it writes [nnz, entry_idx[budget], entry_fill[budget]] a mode, with
// entry_idx the row-major r * (G / W) + g' indices (block-local) of the
// nonzero cells in ascending order and entry_fill their values; nnz counts
// every nonzero cell, also those past the budget, whose entries are dropped
// (the host decoder then falls back to the dense spill).
//
// What bounds it on this card: launch latency. At the main path's G 16 on
// an 8-shard mesh a block is 40 x 2 cells and the output 81 words a mode.
// What the design does about it: one launch a shard for both modes, the
// cells read straight out of the full [MR, G] fill (its column block, no
// copy), each tile of the block's threads placed by a warp ballot and a
// scan over the warps' counts (csrc/compact.cu's scan), so the entries come
// out in ascending order.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
compact_shard_kernel(const int* __restrict__ fill_ffd, const int* __restrict__ fill_cost,
                     int groups, int max_rounds, int first_group, int block_groups,
                     int budget, int* __restrict__ out) {
  __shared__ int s_warp_count[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* fill = blockIdx.x == 0 ? fill_ffd : fill_cost;
  int* o_nnz = out + size_t(blockIdx.x) * (1 + 2 * size_t(budget));
  int* o_idx = o_nnz + 1;
  int* o_fill = o_idx + budget;
  for (int i = tid; i < budget; i += kBlock) {
    o_idx[i] = 0;
    o_fill[i] = 0;
  }
  __syncthreads();  // the zeroed entries before any thread scatters into them

  const int cells = max_rounds * block_groups;
  int running = 0;  // nonzero cells in the tiles before this one
  for (int base = 0; base < cells; base += kBlock) {
    const int i = base + tid;
    int value = 0;
    if (i < cells) {
      const int r = i / block_groups;
      const int g = i - r * block_groups;
      value = fill[size_t(r) * groups + first_group + g];
    }
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

// fill_ffd, fill_cost: the two modes' round_fill [MR, G] int32 (MR = 2G +
// 8); the shard compacts columns [first_group, first_group + block_groups);
// out [2, 1 + 2 * budget] int32. Returns the launch's cudaGetLastError().
extern "C" int ktt_compact_shard(const void* fill_ffd, const void* fill_cost, int groups,
                                 int first_group, int block_groups, int budget, void* out,
                                 void* stream) {
  if (groups <= 0 || block_groups <= 0 || first_group < 0 ||
      first_group + block_groups > groups || budget < 0) {
    return cudaErrorInvalidValue;
  }
  compact_shard_kernel<<<2, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(fill_ffd), static_cast<const int*>(fill_cost), groups,
      2 * groups + 8, first_group, block_groups, budget, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
