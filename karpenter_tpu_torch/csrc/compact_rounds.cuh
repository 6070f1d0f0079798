// K4: the plan compaction of the fused cost solve, as a block body that the
// pack round loop (csrc/pack_rounds.cu) runs in its epilogue.
//
// Replaces karpenter_tpu/ops/pack_kernel.py::compact_plan with its
// _compact_rounds (an XLA program: per mode a sum, a cumsum, a where, two
// scatters that drop indices past the entry budget, the int32 casts, and a
// concatenate). The payload the host fetches holds, for each of the two modes,
// the segments [round_type, round_repl, num_rounds, unschedulable, overflow,
// nnz, entry_idx, entry_fill], then feasible_any. entry_idx lists the
// row-major r*G+g indices of the nonzero round_fill cells in ascending order
// and entry_fill their values; nnz counts every nonzero cell, also those past
// the budget, whose entries are dropped.
//
// What bounds it on this card: launch latency. At the main path's G = 16 the
// input is 2 x 40 x 16 fill cells and the payload under 3 KB, so as a launch
// of its own it cost a launch and a host enqueue for microseconds of work.
//
// What the design does about it: it runs where its data already is. Each
// block of the pack round loop compacts the mode whose rounds it has just
// written, after a block barrier, so no launch of its own is left. A block
// walks the fill cells in tiles of its threads (32 to 1,024 of them); per
// tile a warp ballot and a scan over the warps' counts give each nonzero cell
// its position, so the entries come out in ascending order.

#pragma once

#include <cuda_runtime.h>

namespace compaction {

__host__ __device__ inline int entry_budget(int max_rounds) { return 4 * max_rounds; }

// int32 words of one mode's segment of the payload.
__host__ __device__ inline int mode_words(int groups, int max_rounds) {
  return 2 * max_rounds + 1 + groups + 1 + 1 + 2 * entry_budget(max_rounds);
}

// One mode's PackRounds, int32 in the reference's layout.
struct Rounds {
  const int* round_type;     // [MR]
  const int* round_fill;     // [MR, G]
  const int* round_repl;     // [MR]
  const int* num_rounds;     // []
  const int* unschedulable;  // [G]
  const int* overflow;       // []
};

// Writes one mode's segment at `out`. Every thread of the block calls it;
// blockDim.x is a multiple of 32. `rows` is the number of leading rows of
// round_fill that may hold a nonzero cell (the rows past it are zero and are
// not read). `warp_counts` holds one int a warp of the block, in shared or
// global memory that no other thread of the block reads meanwhile.
__device__ inline void compact_rounds(const Rounds& r, int groups, int max_rounds, int rows,
                                      int* __restrict__ out, int* warp_counts) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int budget = entry_budget(max_rounds);
  int* o_repl = out + max_rounds;
  int* o_num_rounds = o_repl + max_rounds;
  int* o_unschedulable = o_num_rounds + 1;
  int* o_overflow = o_unschedulable + groups;
  int* o_nnz = o_overflow + 1;
  int* o_idx = o_nnz + 1;
  int* o_fill = o_idx + budget;

  for (int i = tid; i < max_rounds; i += threads) {
    out[i] = r.round_type[i];
    o_repl[i] = r.round_repl[i];
  }
  for (int g = tid; g < groups; g += threads) o_unschedulable[g] = r.unschedulable[g];
  if (tid == 0) {
    *o_num_rounds = *r.num_rounds;
    *o_overflow = *r.overflow;
  }
  for (int i = tid; i < budget; i += threads) {
    o_idx[i] = 0;
    o_fill[i] = 0;
  }
  __syncthreads();  // the zeroed entries before any thread scatters into them

  const int cells = rows * groups;
  int running = 0;  // nonzero cells in the tiles before this one
  for (int base = 0; base < cells; base += threads) {
    const int i = base + tid;
    const int value = i < cells ? r.round_fill[i] : 0;
    const unsigned nonzero = __ballot_sync(0xffffffffu, value != 0);
    if (lane == 0) warp_counts[warp] = __popc(nonzero);
    __syncthreads();
    int position = running + __popc(nonzero & ((1u << lane) - 1u));
    int tile = 0;
    for (int w = 0; w < warps; ++w) {
      const int count = warp_counts[w];
      if (w < warp) position += count;
      tile += count;
    }
    if (value != 0 && position < budget) {
      o_idx[position] = i;
      o_fill[position] = value;
    }
    running += tile;
    __syncthreads();  // warp_counts is rewritten by the next tile
  }
  if (tid == 0) *o_nnz = running;
}

}  // namespace compaction
