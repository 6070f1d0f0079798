// K9b: the shard-local plan compaction of the sharded cost solve on Hopper
// (sm_90a).
//
// Replaces karpenter_tpu/ops/pack_kernel.py::_compact_entry_block under
// _compact_rounds_sharded and compact_plan_sharded (:709-777): shard_map
// splits the [MR, G] fill matrix of each candidate plan into one contiguous
// block of G / W groups per device of a W-device mesh, and each device
// compacts its block with the same prefix sum and scatter as the
// single-device compaction, against a block-local entry budget. A shard's
// segment of a mode is [nnz, entry_idx[budget], entry_fill[budget]], with
// entry_idx the row-major r * (G / W) + g' indices (block-local) of the
// nonzero cells in ascending order and entry_fill their values; nnz counts
// every nonzero cell, also those past the budget, whose entries are dropped
// (the host decoder then falls back to the dense spill).
//
// What bounds it on this card: launch latency. At the main path's G 16 on
// an 8-shard mesh a block is 40 x 2 cells, a segment 97 words, and the
// whole payload 1,764 words (7 KB).
//
// What the design does about it: one launch a card.
//   * Every shard on one card (the one-card mesh): one launch writes the
//     whole flat payload of compact_plan_sharded, the layout word for word
//     (csrc/compact_rounds.cuh's Rounds, its model): the ffd header
//     (round_type, round_repl, num_rounds, unschedulable, overflow), the ffd segments of
//     shards 0..W-1, the same for cost, then feasible_any. No stack, header
//     casts or cat follow it.
//   * Shards on several cards: one launch a card compacts the shards that
//     card holds (a table of their flat indices, by value) into a [w_card,
//     2, 1 + 2 * budget] buffer; the wrapper gathers those to the first card
//     and assembles the payload there.
// The grid is one block a (shard, mode) pair, each independent of the
// others, plus, for the payload, one block a mode for its header (the ffd
// one writes feasible_any too). A pair's block reads its column block
// straight out of the full [MR, G] fill (no copy), places each tile of its
// threads by a warp ballot and a scan over the warps' counts
// (csrc/compact_rounds.cuh's scan), so the entries come out in ascending
// order, and then zeroes only the budget slots past its own nnz: the placed entries and
// the zeroed slots are disjoint, so no barrier stands between them.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxListed = 32;  // shards one per-card launch takes

struct Rounds {
  const int* round_type;     // [MR]
  const int* round_fill;     // [MR, G]
  const int* round_repl;     // [MR]
  const int* num_rounds;     // []
  const int* unschedulable;  // [G]
  const int* overflow;       // []
};

// The shards a per-card launch compacts, by flat index; count 0: every
// shard of the mesh, in order (the payload).
struct ShardList {
  int count;
  int index[kMaxListed];
};

// Where the segment of the launch's k-th shard in mode m starts in `out`:
// m * mode_stride + base + k * shard_stride.
struct Layout {
  long long mode_stride;
  long long base;
  long long shard_stride;
};

__device__ void compact_block(const int* __restrict__ fill, int groups, int max_rounds,
                              int first_group, int block_groups, int budget, int* out,
                              int* s_warp_count) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* o_idx = out + 1;
  int* o_fill = o_idx + budget;
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
  // Slots [0, min(nnz, budget)) hold the entries; the rest read zeros.
  for (int i = min(running, budget) + tid; i < budget; i += kBlock) {
    o_idx[i] = 0;
    o_fill[i] = 0;
  }
  if (tid == 0) *out = running;
}

// One mode's replicated header: round_type, round_repl, num_rounds,
// unschedulable, overflow.
__device__ void write_header(const Rounds& r, int groups, int max_rounds, int* o) {
  int* o_repl = o + max_rounds;
  int* o_num_rounds = o_repl + max_rounds;
  int* o_unschedulable = o_num_rounds + 1;
  int* o_overflow = o_unschedulable + groups;
  for (int i = threadIdx.x; i < max_rounds; i += kBlock) {
    o[i] = r.round_type[i];
    o_repl[i] = r.round_repl[i];
  }
  for (int g = threadIdx.x; g < groups; g += kBlock) o_unschedulable[g] = r.unschedulable[g];
  if (threadIdx.x == 0) {
    *o_num_rounds = *r.num_rounds;
    *o_overflow = *r.overflow;
  }
}

__global__ void __launch_bounds__(kBlock)
compact_sharded_kernel(Rounds ffd, Rounds cost, const unsigned char* __restrict__ feasible_any,
                       int groups, int max_rounds, int shards, int budget, ShardList list,
                       Layout layout, int* __restrict__ out) {
  __shared__ int s_warp_count[kWarps];
  const int listed = list.count > 0 ? list.count : shards;
  const int b = blockIdx.x;
  if (b < 2 * listed) {
    const int k = b >> 1;
    const int mode = b & 1;
    const int shard = list.count > 0 ? list.index[k] : k;
    const int block_groups = groups / shards;
    compact_block(mode == 0 ? ffd.round_fill : cost.round_fill, groups, max_rounds,
                  shard * block_groups, block_groups, budget,
                  out + mode * layout.mode_stride + layout.base + k * layout.shard_stride,
                  s_warp_count);
    return;
  }
  // The payload's header blocks.
  const int mode = b - 2 * listed;
  write_header(mode == 0 ? ffd : cost, groups, max_rounds, out + mode * layout.mode_stride);
  if (mode == 0) {
    int* o_feasible = out + 2 * layout.mode_stride;
    for (int g = threadIdx.x; g < groups; g += kBlock) o_feasible[g] = feasible_any[g] ? 1 : 0;
  }
}

bool shape_ok(int groups, int shards, int budget) {
  return groups > 0 && shards > 0 && groups % shards == 0 && budget >= 0;
}

}  // namespace

// fields: for the ffd then the cost mode, the int32 pointers round_type
// [MR], round_fill [MR, G], round_repl [MR], num_rounds [], unschedulable
// [G], overflow [] (12 pointers); feasible_any [G] bool (one byte each);
// out: the payload, int32, 2 * (2 MR + G + 2 + shards * (1 + 2 * budget)) +
// G words. MR = 2G + 8. One launch. Returns the launch's cudaGetLastError().
extern "C" int ktt_compact_sharded_payload(const void* const* fields, const void* feasible_any,
                                           int groups, int shards, int budget, void* out,
                                           void* stream) {
  if (!shape_ok(groups, shards, budget)) return cudaErrorInvalidValue;
  const int* const* f = reinterpret_cast<const int* const*>(fields);
  const Rounds ffd{f[0], f[1], f[2], f[3], f[4], f[5]};
  const Rounds cost{f[6], f[7], f[8], f[9], f[10], f[11]};
  const int max_rounds = 2 * groups + 8;
  const long long header = 2LL * max_rounds + groups + 2;
  const long long segment = 1 + 2LL * budget;
  const Layout layout{header + shards * segment, header, segment};
  ShardList list{};  // every shard, in order
  compact_sharded_kernel<<<2 * shards + 2, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ffd, cost, static_cast<const unsigned char*>(feasible_any), groups, max_rounds, shards,
      budget, list, layout, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// fill_ffd, fill_cost: the two modes' round_fill [MR, G] int32 (MR = 2G +
// 8); shard_ids: `count` (1 to 32) flat shard indices of a `shards`-shard
// mesh, a host array; out [count, 2, 1 + 2 * budget] int32, the segments of
// shard_ids[k] at [k]. One launch. Returns the launch's cudaGetLastError().
extern "C" int ktt_compact_shards(const void* fill_ffd, const void* fill_cost, int groups,
                                  int shards, int budget, int count, const int* shard_ids,
                                  void* out, void* stream) {
  if (!shape_ok(groups, shards, budget) || count < 1 || count > kMaxListed) {
    return cudaErrorInvalidValue;
  }
  ShardList list{};
  list.count = count;
  for (int k = 0; k < count; ++k) {
    if (shard_ids[k] < 0 || shard_ids[k] >= shards) return cudaErrorInvalidValue;
    list.index[k] = shard_ids[k];
  }
  const Rounds ffd{nullptr, static_cast<const int*>(fill_ffd), nullptr, nullptr, nullptr, nullptr};
  const Rounds cost{nullptr, static_cast<const int*>(fill_cost), nullptr, nullptr, nullptr, nullptr};
  const long long segment = 1 + 2LL * budget;
  const Layout layout{segment, 0, 2 * segment};
  compact_sharded_kernel<<<2 * count, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ffd, cost, nullptr, groups, 2 * groups + 8, shards, budget, list, layout,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
