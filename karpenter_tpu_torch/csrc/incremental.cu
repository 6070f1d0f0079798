// K8: the incremental encode's masked scatter and fill-0 gather on Hopper
// (sm_90a), batched: one launch writes a whole flush, one launch a whole
// sorted view.
//
// Replaces karpenter_tpu/ops/incremental.py::_scatter_rows and _scatter_vals
// (dst.at[idx].set(rows, mode="drop")) and ::_gather_rows
// (take(src, perm, mode="fill", fill_value=0)). The device-resident cluster
// state (models/cluster_state.py) keeps one slot row per pod group or node;
// a flush writes the changed rows of up to five slot arrays into a new
// generation of each (scatter), and each sweep's sorted group view reads the
// live rows of two arrays in one order (gather). Index vectors are
// bucket-padded with an out-of-range sentinel: the scatter drops those
// lanes, and the gather reads zeros.
//
//   scatter: out = dst, then out[idx[i], r] = rows[i, r]
//            where 0 <= idx[i] < dst_rows
//   gather:  out[i, r] = src[perm[i], r]   where 0 <= perm[i] < src_rows,
//            else 0
//
// The scatter is functional, as the reference's is: it writes a new
// generation and leaves `dst` untouched, since an older generation a
// consumer still holds must stay readable. So every element of the new
// generation is written, the old rows copied and the delta rows scattered.
//
// What bounds it on this card: launch latency. A flush writes the five slot
// arrays once (about 100 KB at 2,048 group and 512 node slots) and a view
// of 2,048 groups reads 72 KB; both are microseconds of bandwidth, below the
// host's cost of one launch. The per-array design took five scatters
// and five separate copies a flush, and two gathers a view.
//
// What the design does about that:
//   * One launch a flush. The arrays travel by value in the launch's
//     parameters (a table of up to eight), blockIdx.y naming the array and
//     blockIdx.x a tile of its output rows. A block copies its tile's old
//     rows, passes a barrier, then walks the whole padded index vector and
//     writes the delta rows that land in its tile: no other block writes
//     them, so the copy and the scatter need no sorted indices and no grid
//     barrier, and the copy is no longer a launch of its own.
//   * One launch a view: the same table for the sources, one shared
//     permutation, a tile of output elements a block.
//   * The kernels move bits (4-byte and 1-byte elements: float32, int32,
//     bool), so they match their plain versions bit for bit. Duplicate
//     in-range indices are not supported: the state never produces them (a
//     set of dirty slots, sorted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxArrays = 8;        // arrays one launch takes
constexpr int kTileElements = 2048;  // output elements a block owns

struct ScatterArray {
  void* out;           // [dst_rows, width], the new generation
  const void* dst;     // [dst_rows, width], the old generation
  const int* idx;      // [count]
  const void* rows;    // [count, width]
  int dst_rows;
  int width;
  int count;
  int elem_bytes;      // 4 or 1
  int rows_per_tile;
};

struct ScatterTable {
  ScatterArray array[kMaxArrays];
};

struct GatherArray {
  void* out;        // [count, width]
  const void* src;  // [src_rows, width]
  int src_rows;
  int width;
  int elem_bytes;
};

struct GatherTable {
  GatherArray array[kMaxArrays];
};

template <typename T>
__device__ void scatter_tile(const ScatterArray& a, int tile) {
  const int lo = tile * a.rows_per_tile;
  if (lo >= a.dst_rows) return;  // the whole block: this array has fewer tiles
  const int hi = min(a.dst_rows, lo + a.rows_per_tile);
  T* out = static_cast<T*>(a.out);
  const T* dst = static_cast<const T*>(a.dst);
  const T* rows = static_cast<const T*>(a.rows);
  const long long end = static_cast<long long>(hi) * a.width;
  for (long long k = static_cast<long long>(lo) * a.width + threadIdx.x; k < end; k += kThreads) {
    out[k] = dst[k];
  }
  __syncthreads();  // the old rows before the delta rows that replace them
  const long long elements = static_cast<long long>(a.count) * a.width;
  for (long long k = threadIdx.x; k < elements; k += kThreads) {
    const int i = static_cast<int>(k / a.width);
    const int slot = a.idx[i];
    // The sentinel (and any index outside the array) falls outside every tile.
    if (slot >= lo && slot < hi) {
      out[static_cast<long long>(slot) * a.width + (k - static_cast<long long>(i) * a.width)] = rows[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads) scatter_flush_kernel(ScatterTable table) {
  const ScatterArray a = table.array[blockIdx.y];
  if (a.elem_bytes == 4) {
    scatter_tile<uint32_t>(a, blockIdx.x);
  } else {
    scatter_tile<uint8_t>(a, blockIdx.x);
  }
}

template <typename T>
__device__ void gather_tile(const GatherArray& a, const int* __restrict__ perm, int count, int tile) {
  const long long elements = static_cast<long long>(count) * a.width;
  const long long begin = static_cast<long long>(tile) * kTileElements;
  const long long end = min(elements, begin + kTileElements);
  T* out = static_cast<T*>(a.out);
  const T* src = static_cast<const T*>(a.src);
  for (long long k = begin + threadIdx.x; k < end; k += kThreads) {
    const int i = static_cast<int>(k / a.width);
    const int slot = perm[i];
    out[k] = (slot >= 0 && slot < a.src_rows)
                 ? src[static_cast<long long>(slot) * a.width + (k - static_cast<long long>(i) * a.width)]
                 : T(0);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_view_kernel(GatherTable table, const int* __restrict__ perm, int count) {
  const GatherArray a = table.array[blockIdx.y];
  if (a.elem_bytes == 4) {
    gather_tile<uint32_t>(a, perm, count, blockIdx.x);
  } else {
    gather_tile<uint8_t>(a, perm, count, blockIdx.x);
  }
}

inline bool element_size_ok(long long bytes) { return bytes == 4 || bytes == 1; }

}  // namespace

// table: for each of `arrays` arrays eight int64 words, (out, dst, idx,
// rows, dst_rows, width, count, elem_bytes): out and dst [dst_rows, width]
// elements of elem_bytes bytes (out distinct from dst), idx [count] int32,
// rows [count, width]. Every array has at least one element. One launch
// writes every out. Returns the launch error (0 on success).
extern "C" int ktt_scatter_flush(int arrays, const long long* table, void* stream) {
  if (arrays < 1 || arrays > kMaxArrays) return cudaErrorInvalidValue;
  ScatterTable t{};
  int tiles = 0;
  for (int a = 0; a < arrays; ++a) {
    const long long* w = table + 8 * a;
    if (w[4] < 1 || w[5] < 1 || w[6] < 0 || !element_size_ok(w[7]) || w[4] > INT32_MAX ||
        w[5] > INT32_MAX || w[6] > INT32_MAX) {
      return cudaErrorInvalidValue;
    }
    ScatterArray& s = t.array[a];
    s.out = reinterpret_cast<void*>(w[0]);
    s.dst = reinterpret_cast<const void*>(w[1]);
    s.idx = reinterpret_cast<const int*>(w[2]);
    s.rows = reinterpret_cast<const void*>(w[3]);
    s.dst_rows = static_cast<int>(w[4]);
    s.width = static_cast<int>(w[5]);
    s.count = static_cast<int>(w[6]);
    s.elem_bytes = static_cast<int>(w[7]);
    s.rows_per_tile = s.width >= kTileElements ? 1 : kTileElements / s.width;
    const int array_tiles = (s.dst_rows + s.rows_per_tile - 1) / s.rows_per_tile;
    if (array_tiles > tiles) tiles = array_tiles;
  }
  scatter_flush_kernel<<<dim3(tiles, arrays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// table: for each of `arrays` sources five int64 words, (out, src,
// src_rows, width, elem_bytes): out [count, width] and src [src_rows, width]
// elements of elem_bytes bytes; perm [count] int32, shared by every source,
// count >= 1. One launch writes every out. Returns the launch error.
extern "C" int ktt_gather_view(int arrays, const long long* table, const void* perm, int count,
                               void* stream) {
  if (arrays < 1 || arrays > kMaxArrays || count < 1) return cudaErrorInvalidValue;
  GatherTable t{};
  long long tiles = 0;
  for (int a = 0; a < arrays; ++a) {
    const long long* w = table + 5 * a;
    if (w[2] < 0 || w[3] < 1 || !element_size_ok(w[4]) || w[2] > INT32_MAX || w[3] > INT32_MAX) {
      return cudaErrorInvalidValue;
    }
    GatherArray& g = t.array[a];
    g.out = reinterpret_cast<void*>(w[0]);
    g.src = reinterpret_cast<const void*>(w[1]);
    g.src_rows = static_cast<int>(w[2]);
    g.width = static_cast<int>(w[3]);
    g.elem_bytes = static_cast<int>(w[4]);
    const long long elements = static_cast<long long>(count) * g.width;
    const long long array_tiles = (elements + kTileElements - 1) / kTileElements;
    if (array_tiles > tiles) tiles = array_tiles;
  }
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  gather_view_kernel<<<dim3(static_cast<unsigned>(tiles), arrays), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, static_cast<const int*>(perm), count);
  return static_cast<int>(cudaGetLastError());
}
