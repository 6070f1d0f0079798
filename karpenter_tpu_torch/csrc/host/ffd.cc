// Grouped First-Fit-Decreasing bin-packer — native host kernel.
//
// Ref: pkg/controllers/provisioning/binpacking/packer.go:82-189 and
// packable.go:113-175 (the reference's Go hot loop). This is the C++
// equivalent of karpenter_tpu/ops/ffd.py (same dense-array formulation, same
// round semantics), used as the fast in-process fallback when no accelerator
// is attached and as the host baseline in benchmarks.
//
// Inputs are the densified solver tensors (see ops/encode.py):
//   vectors  [G x D] float32  pod-group request vectors, sorted desc
//   counts   [G]     int64    pods per group
//   capacity [T x D] float32  usable per-type capacity (minus overhead+daemons),
//                             sorted asc (smallest type first)
//   total    [T x D] float32  raw per-type capacity (early-exit ledger)
//
// Output is a round list: round r packs `fill[r]` pods-per-group onto
// `repl[r]` identical nodes of type `type[r]`; pods with no feasible node are
// returned in `unschedulable`.
//
// Build: make -C native   (produces build/libktpu_ffd.so, loaded via ctypes)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_set>
#include <vector>

namespace {

constexpr double kEps = 1e-9;

struct Problem {
  const float* vectors;
  const int64_t* counts;  // live ledger (mutated by caller loop)
  int num_groups;
  int dims;
  const float* capacity;
  const float* total;
  int num_types;
  bool quirk;
};

// Greedily fill one node of type `t`. Returns pods packed per group in
// `fill`; mirrors ffd.fill_node (packable.go Pack:113-132 + fits():147-157).
int64_t FillNode(const Problem& p, int t, const int64_t* counts,
                 int64_t* fill) {
  const float* cap_row = p.capacity + static_cast<size_t>(t) * p.dims;
  const float* total_row = p.total + static_cast<size_t>(t) * p.dims;
  std::memset(fill, 0, sizeof(int64_t) * p.num_groups);

  int last_active = -1;
  for (int g = p.num_groups - 1; g >= 0; --g) {
    if (counts[g] > 0) { last_active = g; break; }
  }
  if (last_active < 0) return 0;
  const float* smallest = p.vectors + static_cast<size_t>(last_active) * p.dims;

  std::vector<double> remaining(p.dims);
  for (int d = 0; d < p.dims; ++d) remaining[d] = cap_row[d];

  int64_t packed_total = 0;
  bool packed_any = false;
  for (int g = 0; g < p.num_groups; ++g) {
    if (counts[g] <= 0) continue;
    const float* need = p.vectors + static_cast<size_t>(g) * p.dims;
    int64_t n_fit = counts[g];
    bool any_positive = false;
    for (int d = 0; d < p.dims; ++d) {
      if (need[d] > 0.0f) {
        any_positive = true;
        double q = std::floor(remaining[d] / need[d] + kEps);
        int64_t qi = q <= 0.0 ? 0 : static_cast<int64_t>(q);
        if (qi < n_fit) n_fit = qi;
      }
    }
    (void)any_positive;  // zero-vector groups fit entirely, as in Python
    int64_t n = n_fit < counts[g] ? n_fit : counts[g];
    if (n > 0) {
      fill[g] = n;
      packed_total += n;
      packed_any = true;
      for (int d = 0; d < p.dims; ++d) remaining[d] -= double(need[d]) * n;
    }
    if (n < counts[g]) {
      if (!packed_any) {
        // Largest pod failed to reserve: this packable packs nothing
        // (packer.go:120-124 set-aside semantics handled by the caller).
        std::memset(fill, 0, sizeof(int64_t) * p.num_groups);
        return 0;
      }
      if (p.quirk) {
        // Early exit when essentially full w.r.t. the smallest pod
        // (packable.go fits():147-157, including its exact-fit quirk).
        for (int d = 0; d < p.dims; ++d) {
          if (total_row[d] > 0.0f && remaining[d] <= smallest[d] + kEps) {
            return packed_total;
          }
        }
      }
    }
  }
  return packed_total;
}

}  // namespace

extern "C" {

// Returns the number of rounds written, or -1 if max_rounds was exceeded.
// round_fill is [max_rounds x num_groups] row-major; round_type / round_repl
// are [max_rounds]; unschedulable is [num_groups].
int ktpu_ffd_pack(const float* vectors, const int64_t* counts_in,
                  int num_groups, int dims, const float* capacity,
                  const float* total, int num_types, int quirk,
                  int* round_type, int64_t* round_fill, int64_t* round_repl,
                  int64_t* unschedulable, int max_rounds) {
  std::vector<int64_t> counts(counts_in, counts_in + num_groups);
  std::memset(unschedulable, 0, sizeof(int64_t) * num_groups);
  Problem p{vectors, counts.data(), num_groups, dims,
            capacity, total,        num_types,  quirk != 0};

  if (num_types == 0) {
    for (int g = 0; g < num_groups; ++g) unschedulable[g] = counts[g];
    return 0;
  }

  std::vector<int64_t> upper(num_groups), fill(num_groups);
  int64_t remaining_pods = 0;
  for (int g = 0; g < num_groups; ++g) remaining_pods += counts[g];

  int rounds = 0;
  while (remaining_pods > 0) {
    // Upper bound: what the largest packable can hold (packer.go:169).
    int64_t max_packed =
        FillNode(p, num_types - 1, counts.data(), upper.data());
    if (max_packed == 0) {
      // Largest remaining pod fits nowhere: set one aside.
      for (int g = 0; g < num_groups; ++g) {
        if (counts[g] > 0) {
          ++unschedulable[g];
          --counts[g];
          --remaining_pods;
          break;
        }
      }
      continue;
    }
    // Smallest type achieving the bound wins (packer.go:163-189).
    int chosen = num_types - 1;
    const int64_t* chosen_fill = upper.data();
    for (int t = 0; t < num_types - 1; ++t) {
      if (FillNode(p, t, counts.data(), fill.data()) == max_packed) {
        chosen = t;
        chosen_fill = fill.data();
        break;
      }
    }
    // One node per round, exactly like the sequential reference loop. (A
    // replica-compression fast path is NOT safe here: shrinking counts can
    // flip the largest-type upper-bound pattern mid-stream, so compressed
    // rounds could diverge from sequential FFD.)
    if (rounds >= max_rounds) return -1;
    round_type[rounds] = chosen;
    round_repl[rounds] = 1;
    int64_t* out = round_fill + static_cast<size_t>(rounds) * num_groups;
    for (int g = 0; g < num_groups; ++g) {
      out[g] = chosen_fill[g];
      counts[g] -= chosen_fill[g];
      remaining_pods -= chosen_fill[g];
    }
    ++rounds;
  }
  return rounds;
}

// Realize an integerized LP assignment (karpenter_tpu/models/solver.py
// _realize_lp_dense): for each type t, greedily fill nodes (pure greedy, no
// quirk) with that type's assigned pods, replication-compressed — repl =
// min over filled groups of counts/fill, so 50k identical pods collapse to
// one round instead of thousands. Replication is exact here because each
// type's realization is independent (no cross-type largest-bound pattern to
// preserve, unlike ktpu_ffd_pack above).
//
// assignment is [T x num_groups] row-major (pods of group g assigned to
// type t). Returns rounds written, -1 if max_rounds exceeded, -2 if some
// assigned pod doesn't fit its type (infeasible assignment — caller bails).
int ktpu_lp_realize(const float* vectors, int num_groups, int dims,
                    const int64_t* assignment, const float* capacity,
                    const float* total, int num_types, int* round_type,
                    int64_t* round_fill, int64_t* round_repl,
                    int max_rounds) {
  Problem p{vectors,  nullptr, num_groups, dims,
            capacity, total,   num_types,  false};
  std::vector<int64_t> counts(num_groups), fill(num_groups);
  int rounds = 0;
  for (int t = 0; t < num_types; ++t) {
    const int64_t* column = assignment + static_cast<size_t>(t) * num_groups;
    int64_t remaining = 0;
    for (int g = 0; g < num_groups; ++g) {
      counts[g] = column[g];
      remaining += column[g];
    }
    while (remaining > 0) {
      if (FillNode(p, t, counts.data(), fill.data()) == 0) return -2;
      int64_t repl = -1;
      for (int g = 0; g < num_groups; ++g) {
        if (fill[g] > 0) {
          int64_t k = counts[g] / fill[g];
          if (repl < 0 || k < repl) repl = k;
        }
      }
      if (repl < 1) repl = 1;
      if (rounds >= max_rounds) return -1;
      round_type[rounds] = t;
      round_repl[rounds] = repl;
      int64_t* out = round_fill + static_cast<size_t>(rounds) * num_groups;
      for (int g = 0; g < num_groups; ++g) {
        out[g] = fill[g];
        counts[g] -= repl * fill[g];
        remaining -= repl * fill[g];
      }
      ++rounds;
    }
  }
  return rounds;
}

// Pair-seeded maximal-fill enumeration for the column-LP mix candidate
// (karpenter_tpu/ops/mix_pack.py): for each (candidate type, seed group a,
// ka fraction, seed group b), place ka pods of a, max-fill with b, then top
// off first-fit over all groups — the complementary-pair structure a greedy
// packer cannot see. Fills are deduped in-line (64-bit multiplicative hash;
// the ka sweep collapses ~10-15x). Returns fills written, or -1 on
// max_out overflow.
//
// capacity here is [num_cand x dims], pre-gathered to the pruned candidate
// types by the caller; mixers is [num_groups] of odd 64-bit hash
// multipliers (shared with the Python fallback so dedup matches).
int ktpu_mix_enumerate(const float* vectors, const int64_t* counts,
                       int num_groups, int dims, const float* capacity,
                       int num_cand, const int* seed_groups, int num_seeds,
                       const float* fracs, int num_fracs,
                       const uint64_t* mixers, int64_t* out_fills,
                       int* out_type, int max_out) {
  std::unordered_set<uint64_t> seen;
  seen.reserve(static_cast<size_t>(num_cand) * num_seeds * 2);
  std::vector<double> remaining(dims);
  std::vector<int64_t> fill(num_groups);
  int written = 0;

  auto max_fit = [&](const float* need, int64_t limit) -> int64_t {
    int64_t n = limit;
    for (int d = 0; d < dims; ++d) {
      if (need[d] > 0.0f) {
        double q = std::floor(remaining[d] / need[d] + 1e-4);
        int64_t qi = q <= 0.0 ? 0 : static_cast<int64_t>(q);
        if (qi < n) n = qi;
      }
    }
    return n < 0 ? 0 : n;
  };

  for (int ci = 0; ci < num_cand; ++ci) {
    const float* cap_row = capacity + static_cast<size_t>(ci) * dims;
    for (int si = 0; si < num_seeds; ++si) {
      int a = seed_groups[si];
      const float* va = vectors + static_cast<size_t>(a) * dims;
      for (int d = 0; d < dims; ++d) remaining[d] = cap_row[d];
      int64_t ka_cap = max_fit(va, counts[a]);
      for (int fi = 0; fi < num_fracs; ++fi) {
        int64_t ka =
            static_cast<int64_t>(std::floor(fracs[fi] * double(ka_cap) + 1e-9));
        for (int sj = 0; sj < num_seeds; ++sj) {
          int b = seed_groups[sj];
          std::memset(fill.data(), 0, sizeof(int64_t) * num_groups);
          for (int d = 0; d < dims; ++d)
            remaining[d] = cap_row[d] - double(va[d]) * ka;
          fill[a] = ka;
          if (b != a) {
            const float* vb = vectors + static_cast<size_t>(b) * dims;
            int64_t kb = max_fit(vb, counts[b]);
            if (kb > 0) {
              fill[b] = kb;
              for (int d = 0; d < dims; ++d) remaining[d] -= double(vb[d]) * kb;
            }
          }
          // First-fit top-off in (descending-size) group order.
          int64_t packed = 0;
          for (int g = 0; g < num_groups; ++g) {
            if (counts[g] <= fill[g]) { packed += fill[g]; continue; }
            const float* vg = vectors + static_cast<size_t>(g) * dims;
            int64_t n = max_fit(vg, counts[g] - fill[g]);
            if (n > 0) {
              fill[g] += n;
              for (int d = 0; d < dims; ++d) remaining[d] -= double(vg[d]) * n;
            }
            packed += fill[g];
          }
          if (packed == 0) continue;
          uint64_t key = 0;
          for (int g = 0; g < num_groups; ++g)
            key += static_cast<uint64_t>(fill[g]) * mixers[g];
          if (!seen.insert(key).second) continue;
          if (written >= max_out) return -1;
          std::memcpy(out_fills + static_cast<size_t>(written) * num_groups,
                      fill.data(), sizeof(int64_t) * num_groups);
          out_type[written] = ci;
          ++written;
        }
      }
    }
  }
  return written;
}

// Exact demand-dominance column pricing for the mix candidate: for each
// column (its demand pre-computed by the caller), the cheapest pool of any
// type whose usable capacity covers the demand. `order` lists type indices
// ascending by pool price, so the scan breaks at the first feasible type —
// average work is a few dozen type checks per column, not num_types.
void ktpu_mix_price(const double* demand /* [J x dims] */, int num_cols,
                    int dims, const float* capacity /* [T x dims] */,
                    const double* pool_floor /* [T] */,
                    const int* order /* [T] price-ascending */, int num_types,
                    double* out_prices /* [J] */) {
  for (int j = 0; j < num_cols; ++j) {
    const double* d = demand + static_cast<size_t>(j) * dims;
    double price = std::numeric_limits<double>::infinity();
    for (int oi = 0; oi < num_types; ++oi) {
      int t = order[oi];
      if (!std::isfinite(pool_floor[t])) break;  // rest of order is unpriced
      const float* cap = capacity + static_cast<size_t>(t) * dims;
      bool ok = true;
      for (int r = 0; r < dims; ++r) {
        if (double(cap[r]) < d[r] - 1e-6) { ok = false; break; }
      }
      if (ok) { price = pool_floor[t]; break; }
    }
    out_prices[j] = price;
  }
}

// Batched launch-pool selection (models/solver._cheapest_feasible_pools
// semantics, bit-for-bit): for each fill's demand, walk the global
// price-sorted pool-row order, keep rows of the first `max_types` distinct
// feasible types, and stop at the first row hitting the row budget, the
// price band past the row floor, or the price ceiling. The per-fill Python
// form costs ~0.2ms in numpy-call overhead; the finish phase calls it for
// ~100 distinct fills per solve, so this batch form keeps candidate
// scoring off the solve's critical path.
//
// out_rows is [F x max_rows] indices into the order arrays; out_counts[f]
// is the selected count, or -1 when NO pool row is feasible (caller falls
// back to the anchor type's options).
void ktpu_pool_select(const double* demand /* [F x dims] */, int num_fills,
                      int dims, const float* capacity /* [T x dims] */,
                      const int* row_types /* [N] */,
                      const double* row_prices /* [N] */, int num_rows,
                      int max_rows, int min_rows, double band,
                      double ceiling_ratio, int max_types,
                      int* out_rows, int* out_counts) {
  std::vector<int8_t> type_state;  // 0 unknown, 1 feasible, 2 infeasible
  int num_types = 0;
  for (int i = 0; i < num_rows; ++i) {
    if (row_types[i] >= num_types) num_types = row_types[i] + 1;
  }
  std::vector<int8_t> admitted(num_types);

  for (int f = 0; f < num_fills; ++f) {
    const double* d = demand + static_cast<size_t>(f) * dims;
    type_state.assign(num_types, 0);
    std::memset(admitted.data(), 0, num_types);
    int distinct = 0;
    int count = 0;
    double cheapest = -1.0;
    int* out = out_rows + static_cast<size_t>(f) * max_rows;
    out_counts[f] = -1;
    for (int i = 0; i < num_rows; ++i) {
      int t = row_types[i];
      int8_t state = type_state[t];
      if (state == 0) {
        const float* cap = capacity + static_cast<size_t>(t) * dims;
        state = 1;
        for (int r = 0; r < dims; ++r) {
          if (double(cap[r]) < d[r] - 1e-6) { state = 2; break; }
        }
        type_state[t] = state;
      }
      if (state == 2) continue;
      double price = row_prices[i];
      if (cheapest < 0.0) cheapest = price;  // first feasible row
      // Stop conditions on the count of rows appended so far (count_excl).
      if (count >= max_rows) break;
      if (price > cheapest * (1.0 + band) && count >= min_rows) break;
      if (price > cheapest * ceiling_ratio && count >= 1) break;
      if (!admitted[t]) {
        if (distinct >= max_types) continue;  // skipped, not counted
        admitted[t] = 1;
        ++distinct;
      }
      out[count++] = i;
      out_counts[f] = count;
    }
    if (cheapest < 0.0) out_counts[f] = -1;  // nothing feasible at all
    else if (out_counts[f] < 0) out_counts[f] = 0;
  }
}

}  // extern "C"
