"""ctypes binding for the native host kernels (csrc/host/ffd.cc).

The reference's hot loop is compiled Go (binpacking/packer.go); ours is
C++ behind this binding, playing the same role: the fast host-side packer
used for small solves, the per-fill pool selection and the LP realization
of the cost solve's scoring pass.

The shared library is built at first use with g++ into the package's
git-ignored build directory, named by a hash of its source and flags so an
edited source never loads a stale binary. If no toolchain is available the
binding reports unavailable and callers fall back to the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_SOURCE = _PACKAGE_DIR / "csrc" / "host" / "ffd.cc"
_BUILD_DIR = _PACKAGE_DIR / "build"
# No -march=native: the build directory may travel with a copy of the tree
# to another host, and ISO C++ mode keeps fp contraction off either way, so
# the results equal the reference library's bit for bit.
_CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_CXXFLAGS).encode())
    return _BUILD_DIR / f"libktpu_ffd-{digest.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    if lib_path.exists():
        return True
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name, then rename: a concurrent process (another
    # test worker) never loads a half-written library.
    partial = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        result = subprocess.run(
            ["g++", *_CXXFLAGS, "-o", str(partial), str(_SOURCE)],
            capture_output=True,
            timeout=120,
        )
        if result.returncode != 0 or not partial.exists():
            return False
        os.replace(partial, lib_path)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        partial.unlink(missing_ok=True)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        lib_path = _library_path()
        if not _build(lib_path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            _load_failed = True
            return None
        lib.ktpu_ffd_pack.restype = ctypes.c_int
        lib.ktpu_ffd_pack.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # vectors
            ctypes.POINTER(ctypes.c_int64),  # counts
            ctypes.c_int,  # num_groups
            ctypes.c_int,  # dims
            ctypes.POINTER(ctypes.c_float),  # capacity
            ctypes.POINTER(ctypes.c_float),  # total
            ctypes.c_int,  # num_types
            ctypes.c_int,  # quirk
            ctypes.POINTER(ctypes.c_int),  # round_type
            ctypes.POINTER(ctypes.c_int64),  # round_fill
            ctypes.POINTER(ctypes.c_int64),  # round_repl
            ctypes.POINTER(ctypes.c_int64),  # unschedulable
            ctypes.c_int,  # max_rounds
        ]
        lib.ktpu_lp_realize.restype = ctypes.c_int
        lib.ktpu_lp_realize.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # vectors
            ctypes.c_int,  # num_groups
            ctypes.c_int,  # dims
            ctypes.POINTER(ctypes.c_int64),  # assignment [T x G]
            ctypes.POINTER(ctypes.c_float),  # capacity
            ctypes.POINTER(ctypes.c_float),  # total
            ctypes.c_int,  # num_types
            ctypes.POINTER(ctypes.c_int),  # round_type
            ctypes.POINTER(ctypes.c_int64),  # round_fill
            ctypes.POINTER(ctypes.c_int64),  # round_repl
            ctypes.c_int,  # max_rounds
        ]
        lib.ktpu_mix_enumerate.restype = ctypes.c_int
        lib.ktpu_mix_enumerate.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # vectors
            ctypes.POINTER(ctypes.c_int64),  # counts
            ctypes.c_int,  # num_groups
            ctypes.c_int,  # dims
            ctypes.POINTER(ctypes.c_float),  # capacity (pre-gathered cands)
            ctypes.c_int,  # num_cand
            ctypes.POINTER(ctypes.c_int),  # seed_groups
            ctypes.c_int,  # num_seeds
            ctypes.POINTER(ctypes.c_float),  # fracs
            ctypes.c_int,  # num_fracs
            ctypes.POINTER(ctypes.c_uint64),  # hash mixers
            ctypes.POINTER(ctypes.c_int64),  # out fills
            ctypes.POINTER(ctypes.c_int),  # out type (candidate index)
            ctypes.c_int,  # max_out
        ]
        lib.ktpu_pool_select.restype = None
        lib.ktpu_pool_select.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # demand [F x D]
            ctypes.c_int,  # num_fills
            ctypes.c_int,  # dims
            ctypes.POINTER(ctypes.c_float),  # capacity
            ctypes.POINTER(ctypes.c_int),  # row_types
            ctypes.POINTER(ctypes.c_double),  # row_prices
            ctypes.c_int,  # num_rows
            ctypes.c_int,  # max_rows
            ctypes.c_int,  # min_rows
            ctypes.c_double,  # band
            ctypes.c_double,  # ceiling_ratio
            ctypes.c_int,  # max_types
            ctypes.POINTER(ctypes.c_int),  # out_rows [F x max_rows]
            ctypes.POINTER(ctypes.c_int),  # out_counts [F]
        ]
        lib.ktpu_mix_price.restype = None
        lib.ktpu_mix_price.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # demand [J x D]
            ctypes.c_int,  # num_cols
            ctypes.c_int,  # dims
            ctypes.POINTER(ctypes.c_float),  # capacity
            ctypes.POINTER(ctypes.c_double),  # pool_floor
            ctypes.POINTER(ctypes.c_int),  # order (price-ascending)
            ctypes.c_int,  # num_types
            ctypes.POINTER(ctypes.c_double),  # out prices
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def ffd_pack_rounds(
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
    quirk: bool = True,
) -> Optional[Tuple[List[Tuple[int, np.ndarray, int]], np.ndarray]]:
    """Run the native FFD. Returns (rounds, unschedulable_counts) with rounds
    as (type index, fill per group, replication) — the same decode format the
    TPU kernel emits — or None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    capacity = np.ascontiguousarray(capacity, dtype=np.float32)
    total = np.ascontiguousarray(total, dtype=np.float32)
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    max_rounds = int(counts.sum()) + 1
    round_type = np.zeros(max_rounds, dtype=np.int32)
    round_fill = np.zeros((max_rounds, max(num_groups, 1)), dtype=np.int64)
    round_repl = np.zeros(max_rounds, dtype=np.int64)
    unschedulable = np.zeros(max(num_groups, 1), dtype=np.int64)

    def ptr(array, ctype):
        return array.ctypes.data_as(ctypes.POINTER(ctype))

    rounds = lib.ktpu_ffd_pack(
        ptr(vectors, ctypes.c_float),
        ptr(counts, ctypes.c_int64),
        num_groups,
        dims,
        ptr(capacity, ctypes.c_float),
        ptr(total, ctypes.c_float),
        num_types,
        1 if quirk else 0,
        ptr(round_type, ctypes.c_int),
        ptr(round_fill, ctypes.c_int64),
        ptr(round_repl, ctypes.c_int64),
        ptr(unschedulable, ctypes.c_int64),
        max_rounds,
    )
    if rounds < 0:
        return None
    round_list = [
        (int(round_type[r]), round_fill[r, :num_groups], int(round_repl[r]))
        for r in range(rounds)
    ]
    return round_list, unschedulable[:num_groups]


# lp_realize sentinel: the native code determined the assignment cannot be
# realized (an assigned pod fits nowhere on its type) — distinct from None
# (library unavailable / buffer overflow), where a pure-Python retry is
# worthwhile.
INFEASIBLE = "infeasible"

# Don't pre-allocate more than this for the round buffers; past it the
# pure-Python realization (which allocates per round) is the safer path.
# The buffers are np.empty (never zero-filled — the C++ writes every cell of
# each round it returns), so below the cap the cost is address space, not
# touched pages, and the cap only needs to guard true pathologies.
_MAX_REALIZE_BUFFER_BYTES = 512 << 20


def lp_realize(
    vectors: np.ndarray,
    assignment: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
):
    """Realize an integerized [G, T] LP assignment as replication-compressed
    per-type greedy node fills (native). Returns the round list; INFEASIBLE
    when the native code proves the assignment unrealizable (callers drop the
    candidate); None when the library is unavailable or the problem exceeds
    the buffer envelope (callers fall back to pure Python)."""
    lib = load()
    if lib is None:
        return None
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    capacity = np.ascontiguousarray(capacity, dtype=np.float32)
    total = np.ascontiguousarray(total, dtype=np.float32)
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    # [T x G] row-major for per-type column scans.
    assignment_tg = np.ascontiguousarray(assignment.T, dtype=np.int64)
    # Rounds scale with the assignment's nonzero entries, not T*G: each
    # round's binding group drops below its fill, so a (type, group) entry
    # contributes O(1) rounds. 4x + slack headroom; overflow (-1) falls back
    # to the unbounded pure-Python path.
    nnz = int(np.count_nonzero(assignment_tg))
    active = int((assignment_tg.sum(axis=1) > 0).sum())
    max_rounds = 4 * nnz + 16 * active + 64
    if max_rounds * max(num_groups, 1) * 8 > _MAX_REALIZE_BUFFER_BYTES:
        return None
    round_type = np.empty(max_rounds, dtype=np.int32)
    round_fill = np.empty((max_rounds, max(num_groups, 1)), dtype=np.int64)
    round_repl = np.empty(max_rounds, dtype=np.int64)

    def ptr(array, ctype):
        return array.ctypes.data_as(ctypes.POINTER(ctype))

    rounds = lib.ktpu_lp_realize(
        ptr(vectors, ctypes.c_float),
        num_groups,
        dims,
        ptr(assignment_tg, ctypes.c_int64),
        ptr(capacity, ctypes.c_float),
        ptr(total, ctypes.c_float),
        num_types,
        ptr(round_type, ctypes.c_int),
        ptr(round_fill, ctypes.c_int64),
        ptr(round_repl, ctypes.c_int64),
        max_rounds,
    )
    if rounds == -2:
        return INFEASIBLE
    if rounds < 0:
        return None
    # Copy row slices so the (possibly large) backing buffer isn't pinned by
    # views held through decode.
    return [
        (int(round_type[r]), round_fill[r, :num_groups].copy(), int(round_repl[r]))
        for r in range(rounds)
    ]


def mix_enumerate(
    vectors: np.ndarray,
    counts: np.ndarray,
    cand_capacity: np.ndarray,  # [C, D] pre-gathered candidate-type capacity
    seed_groups: np.ndarray,
    fracs: np.ndarray,
    mixers: np.ndarray,  # [G] uint64 hash multipliers (dedup key)
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native pair-seeded fill enumeration for the column-LP mix candidate
    (ops/mix_pack.py). Returns (fills [J, G] int64, candidate index [J]
    int32) deduped, or None when the library is unavailable / overflow."""
    lib = load()
    if lib is None:
        return None
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    cand_capacity = np.ascontiguousarray(cand_capacity, dtype=np.float32)
    seed_groups = np.ascontiguousarray(seed_groups, dtype=np.int32)
    fracs = np.ascontiguousarray(fracs, dtype=np.float32)
    mixers = np.ascontiguousarray(mixers, dtype=np.uint64)
    num_groups, dims = vectors.shape
    num_cand = cand_capacity.shape[0]
    max_out = num_cand * len(seed_groups) * len(fracs) * len(seed_groups) + 1
    out_fills = np.empty((max_out, max(num_groups, 1)), dtype=np.int64)
    out_type = np.empty(max_out, dtype=np.int32)

    def ptr(array, ctype):
        return array.ctypes.data_as(ctypes.POINTER(ctype))

    written = lib.ktpu_mix_enumerate(
        ptr(vectors, ctypes.c_float),
        ptr(counts, ctypes.c_int64),
        num_groups,
        dims,
        ptr(cand_capacity, ctypes.c_float),
        num_cand,
        ptr(seed_groups, ctypes.c_int),
        len(seed_groups),
        ptr(fracs, ctypes.c_float),
        len(fracs),
        ptr(mixers, ctypes.c_uint64),
        ptr(out_fills, ctypes.c_int64),
        ptr(out_type, ctypes.c_int),
        max_out,
    )
    if written < 0:
        return None
    return out_fills[:written].copy(), out_type[:written].copy()


def mix_price(
    demand: np.ndarray,  # [J, D] float64 column demand
    capacity: np.ndarray,  # [T, D]
    pool_floor: np.ndarray,  # [T] float64
    order: np.ndarray,  # [T] int32 type indices, price-ascending
) -> Optional[np.ndarray]:
    """Native demand-dominance pricing (first feasible type in price order).
    Returns [J] float64 prices or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    demand = np.ascontiguousarray(demand, dtype=np.float64)
    capacity = np.ascontiguousarray(capacity, dtype=np.float32)
    pool_floor = np.ascontiguousarray(pool_floor, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int32)
    num_cols, dims = demand.shape
    out = np.empty(num_cols, dtype=np.float64)

    def ptr(array, ctype):
        return array.ctypes.data_as(ctypes.POINTER(ctype))

    lib.ktpu_mix_price(
        ptr(demand, ctypes.c_double),
        num_cols,
        dims,
        ptr(capacity, ctypes.c_float),
        ptr(pool_floor, ctypes.c_double),
        ptr(order, ctypes.c_int),
        capacity.shape[0],
        ptr(out, ctypes.c_double),
    )
    return out


def pool_select_batch(
    demand: np.ndarray,  # [F, D] float64 per-fill demand
    capacity: np.ndarray,  # [T, D]
    row_types: np.ndarray,  # [N] int32 global price-sorted pool order
    row_prices: np.ndarray,  # [N] float64
    max_rows: int,
    min_rows: int,
    band: float,
    ceiling_ratio: float,
    max_types: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native batched pool selection (ktpu_pool_select). Returns
    (selected row indices [F, max_rows], counts [F]; count -1 = no feasible
    row) or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    demand = np.ascontiguousarray(demand, dtype=np.float64)
    capacity = np.ascontiguousarray(capacity, dtype=np.float32)
    row_types = np.ascontiguousarray(row_types, dtype=np.int32)
    row_prices = np.ascontiguousarray(row_prices, dtype=np.float64)
    num_fills, dims = demand.shape
    out_rows = np.empty((num_fills, max_rows), dtype=np.int32)
    out_counts = np.empty(num_fills, dtype=np.int32)

    def ptr(array, ctype):
        return array.ctypes.data_as(ctypes.POINTER(ctype))

    lib.ktpu_pool_select(
        ptr(demand, ctypes.c_double),
        num_fills,
        dims,
        ptr(capacity, ctypes.c_float),
        ptr(row_types, ctypes.c_int),
        ptr(row_prices, ctypes.c_double),
        len(row_types),
        max_rows,
        min_rows,
        band,
        ceiling_ratio,
        max_types,
        ptr(out_rows, ctypes.c_int),
        ptr(out_counts, ctypes.c_int),
    )
    return out_rows, out_counts
