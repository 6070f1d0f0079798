"""The launch plans of the port's redesigned kernels, on the CPU.

K3 (csrc/lp_relax.cu) spreads one LP over a thread-block cluster and K2
(csrc/pack_rounds.cu) lays one mode's round loop over a block, one type per
thread. Each wrapper takes its cluster size, types per block or thread,
threads, shared bytes and storage path from a plain function of the sizes
(`score_kernel.lp_launch_plan`, `pack_kernel.pack_launch_plan`); these tests
hold those functions to what the kernels assume. The card tests
(tests/test_torch_cuda.py) hold the kernels' own byte counts to the plans.
Both functions give a plan for every size up to G 8,192 and T 8,192: past
shared memory the tables go to global scratch, past 4,096 types K2's
threads stream their types' constants.

K9a's persistent kernel (csrc/lp_shard.cu) cuts each shard's block of a
one-device mesh into tiles, a block each, all resident at once
(`lp_shard_kernel.lp_shard_launch_plan`), and K6 (csrc/pack_levels.cu)
spreads a level over a cluster, its types over the blocks and a type over
lanes (`pack_kernel.levels_launch_plan`): every cell or type owned once,
shared memory and the cluster within the card's limits, the blocks within
the resident bound, scratch exactly when nothing fits, the rules pinned at
the main-path and G 2,048 shapes.

K7 (csrc/consolidate.cu) runs a cluster of blocks a candidate, its bins
split over the blocks and 4 or 8 a thread
(`consolidate_kernel.counterfactual_launch_plan`), and K1 (csrc/dominance.cu)
a warp a row t (`cuda_kernels.dominance_launch_plan`): every bin and row
owned once, shared memory within 227 KB, C x k within the SMs, the room in
global scratch exactly when it does not fit, the rules pinned at the real
sweep (C 64 x N 8,192) and the controller's sizes, and the sizes the
kernels do not take refused.
"""

import pytest

from karpenter_tpu_torch.ops import consolidate_kernel, cuda_kernels, lp_shard_kernel, pack_kernel, score_kernel

GROUPS = [1, 3, 8, 16, 64, 128, 1024]
TYPES = [1, 16, 64, 300, 512, 1024, 2048, 4096]
SHAPES = [(g, t, 8) for g in GROUPS for t in TYPES] + [(16, 512, 3), (5, 77, 1)]


def _ids(shape):
    return "G{}xT{}xR{}".format(*shape)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_lp_plan_partitions_every_cell(shape):
    groups, types, dims = shape
    plan = score_kernel.lp_launch_plan(groups, types, dims)
    assert 2 <= plan.cluster <= score_kernel.MAX_CLUSTER
    # Every type is owned by exactly one block of the cluster.
    owners = [plan.owner(t) for t in range(types)]
    assert all(0 <= b < plan.cluster for b in owners)
    assert owners == sorted(owners)
    assert plan.types_per_block * plan.cluster >= types
    assert plan.types_per_block * (plan.cluster - 1) < types or plan.types_per_block == 1
    # Within a block, every (type, group) cell is owned by exactly one
    # thread: threads / Q type slots over the block's types, Q group lanes.
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= score_kernel._THREADS
    assert plan.group_lanes & (plan.group_lanes - 1) == 0 and plan.group_lanes <= 32
    slots = plan.threads // plan.group_lanes
    cells = {}
    for tid in range(plan.threads):
        slot, lane = divmod(tid, plan.group_lanes)
        for j in range(-(-plan.types_per_block // slots)):
            for k in range(-(-groups // plan.group_lanes)):
                t, g = slot + j * slots, lane + k * plan.group_lanes
                if t < plan.types_per_block and g < groups:
                    cells[(t, g)] = cells.get((t, g), 0) + 1
    assert len(cells) == plan.types_per_block * groups and set(cells.values()) == {1}


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_lp_plan_fits_the_card(shape):
    groups, types, dims = shape
    plan = score_kernel.lp_launch_plan(groups, types, dims)
    assert plan.shared_bytes <= score_kernel.SHARED_LIMIT == 232_448
    table, state = score_kernel._lp_layout(
        groups, dims, plan.types_per_block, plan.threads, plan.group_lanes, plan.cluster)
    assert plan.state_bytes == state
    assert plan.shared_bytes == table + (state if plan.state_in_shared else 0)
    assert plan.scratch_bytes == (0 if plan.state_in_shared else plan.cluster * state)
    # The state goes to global scratch exactly when no cluster's shared
    # memory can hold it.
    fits = [
        c for c in (2, 4, 8, 16)
        if score_kernel.lp_plan_for_cluster(groups, types, dims, c).state_in_shared
    ]
    assert plan.state_in_shared == bool(fits)
    if plan.state_in_shared:
        assert plan.cluster in fits
    else:
        assert table + state > score_kernel.SHARED_LIMIT


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_pack_plan_gives_each_type_one_thread(shape):
    groups, types, dims = shape
    plan = pack_kernel.pack_launch_plan(groups, types, dims)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= pack_kernel.MAX_THREADS
    assert plan.types_per_thread in (1, 2, 4)
    if types <= pack_kernel.MAX_THREADS:
        assert plan.types_per_thread == 1
    owned = [tid + k * plan.threads for tid in range(plan.threads) for k in range(plan.types_per_thread)]
    owned = sorted(t for t in owned if t < types)
    assert owned == list(range(types))
    assert all(plan.owner(t) == t % plan.threads for t in range(types))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_pack_plan_fits_the_card(shape):
    groups, types, dims = shape
    plan = pack_kernel.pack_launch_plan(groups, types, dims)
    assert plan.shared_bytes <= pack_kernel.SHARED_LIMIT == 232_448
    fills = 4 * groups * types
    tables = 4 * pack_kernel.pack_table_words(groups, types, dims)
    control = plan.shared_bytes - (fills if plan.fills_in_shared else 0) - (
        tables if plan.tables_in_shared else 0)
    assert control == pack_kernel._CONTROL_BYTES
    # The fills go to global scratch exactly when the block cannot hold
    # them beside the tables; the tables exactly when they alone do not fit.
    assert plan.tables_in_shared == (control + tables <= pack_kernel.SHARED_LIMIT)
    assert plan.fills_in_shared == (
        plan.tables_in_shared and control + tables + fills <= pack_kernel.SHARED_LIMIT)


def test_lp_plan_rule_at_the_main_path_shape():
    plan = score_kernel.lp_launch_plan(16, 512, 8)
    assert (plan.cluster, plan.types_per_block, plan.threads, plan.group_lanes) == (16, 32, 512, 16)
    assert plan.state_in_shared


def test_lp_plan_grows_the_cluster_before_scratch():
    # 32 types a block of 250 groups do not fit one block's shared memory
    # at cluster 8 (T 256); the rule doubles the cluster instead of going
    # to scratch.
    assert not score_kernel.lp_plan_for_cluster(250, 256, 8, 8).state_in_shared
    plan = score_kernel.lp_launch_plan(250, 256, 8)
    assert plan.cluster == 16 and plan.state_in_shared


def test_lp_plan_shrinks_the_cluster_and_threads_for_its_tables():
    # At 1,024 groups the exchange and reduction tables of 16 blocks of 512
    # threads pass the limit on their own; the state goes to scratch and
    # the plan shrinks until the tables fit.
    assert score_kernel.lp_plan_for_cluster(1024, 4096, 8, 16).shared_bytes > score_kernel.SHARED_LIMIT
    plan = score_kernel.lp_launch_plan(1024, 4096, 8)
    assert not plan.state_in_shared
    assert plan.shared_bytes <= score_kernel.SHARED_LIMIT


@pytest.mark.parametrize("cluster", [0, 1, 17, 32])
def test_lp_plan_refuses_a_cluster_outside_the_card(cluster):
    with pytest.raises(ValueError):
        score_kernel.lp_plan_for_cluster(16, 512, 8, cluster)


def test_pack_plan_rule_at_the_main_path_shape():
    plan = pack_kernel.pack_launch_plan(16, 512, 8)
    assert plan == pack_kernel.PackLaunchPlan(512, 1, 35_552, True, True)


# Past the old limits (1,024 groups, 4,096 types, K3's tables at G 2,048 and
# T 2,048): every size gets a plan that fits the card.
LARGE_GROUPS = [1025, 1100, 2048, 4096, 8192]
LARGE_TYPES = [16, 512, 2048, 4097, 8192]
LARGE = [(g, t, 8) for g in LARGE_GROUPS for t in LARGE_TYPES] + [
    (g, t, 8) for g in (1, 16, 64) for t in (4097, 6000, 8192)]


@pytest.mark.parametrize("shape", LARGE, ids=_ids)
def test_pack_plan_takes_every_size(shape):
    groups, types, dims = shape
    plan = pack_kernel.pack_launch_plan(groups, types, dims)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= pack_kernel.MAX_THREADS
    assert plan.threads * plan.types_per_thread >= types
    assert plan.threads * (plan.types_per_thread - 1) < types
    if types > 4 * pack_kernel.MAX_THREADS:
        assert plan.types_per_thread == -(-types // pack_kernel.MAX_THREADS) > 4
    assert plan.shared_bytes <= pack_kernel.SHARED_LIMIT
    assert plan.tables_in_shared or not plan.fills_in_shared
    if groups * 11 * 4 > pack_kernel.SHARED_LIMIT:
        assert not plan.tables_in_shared


@pytest.mark.parametrize("shape", LARGE, ids=_ids)
def test_lp_plan_takes_every_size(shape):
    groups, types, dims = shape
    plan = score_kernel.lp_launch_plan(groups, types, dims)
    assert 2 <= plan.cluster <= score_kernel.MAX_CLUSTER
    assert plan.types_per_block * plan.cluster >= types
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= score_kernel._THREADS
    assert plan.group_lanes & (plan.group_lanes - 1) == 0 and plan.group_lanes <= 32
    # Every (type, group) cell of a block has one owner: the type slots
    # cover the block's types and the lanes its groups.
    slots = plan.threads // plan.group_lanes
    assert slots * -(-plan.types_per_block // slots) >= plan.types_per_block
    assert plan.shared_bytes <= score_kernel.SHARED_LIMIT
    table, state = score_kernel._lp_layout(
        groups, dims, plan.types_per_block, plan.threads, plan.group_lanes, plan.cluster,
        plan.tables_in_shared)
    assert plan.state_bytes == state
    assert plan.shared_bytes == table + (state if plan.state_in_shared else 0)
    if plan.tables_in_shared:
        assert plan.table_bytes == 0
    else:
        # Tables in global scratch only where no plan holds them, and the
        # state with them.
        assert not plan.state_in_shared
        assert plan.table_bytes == score_kernel.lp_global_table_bytes(
            groups, dims, plan.threads, plan.cluster)
        shared_tables, _ = score_kernel._lp_layout(
            groups, dims, plan.types_per_block, plan.threads, plan.group_lanes, plan.cluster)
        assert shared_tables > score_kernel.SHARED_LIMIT


def test_lp_plan_puts_the_tables_in_global_scratch_past_shared_memory():
    # G 2,048 at T 2,048 and G 4,096 at any T raised before: the tables of
    # the smallest block outgrow shared memory.
    for groups, types in ((2048, 2048), (4096, 16), (8192, 8192)):
        plan = score_kernel.lp_launch_plan(groups, types, 8)
        assert not plan.tables_in_shared and not plan.state_in_shared
        assert plan.shared_bytes < score_kernel.SHARED_LIMIT // 4
    # G 2,048 at the main path's T still holds its tables in shared memory.
    assert score_kernel.lp_launch_plan(2048, 512, 8).tables_in_shared


# --- K9a's persistent kernel ----------------------------------------------------

# (shards, a shard's rows, its columns): the 2x2, 2x4 and 1x7 meshes at the
# main path's G 16 x T 512 (21 x 518 on 1x7), G 2,048 on 2x4, and a spread
# of sizes up to a state that no block holds.
LP_SHARD_SHAPES = [(4, 8, 256), (8, 8, 128), (7, 3, 74), (8, 1024, 128)] + [
    (s, r, c) for s in (1, 2, 8, 16) for r in (1, 8, 21, 300, 4096) for c in (1, 74, 256, 2048)]


def _shard_ids(shape):
    return "S{}x{}x{}".format(*shape)


def _tiles(size, tiles, tile):
    """The [start, stop) of each tile along an axis, as the kernel cuts it."""
    return [(k * tile, min(size, (k + 1) * tile)) for k in range(tiles)]


@pytest.mark.parametrize("shape", LP_SHARD_SHAPES, ids=_shard_ids)
def test_lp_shard_plan_owns_every_cell_once(shape):
    shards, rows, cols = shape
    plan = lp_shard_kernel.lp_shard_launch_plan(shards, rows, cols, 8)
    assert plan.threads == lp_shard_kernel.PERSIST_THREADS == 256
    assert plan.blocks == shards * plan.row_tiles * plan.col_tiles
    # Along each axis the tiles are non-empty, in order and cover it once,
    # so their product covers a shard's block once.
    for size, tiles, tile in ((rows, plan.row_tiles, plan.tile_rows), (cols, plan.col_tiles, plan.tile_cols)):
        spans = _tiles(size, tiles, tile)
        assert all(start < stop for start, stop in spans)
        assert [i for start, stop in spans for i in range(start, stop)] == list(range(size))
    # Each block owns one tile of one shard.
    owners = {plan.owner(s, r, c) for s in range(shards)
              for r, _ in _tiles(rows, plan.row_tiles, plan.tile_rows)
              for c, _ in _tiles(cols, plan.col_tiles, plan.tile_cols)}
    assert owners == set(range(plan.blocks))


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("shape", LP_SHARD_SHAPES, ids=_shard_ids)
def test_lp_shard_plan_fits_the_card(shape, blocks_per_sm):
    shards, rows, cols = shape
    plan = lp_shard_kernel.lp_shard_launch_plan(shards, rows, cols, 8, blocks_per_sm=blocks_per_sm)
    # A cooperative launch needs every block resident at once.
    assert plan.blocks <= lp_shard_kernel.H100_SMS * blocks_per_sm
    assert plan.shared_bytes <= score_kernel.SHARED_LIMIT == 232_448
    table, state = lp_shard_kernel.lp_shard_layout(plan.tile_rows, plan.tile_cols, 8)
    assert plan.state_bytes == state
    assert plan.shared_bytes == table + (state if plan.state_in_shared else 0)
    # The state goes to global scratch exactly when no block holds it.
    assert plan.state_in_shared == (table + state <= score_kernel.SHARED_LIMIT)
    assert (plan.scratch_bytes == 0) == plan.state_in_shared
    if not plan.state_in_shared:
        assert plan.scratch_bytes == 2 * 4 * shards * rows * cols


def test_lp_shard_plan_rule_at_the_main_path_and_g2048():
    def tiling(shards, rows, cols):
        plan = lp_shard_kernel.lp_shard_launch_plan(shards, rows, cols, 8)
        return (plan.blocks, plan.row_tiles, plan.col_tiles, plan.tile_rows, plan.tile_cols,
                plan.state_in_shared)

    # G 16 x T 512: 2x2 cuts a shard's 8 x 256 into two column tiles, 2x4
    # keeps a shard a block; 1x7 (G 21 x T 518) two row tiles a shard.
    assert tiling(4, 8, 256) == (8, 1, 2, 8, 128, True)
    assert tiling(8, 8, 128) == (8, 1, 1, 8, 128, True)
    assert tiling(7, 3, 74) == (7, 1, 1, 3, 74, True)
    assert tiling(7, 21, 74) == (14, 2, 1, 11, 74, True)
    # G 2,048 x T 512 on 2x4: 16 tiles of 64 x 128 a shard, 128 blocks, the
    # state (183,808 bytes a block) in shared memory.
    assert tiling(8, 1024, 128) == (128, 16, 1, 64, 128, True)
    assert lp_shard_kernel.lp_shard_launch_plan(8, 1024, 128, 8).shared_bytes == 183_808


def test_lp_shard_plan_puts_the_state_in_scratch_past_shared_memory():
    # G 8,192 x T 512 on 2x4: 16 tiles of 256 x 128 a shard, whose state
    # (688,128 bytes) no block holds.
    plan = lp_shard_kernel.lp_shard_launch_plan(8, 4096, 128, 8)
    assert (plan.blocks, plan.tile_rows, plan.tile_cols) == (128, 256, 128)
    assert not plan.state_in_shared and plan.scratch_bytes == 2 * 4 * 8 * 4096 * 128


@pytest.mark.parametrize("args", [(133, 1, 1, 8), (8, 16, 512, 0), (8, 16, 512, 9), (0, 16, 512, 8)])
def test_lp_shard_plan_refuses_what_the_card_cannot_hold(args):
    with pytest.raises(ValueError):
        lp_shard_kernel.lp_shard_launch_plan(*args)


# --- K6: a cluster a level ------------------------------------------------------

LEVEL_SHAPES = [(g, t, 8) for g in (1, 16, 64, 300, 2048) for t in (1, 8, 64, 100, 128, 256, 512, 1024, 1500, 8192)] + [
    (64, 512, 3), (16, 300, 1)]


@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=_ids)
def test_levels_plan_owns_every_type_once(shape):
    groups, types, dims = shape
    plan = pack_kernel.levels_launch_plan(groups, types, dims)
    assert 1 <= plan.cluster <= pack_kernel.LEVELS_MAX_CLUSTER == 16
    assert plan.lanes in (1, 2, 4, 8) and plan.lanes <= max(1, 2 * dims)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= pack_kernel.LEVELS_MAX_THREADS == 512
    slots = plan.threads // plan.lanes
    owned = {}
    for rank in range(plan.cluster):
        start = rank * plan.types_per_block
        local = max(0, min(plan.types_per_block, types - start))
        for slot in range(slots):
            for k in range(-(-plan.types_per_block // slots)):
                tl = slot + k * slots
                if tl < local:
                    owned[start + tl] = owned.get(start + tl, 0) + 1
                    assert plan.owner(start + tl) == rank
    assert sorted(owned) == list(range(types)) and set(owned.values()) == {1}


@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=_ids)
def test_levels_plan_fits_the_card(shape):
    groups, types, dims = shape
    plan = pack_kernel.levels_launch_plan(groups, types, dims)
    assert plan.shared_bytes <= pack_kernel.SHARED_LIMIT == 232_448
    tables = 4 * pack_kernel.levels_table_words(groups, plan.types_per_block, dims)
    fills = 4 * pack_kernel.levels_fill_words(groups, plan.types_per_block)
    control = pack_kernel._LEVELS_CONTROL_BYTES
    assert plan.shared_bytes == (control + (tables if plan.tables_in_shared else 0)
                                 + (fills if plan.fills_in_shared else 0))
    # Scratch exactly when shared memory cannot hold it.
    assert plan.tables_in_shared == (control + tables <= pack_kernel.SHARED_LIMIT)
    assert plan.fills_in_shared == (
        plan.tables_in_shared and control + tables + fills <= pack_kernel.SHARED_LIMIT)
    assert plan.placed_in_registers == (groups <= 256)


def test_levels_plan_rule_at_the_constrained_cell_and_g2048():
    # The constrained cell (G' 64, T 512, R 8): clusters of 8 blocks of 64
    # types, 8 lanes a type, everything in shared memory.
    assert pack_kernel.levels_launch_plan(64, 512, 8) == pack_kernel.LevelsLaunchPlan(
        8, 8, 64, 512, 53_928, True, True, True)
    # G' 2,048: the tables, fills and placed bits in global scratch.
    assert pack_kernel.levels_launch_plan(2048, 512, 8) == pack_kernel.LevelsLaunchPlan(
        8, 8, 64, 512, 416, False, False, False)


@pytest.mark.parametrize("types,cluster", [(64, 1), (128, 2), (256, 4), (512, 8), (1024, 16), (8192, 16)])
def test_levels_plan_reaches_every_cluster_size(types, cluster):
    assert pack_kernel.levels_launch_plan(64, types, 8).cluster == cluster


@pytest.mark.parametrize("cluster,lanes", [(0, 8), (17, 8), (8, 3), (8, 16)])
def test_levels_plan_refuses_a_cluster_or_lanes_outside_the_kernel(cluster, lanes):
    with pytest.raises(ValueError):
        pack_kernel.levels_plan_for(64, 512, 8, cluster, lanes)


# --- K7: a cluster a candidate ----------------------------------------------

# (C, N): the real sweep (C 64, N 8,192), the controller's smaller sweeps,
# C on both sides of each cluster size's SM bound (132 SMs: 16 | 17, 33 | 34,
# 66 | 67), N off every multiple of 4 x threads x k, and N past 8,192 bins a
# block.
K7_SHAPES = [(64, 8192), (8, 8192), (16, 8192), (17, 8192), (33, 4096), (34, 4096), (66, 8192),
             (67, 8192), (128, 8192), (1, 1), (2, 3), (2, 3000), (3, 9), (13, 70), (17, 1300),
             (64, 2000), (5, 4101), (5, 4100), (200, 100), (128, 16384), (2, 65536)]


def _k7_ids(shape):
    return "C{}xN{}".format(*shape)


def _kernel_bins(plan, rank, thread, bins):
    """The bins csrc/consolidate.cu gives thread `thread` of block `rank`."""
    first = rank * plan.bins_per_block + thread * plan.bins_per_thread
    owned = max(0, min(plan.bins_per_thread, min(rank * plan.bins_per_block + plan.bins_per_block, bins) - first))
    return range(first, first + owned)


@pytest.mark.parametrize("axes", [3, 8])
@pytest.mark.parametrize("shape", K7_SHAPES, ids=_k7_ids)
def test_counterfactual_plan_owns_every_bin_once(shape, axes):
    candidates, bins = shape
    plan = consolidate_kernel.counterfactual_launch_plan(candidates, 16, bins, axes)
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.bins_per_thread in (4, 8)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.bins_per_block % plan.bins_per_thread == 0
    assert plan.threads * plan.bins_per_thread >= plan.bins_per_block
    owned = [n for rank in range(plan.cluster) for thread in range(plan.threads)
             for n in _kernel_bins(plan, rank, thread, bins)]
    assert sorted(owned) == list(range(bins))
    assert all(n in _kernel_bins(plan, *plan.owner(n)[:2], bins) for n in range(0, bins, 97))


@pytest.mark.parametrize("axes", [0, 1, 3, 6, 7, 8])
@pytest.mark.parametrize("shape", K7_SHAPES, ids=_k7_ids)
def test_counterfactual_plan_fits_the_card(shape, axes):
    candidates, bins = shape
    sms = consolidate_kernel.H100_SMS
    plan = consolidate_kernel.counterfactual_launch_plan(candidates, 16, bins, axes)
    assert plan.shared_bytes <= consolidate_kernel.SHARED_LIMIT == 232_448
    # The cluster fills the SMs without passing them, unless a block would
    # own more than 8 x 1,024 bins.
    rule = max([k for k in (1, 2, 4, 8) if candidates * k <= sms] or [1])
    if -(-bins // rule) <= 8 * 1024:
        assert plan.cluster == rule and candidates * plan.cluster <= max(sms, candidates)
    else:
        assert plan.cluster > rule and -(-bins // (plan.cluster // 2)) > 8 * 1024
    # The room in global scratch exactly when it does not fit beside the
    # control words.
    room = 4 * plan.threads * plan.room_words
    assert plan.room_words == plan.bins_per_thread * axes | 1
    assert plan.room_in_shared == (consolidate_kernel.CONTROL_BYTES + room <= consolidate_kernel.SHARED_LIMIT)
    assert plan.shared_bytes == consolidate_kernel.CONTROL_BYTES + (room if plan.room_in_shared else 0)
    assert plan.scratch_words(candidates) == (
        0 if plan.room_in_shared else candidates * plan.cluster * plan.threads * plan.room_words)


def test_counterfactual_plan_rule_at_the_real_sweep():
    # C 64 x N 8,192: clusters of 2 blocks of 1,024 threads, 4 bins a
    # thread; the room in shared memory with 3 axes and with all 8.
    for axes, shared in ((3, 54_736), (8, 136_656)):
        assert consolidate_kernel.counterfactual_launch_plan(64, 16, 8192, axes) == \
            consolidate_kernel.CounterfactualPlan(2, 1024, 4, 4096, 4 * axes + 1, shared, True)


@pytest.mark.parametrize("candidates,cluster", [(8, 8), (16, 8), (17, 4), (33, 4), (34, 2), (64, 2),
                                                (66, 2), (67, 1), (128, 1)])
def test_counterfactual_plan_at_the_controller_sizes(candidates, cluster):
    plan = consolidate_kernel.counterfactual_launch_plan(candidates, 16, 8192, 3)
    assert plan.cluster == cluster and plan.room_in_shared
    assert plan.bins_per_block == 8192 // cluster
    assert plan.threads == min(1024, 8192 // cluster // 4) or plan.bins_per_thread == 8


def test_counterfactual_plan_scratch_only_past_shared_memory():
    # One block a candidate at N 8,192: 8 bins a thread; 6 axes fit shared
    # memory, 7 do not.
    assert consolidate_kernel.counterfactual_launch_plan(128, 16, 8192, 6).room_in_shared
    plan = consolidate_kernel.counterfactual_launch_plan(128, 16, 8192, 7)
    assert (plan.cluster, plan.bins_per_thread, plan.threads) == (1, 8, 1024)
    assert not plan.room_in_shared and plan.shared_bytes == consolidate_kernel.CONTROL_BYTES
    # Forced onto one block, the real sweep's 8 axes go to scratch too.
    assert not consolidate_kernel.counterfactual_launch_plan(64, 16, 8192, 8, cluster=1).room_in_shared


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_counterfactual_plan_takes_a_forced_cluster(cluster):
    plan = consolidate_kernel.counterfactual_launch_plan(2, 1, 3000, 1, cluster=cluster)
    assert plan.cluster == cluster
    assert cluster * plan.bins_per_block >= 3000


@pytest.mark.parametrize("args,kwargs", [
    ((0, 16, 8192, 3), {}), ((64, 0, 8192, 3), {}), ((64, 16, 0, 3), {}), ((64, 16, 8192, 9), {}),
    ((64, 16, 8192, -1), {}), ((1, 1, 65537, 3), {}), ((64, 16, 8192, 3), {"cluster": 3}),
    ((64, 16, 8192, 3), {"cluster": 16}), ((64, 16, 32768, 3), {"cluster": 1}),
])
def test_counterfactual_plan_refuses_what_the_kernel_does_not_take(args, kwargs):
    with pytest.raises(ValueError):
        consolidate_kernel.counterfactual_launch_plan(*args, **kwargs)


# --- K1: one warp a row ---------------------------------------------------------

DOMINANCE_TYPES = [1, 2, 31, 32, 33, 131, 132, 133, 263, 264, 265, 400, 512, 513, 1000, 2048, 4095, 4096]


@pytest.mark.parametrize("types", DOMINANCE_TYPES)
def test_dominance_plan_owns_every_row_once(types):
    sms = cuda_kernels.H100_SMS
    plan = cuda_kernels.dominance_launch_plan(types, 8)
    assert plan.threads_per_row == 32 and plan.threads == 32 * plan.rows <= 1024
    assert plan.rows & (plan.rows - 1) == 0 and 1 <= plan.rows <= cuda_kernels.MAX_ROWS
    owners = [plan.owner(t) for t in range(types)]
    assert len(set(owners)) == types
    assert all(0 <= block < plan.blocks and 0 <= warp < plan.rows for block, warp in owners)
    assert plan.blocks == -(-types // plan.rows)
    # About one block an SM: the rows a block grow only while the blocks
    # would pass the SMs.
    assert plan.blocks <= sms or plan.rows == cuda_kernels.MAX_ROWS
    assert plan.rows == 1 or -(-types // (plan.rows // 2)) > sms


def test_dominance_plan_rule_at_the_main_path_and_t4096():
    assert cuda_kernels.dominance_launch_plan(512, 8) == cuda_kernels.DominancePlan(4, 32, 128)
    assert cuda_kernels.dominance_launch_plan(4096, 8) == cuda_kernels.DominancePlan(32, 32, 128)
    assert cuda_kernels.dominance_launch_plan(1, 8) == cuda_kernels.DominancePlan(1, 32, 1)
    assert cuda_kernels.dominance_launch_plan(8192, 3).rows == 32


@pytest.mark.parametrize("args", [(0, 8), (512, 0), (512, 9), (512, 8, 0)])
def test_dominance_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        cuda_kernels.dominance_launch_plan(*args)
