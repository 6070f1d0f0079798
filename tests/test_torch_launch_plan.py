"""The launch plans of the port's two redesigned kernels, on the CPU.

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
"""

import pytest

from karpenter_tpu_torch.ops import pack_kernel, score_kernel

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
