"""Sharded LP solve and the level-sharded constrained dispatch: the mesh
paths.

The port of karpenter_tpu/parallel/sharded_solver.py. The [G, T]
assignment problem shards over the ("groups", "types") mesh: shard (i, j)
holds block (i, j) of the logits, the Adam moments, the softmax and the
feasibility mask, the i-th block of the group tables and the j-th of the
type tables. The route follows from the mesh:

  * shards on more than one device: one Adam step is K9a's three phases on
    every shard (ops/lp_shard_kernel) with the cross-shard reductions of
    parallel/collectives.py between them: the row max and row sum of the
    softmax over the types axis, the demand over the groups axis, the row
    dot over the types axis. This is the reference's GSPMD program written
    out, and the only route with transport between cards;
  * every shard on one card: the blocks are stacked and the whole LP is
    one launch of K9a's persistent kernel (`lp_shard_kernel.shard_lp`),
    which takes the same reductions inside the launch. On the CPU the
    mesh takes the per-phase route, whose wrappers run the phases' plain
    versions: the plain version of both routes.

The constrained [L, G, T] dispatch shards its relaxation-level axis over
every shard of the mesh: levels are independent solves over the same
fleet, so each shard runs K6 (ops/pack_kernel.pack_kernel_levels) on its
block of levels, and only the small per-level evidence and the chosen
level's rounds leave the shards.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.ops import lp_shard_kernel
from karpenter_tpu_torch.ops.score_kernel import (
    LPResult,
    _bias_table,
    bias_corrections,
    feasibility_mask,
)
from karpenter_tpu_torch.parallel import collectives
from karpenter_tpu_torch.parallel.mesh import Mesh, block, make_mesh, pad_multiple

Grid = collectives.Grid


class LPTrainState(NamedTuple):
    """Optimizer state for the assignment-logits 'model', in shard blocks:
    logits and Adam's mu/nu as [g][t] grids of [G/g, T/t] float32 blocks,
    each on its shard's device, and the Adam steps taken so far."""

    logits: Grid
    mu: Grid
    nu: Grid
    count: int


class ShardedProblem(NamedTuple):
    """One LP's operands laid out over a mesh: per shard its block of the
    group tables (vectors [G', R], counts [G'] float32), of the type tables
    (capacity [T', R], prices [T']) and of the feasibility mask [G', T']."""

    vectors: Grid
    counts: Grid
    capacity: Grid
    prices: Grid
    feasible: Grid


class ShardedLP(NamedTuple):
    """The relaxed plan in shard blocks: assignment [G', T'] and nodes [T']
    per shard, and the objective on the mesh's first shard."""

    assignment: Grid
    nodes: Grid
    objective: torch.Tensor


def _grid(mesh: Mesh, make: Callable) -> Grid:
    return [[make(row, col) for col in range(mesh.shape[1])] for row in range(mesh.shape[0])]


def _check_divides(mesh: Mesh, groups: int, types: int) -> None:
    if groups % mesh.shape[0] or types % mesh.shape[1]:
        raise ValueError(
            f"a [{groups}, {types}] problem does not split over a {mesh.shape} mesh; "
            "pad G and T to multiples of its axes"
        )


def shard_lp_problem(mesh: Mesh, replicas: Dict[torch.device, Sequence[torch.Tensor]]) -> ShardedProblem:
    """Lay an LP over `mesh` from one full copy of its operands per device
    of the mesh: replicas[device] = (vectors [G, R] f32, counts [G] (any
    number type), capacity [T, R] f32, valid [T] bool, prices [T] f32) on
    that device. Each shard slices its device's copy."""
    vectors, _, capacity, _, _ = replicas[mesh.flat[0].device]
    groups, types = vectors.shape[0], capacity.shape[0]
    _check_divides(mesh, groups, types)

    def part(row, col, index):
        shard = mesh.shard(row, col)
        full = replicas[shard.device][index]
        if index < 2:
            return full[block(groups, mesh.shape[0], row)]
        return full[block(types, mesh.shape[1], col)]

    def feasible(row, col):
        return feasibility_mask(part(row, col, 0), part(row, col, 2), part(row, col, 3)).contiguous()

    return ShardedProblem(
        vectors=_grid(mesh, lambda r, c: part(r, c, 0).contiguous()),
        counts=_grid(mesh, lambda r, c: part(r, c, 1).to(torch.float32).contiguous()),
        capacity=_grid(mesh, lambda r, c: part(r, c, 2).contiguous()),
        prices=_grid(mesh, lambda r, c: part(r, c, 4).contiguous()),
        feasible=_grid(mesh, feasible),
    )


def lp_train_init(mesh: Mesh, problem: ShardedProblem) -> LPTrainState:
    """The price-density start (-log(p / max(max_r K, 1) + 1e-9) broadcast
    over the groups) and zero moments, in shard blocks."""

    def logits0(row, col):
        prices = problem.prices[row][col]
        density = prices / torch.clamp(problem.capacity[row][col].amax(dim=1), min=1.0)
        start = -torch.log(density + 1e-9)
        return start.expand(problem.feasible[row][col].shape).to(torch.float32).contiguous()

    logits = _grid(mesh, logits0)
    return LPTrainState(
        logits=logits,
        mu=_grid(mesh, lambda r, c: torch.zeros_like(logits[r][c])),
        nu=_grid(mesh, lambda r, c: torch.zeros_like(logits[r][c])),
        count=0,
    )


class _Scratch(NamedTuple):
    share: Grid  # S (or e between the softmax and the demand phase)
    d_share: Grid  # dS


def _bias_rows(steps_from: int, steps: int, device: torch.device) -> torch.Tensor:
    """Adam's bias corrections for steps steps_from+1 .. steps_from+steps,
    [steps, 2] on `device`: from the start, K3's table (copied to the card
    once per step count, without a host sync)."""
    if steps_from == 0 and device.type == "cuda":
        return _bias_table(steps, device)
    table = bias_corrections(steps_from + steps)[steps_from:]
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


class Phases(NamedTuple):
    """K9a's three phases: the kernels' wrappers or their plain versions."""

    softmax: Callable
    demand: Callable
    row_dot: Callable


_PLAIN_PHASES = Phases(lp_shard_kernel._softmax_ref, lp_shard_kernel._demand_ref,
                       lp_shard_kernel._row_dot_ref)


def _kernel_phases() -> Phases:
    """The phases' wrappers, looked up at the call."""
    return Phases(lp_shard_kernel.shard_softmax, lp_shard_kernel.shard_demand,
                  lp_shard_kernel.shard_row_dot)


def _softmax(mesh, problem, state, scratch, ref, row_dot, bias, phases) -> Tuple[Grid, Optional[Grid]]:
    """K9a's softmax phase on every shard, then its reductions over the
    types axis: (row max, row sum) grids, the sum None without `ref`."""
    maxima, sums = [], []
    for row in range(mesh.shape[0]):
        row_max, row_sum = [], []
        for col in range(mesh.shape[1]):
            device = mesh.shard(row, col).device
            top, total = phases.softmax(
                state.logits[row][col], state.mu[row][col], state.nu[row][col],
                scratch.share[row][col], scratch.d_share[row][col], problem.feasible[row][col],
                None if row_dot is None else row_dot[row][col],
                None if ref is None else ref[row][col],
                None if bias is None else bias[device],
            )
            row_max.append(top)
            row_sum.append(total)
        maxima.append(row_max)
        sums.append(row_sum)
    maxima = collectives.max_over_types(mesh, maxima)
    return maxima, (None if ref is None else collectives.sum_over_types(mesh, sums))


def _demand(mesh, problem, scratch, totals, phases, assignment=None) -> Grid:
    parts = _grid(mesh, lambda r, c: phases.demand(
        scratch.share[r][c], problem.feasible[r][c], problem.counts[r][c],
        problem.vectors[r][c], totals[r][c], None if assignment is None else assignment[r][c],
    ))
    return collectives.sum_over_groups(mesh, parts)


def _row_dot(mesh, problem, scratch, demand, phases) -> Grid:
    parts = _grid(mesh, lambda r, c: phases.row_dot(
        scratch.share[r][c], scratch.d_share[r][c], problem.feasible[r][c], problem.counts[r][c],
        problem.vectors[r][c], problem.capacity[r][c], problem.prices[r][c], demand[r][c],
    ))
    return collectives.sum_over_types(mesh, parts)


def _start(mesh, problem, state, phases) -> Tuple[_Scratch, Grid, Grid]:
    """Fresh S/dS scratch and the first softmax: the exact row max as the
    reference, then e against it. Returns (scratch, ref, totals)."""
    scratch = _Scratch(
        share=_grid(mesh, lambda r, c: torch.zeros_like(state.logits[r][c])),
        d_share=_grid(mesh, lambda r, c: torch.zeros_like(state.logits[r][c])),
    )
    ref, _ = _softmax(mesh, problem, state, scratch, None, None, None, phases)
    ref, totals = _softmax(mesh, problem, state, scratch, ref, None, None, phases)
    return scratch, ref, totals


def _run_phases(mesh, problem, state, bias, steps: int, final: bool, phases: Optional[Phases] = None):
    """The per-phase route: `steps` Adam steps from `state`, in place, with
    `bias` ({device: [>= steps, 2]}), each K9a's three phases on every
    shard with the collectives between, then with `final` the pass that
    writes the relaxed assignment; through `phases`, by default the
    kernels' wrappers (which run the plain versions on CPU tensors).
    Returns (assignment grid or None, demand grid: the final pass's, or the
    last step's, of the state before its update)."""
    phases = phases or _kernel_phases()
    scratch, ref, totals = _start(mesh, problem, state, phases)
    demand = None
    for step in range(steps):
        demand = _demand(mesh, problem, scratch, totals, phases)
        row_dot = _row_dot(mesh, problem, scratch, demand, phases)
        step_bias = {device: rows[step] for device, rows in bias.items()}
        ref, totals = _softmax(mesh, problem, state, scratch, ref, row_dot, step_bias, phases)
    if not final:
        return None, demand
    assignment = _grid(mesh, lambda r, c: torch.empty_like(state.logits[r][c]))
    return assignment, _demand(mesh, problem, scratch, totals, phases, assignment)


def _run_persistent(mesh, problem, state, bias, steps: int, final: bool):
    """The one-card route: the blocks stacked, K9a's persistent kernel over
    them, the state's blocks updated from it. Returns as _run_phases."""
    flat = [(r, c) for r in range(mesh.shape[0]) for c in range(mesh.shape[1])]

    def stacked(grid):
        return torch.stack([grid[r][c] for r, c in flat])

    logits, mu, nu = stacked(state.logits), stacked(state.mu), stacked(state.nu)
    assignment, demand = lp_shard_kernel.shard_lp(
        torch.stack([problem.vectors[r][0] for r in range(mesh.shape[0])]),
        torch.stack([problem.counts[r][0] for r in range(mesh.shape[0])]),
        torch.stack([problem.capacity[0][c] for c in range(mesh.shape[1])]),
        torch.stack([problem.prices[0][c] for c in range(mesh.shape[1])]),
        stacked(problem.feasible), logits, mu, nu, bias[mesh.devices[0]], steps, mesh.shape, final,
    )
    for index, (r, c) in enumerate(flat):
        for grid, new in ((state.logits, logits), (state.mu, mu), (state.nu, nu)):
            grid[r][c].copy_(new[index])
    blocks = None if assignment is None else _grid(
        mesh, lambda r, c: assignment[r * mesh.shape[1] + c])
    return blocks, _grid(mesh, lambda r, c: demand[c])


def _route(mesh: Mesh) -> Callable:
    """The LP's route over `mesh`: K9a's persistent kernel when every shard
    lies on one card; else its phases with the collectives between (across
    devices, and on the CPU, where the wrappers run the plain versions)."""
    if len(mesh.devices) == 1 and mesh.devices[0].type == "cuda":
        return _run_persistent
    return _run_phases


def _run_steps(mesh, problem, state, steps: int, final: bool):
    """`steps` Adam steps from `state`, in place, then with `final` the pass
    that writes the relaxed assignment, by the route of the mesh. Returns
    (assignment grid or None, demand grid: the final pass's, or the last
    step's)."""
    bias = {device: _bias_rows(state.count, steps, device) for device in mesh.devices}
    return _route(mesh)(mesh, problem, state, bias, steps, final)


def sharded_lp_blocks(mesh: Mesh, problem: ShardedProblem, steps: int = 300) -> ShardedLP:
    """The LP relaxation over `mesh`: `steps` Adam steps from the
    price-density start, then the relaxed assignment, the hard-max nodes
    and the objective, all in shard blocks."""
    state = lp_train_init(mesh, problem)
    assignment, demand = _run_steps(mesh, problem, state, steps, final=True)
    nodes = _grid(mesh, lambda r, c: (
        demand[r][c] / torch.clamp(problem.capacity[r][c], min=1e-3)).amax(dim=1))
    partials = _grid(mesh, lambda r, c: torch.sum(problem.prices[r][c] * nodes[r][c]))
    objective = collectives.sum_over_types(mesh, partials)[0][0]
    return ShardedLP(assignment=assignment, nodes=nodes, objective=objective)


def _replicas(mesh: Mesh, arrays: Sequence[np.ndarray]) -> Dict[torch.device, Tuple[torch.Tensor, ...]]:
    """One copy of the numpy `arrays` on each device of the mesh, in one
    packed upload a device."""
    from karpenter_tpu_torch.convert import upload_packed

    return {device: upload_packed(list(arrays), device) for device in mesh.devices}


def _pad(array, size):
    array = np.asarray(array)
    if array.shape[0] >= size:
        return array
    widths = [(0, size - array.shape[0])] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, widths)


def sharded_lp_solve(
    vectors,
    counts,
    capacity,
    valid_types,
    prices,
    steps: int = 300,
    mesh: Optional[Mesh] = None,
) -> LPResult:
    """Multi-shard LP solve: pads G and T to mesh-divisible sizes, lays the
    operands over the mesh and runs the optimization loop. The assignment
    and nodes come back assembled on the first shard's device, at the
    padded sizes, as the reference's do."""
    mesh = mesh or make_mesh()
    groups_size, types_size = mesh.shape
    g = pad_multiple(np.asarray(vectors).shape[0], max(groups_size, 1))
    t = pad_multiple(np.asarray(capacity).shape[0], max(types_size, 1))
    arrays = [
        _pad(vectors, g).astype(np.float32),
        _pad(counts, g).astype(np.float32),
        _pad(capacity, t).astype(np.float32),
        _pad(valid_types, t).astype(bool),
        _pad(prices, t).astype(np.float32),
    ]
    problem = shard_lp_problem(mesh, _replicas(mesh, arrays))
    lp = sharded_lp_blocks(mesh, problem, steps)
    nodes = torch.cat([part.to(mesh.flat[0].device) for part in lp.nodes[0]])
    return LPResult(
        assignment=collectives.assemble(mesh, lp.assignment),
        fractional_nodes=nodes,
        objective=lp.objective,
    )


def sharded_lp_train_step(mesh: Optional[Mesh] = None):
    """Build a train step over `mesh`. Returns (step_fn, mesh).

    step_fn(state, vectors, counts, capacity, prices, feasible) ->
    (state, loss): one Adam step of lp_objective from `state` (an
    LPTrainState in shard blocks, e.g. from convert.lp_train_state_from_numpy),
    the operands full-size numpy arrays ([G, R], [G], [T, R], [T], [G, T]
    bool) with G and T divisible by the mesh's axes, and the loss taken
    before the update, as jax.value_and_grad gives it. The state's blocks
    are updated in place and returned with the step counted."""
    mesh = mesh or make_mesh()

    def step_fn(state: LPTrainState, vectors, counts, capacity, prices, feasible):
        arrays = [np.asarray(vectors, np.float32), np.asarray(counts, np.float32),
                  np.asarray(capacity, np.float32), np.asarray(prices, np.float32),
                  np.asarray(feasible, bool)]
        groups, types = arrays[4].shape
        _check_divides(mesh, groups, types)
        replicas = _replicas(mesh, arrays)

        def part(row, col, index):
            full = replicas[mesh.shard(row, col).device][index]
            rows, columns = block(groups, mesh.shape[0], row), block(types, mesh.shape[1], col)
            if index == 4:
                return full[rows, columns].contiguous()
            return full[rows if index < 2 else columns].contiguous()

        problem = ShardedProblem(*(_grid(mesh, lambda r, c, i=i: part(r, c, i)) for i in range(5)))
        _, demand = _run_steps(mesh, problem, state, 1, final=False)
        # The smooth objective of the state before the update, from its
        # demand: sum_t p * logsumexp_r(20 * D / max(K, 1e-3)) / 20.
        partials = _grid(mesh, lambda r, c: torch.sum(problem.prices[r][c] * torch.logsumexp(
            demand[r][c] / torch.clamp(problem.capacity[r][c], min=1e-3) * 20.0, dim=1) / 20.0))
        loss = collectives.sum_over_types(mesh, partials)[0][0]
        return state._replace(count=state.count + 1), loss

    return step_fn, mesh


# --- constrained [L, G, T] level sharding ------------------------------------
#
# The constrained pack dispatch (ops/pack_kernel.pack_kernel_levels) solves
# every relaxation level at once; levels are independent solves over the same
# fleet, so the mesh splits the L axis over all of its shards (both axes
# flattened, in mesh order). Each shard runs K6 on its block of levels; the
# cross-level selection runs on the host over the shards' small evidence
# (each block's strictest feasible level, its overflow, the per-level
# unschedulable counts, each group's first feasible level), and only the
# chosen level's rounds are fetched from the shard that holds it. A block's
# own selection differs from the global one by a constant (its shortfall is
# measured against its own fullest level), so its argmin is the global
# argmin over its levels, and the decode is bit-identical to the
# single-device dispatch: the per-level math never sees the mesh.


def constrained_level_sharding(mesh: Optional[Mesh] = None):
    """(dispatch, shards) for the constrained [L, G, T] solve over `mesh`:
    dispatch(operands, mode) takes constraints.solve.pad_levels' numpy
    operands and returns the LevelPack as numpy (rounds, chosen_level,
    group_level, level_unsched), as ops/pack_kernel.level_pack_to_host
    gives the single-device one. (None, 1) on a single-shard mesh."""
    mesh = mesh or make_mesh()
    if mesh is None or mesh.size <= 1:
        return None, 1

    def dispatch(operands, mode: str):
        return _level_dispatch(mesh, operands, mode)

    return dispatch, mesh.size


def _level_dispatch(mesh: Mesh, operands: Sequence[np.ndarray], mode: str):
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops.pack_kernel import LevelPack, level_pack_to_host, pack_kernel_levels

    vectors, counts, capacity, total, valid, prices, allow, penalty, conflict, node_cap = operands
    num_levels = counts.shape[0]
    shards = mesh.size
    # Levels past the padded count repeat the last one, as the reference's
    # padding does: identical totals, so the first minimum never lands there.
    levels = pad_multiple(num_levels, shards)
    repeat = np.concatenate([np.arange(num_levels), np.full(levels - num_levels, num_levels - 1)])
    counts, allow, penalty = counts[repeat], allow[repeat], penalty[repeat]
    per = levels // shards
    uploaded = {
        device: upload_packed(
            [vectors, counts, capacity, total, valid, prices, allow, penalty, conflict, node_cap],
            device,
        )
        for device in mesh.devices
    }
    packs = []
    for index, shard in enumerate(mesh.flat):
        full = uploaded[shard.device]
        levels_of = block(levels, shards, index)
        packs.append(pack_kernel_levels(
            full[0], full[1][levels_of], full[2], full[3], full[4], full[5],
            full[6][levels_of], full[7][levels_of], full[8], full[9], mode=mode,
        ))
    # The evidence of every shard in one device->host copy.
    pieces = [
        torch.cat([
            pack.chosen_level.reshape(1).to(torch.int32),
            pack.rounds.overflow.reshape(1).to(torch.int32),
            pack.group_level.reshape(-1).to(torch.int32),
            pack.level_unsched.reshape(-1).to(torch.int32),
        ])
        for pack in packs
    ]
    evidence = torch.cat(collectives.gather_to_first(mesh, pieces)).cpu().numpy()
    groups = vectors.shape[0]
    width = 2 + groups + per * groups
    assigned = counts.astype(np.int64).sum(axis=1)
    shortfall = assigned.max() - assigned
    best = None
    group_level = np.full(groups, num_levels, np.int32)
    unsched = []
    for index in range(shards):
        row = evidence[index * width : (index + 1) * width]
        local, overflow = int(row[0]), int(row[1])
        local_groups = row[2 : 2 + groups]
        level_unsched = row[2 + groups :].reshape(per, groups)
        unsched.append(level_unsched)
        level = index * per + local
        miss = int(level_unsched[local].astype(np.int64).sum()) + int(shortfall[level]) + overflow * 2**30
        if best is None or miss < best[0]:
            best = (miss, index, level)
        found = (local_groups < per) & (group_level == num_levels)
        group_level[found] = index * per + local_groups[found]
    _, chosen_shard, chosen = best
    host = level_pack_to_host(packs[chosen_shard])
    return LevelPack(
        rounds=host.rounds,
        chosen_level=np.int32(chosen),
        group_level=group_level,
        level_unsched=np.concatenate(unsched)[:num_levels],
    )
