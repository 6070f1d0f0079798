"""Solver models: the cost solver on the card, K2 alone (TPUSolver) and the host FFD solvers."""

from karpenter_tpu_torch.models.solver import CostSolver, GreedySolver, NativeSolver, Solver, TPUSolver

__all__ = ["CostSolver", "GreedySolver", "NativeSolver", "Solver", "TPUSolver"]
