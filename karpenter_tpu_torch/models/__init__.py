"""Solver models: the cost solver on the card and the host FFD solvers."""

from karpenter_tpu_torch.models.solver import CostSolver, GreedySolver, NativeSolver, Solver

__all__ = ["CostSolver", "GreedySolver", "NativeSolver", "Solver"]
