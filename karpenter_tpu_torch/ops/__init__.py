"""Tensor kernels and solver primitives: spec encoding, greedy FFD baseline,
the CUDA kernels with their plain PyTorch versions, scoring + LP relaxation."""
