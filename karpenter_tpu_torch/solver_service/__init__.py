"""The gRPC solver-plugin boundary — this framework's communication backend
(SURVEY.md §2.7 mandate): the control plane streams densified problem tensors
to a stateless sidecar that owns the accelerator; launch decisions come back
as indices into the fleet the control plane already holds.

Layout:
  solver.proto / solver_pb2  — wire schema (regenerate with `make proto`)
  wire                       — tensor <-> Tensor message codecs
  server                     — the sidecar (python -m karpenter_tpu.solver_service.server)
  client                     — RemoteSolver: Solver impl with greedy fallback
                               + failure blackout (the ICE-cache pattern,
                               ref: aws/instancetypes.go:174-183)
"""


def __getattr__(name):
    # Lazy: submodules import solver_pb2 through this package, so eager
    # client/server imports here would be circular.
    if name == "RemoteSolver":
        from karpenter_tpu_torch.solver_service.client import RemoteSolver

        return RemoteSolver
    if name == "SolverServer":
        from karpenter_tpu_torch.solver_service.server import SolverServer

        return SolverServer
    raise AttributeError(name)
