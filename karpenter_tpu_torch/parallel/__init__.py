"""Device-mesh parallelism for solver scale-out.

The port of karpenter_tpu/parallel/: the (pod-groups x instance-types)
score tensor sharded over a [groups, types] mesh of shards
(parallel/mesh.py), with the cross-shard reductions GSPMD inserts in the
reference written out (parallel/collectives.py). A mesh may span the
processes of a torch.distributed group (parallel/multihost.py): rank 0
leads each sharded solve and the other ranks follow it through the
lead/follower protocol of parallel/spmd.py, whose entry on rank 0 is the
production solve itself (models/solver._dispatch_sharded).
"""

from karpenter_tpu_torch.parallel.mesh import make_mesh
from karpenter_tpu_torch.parallel.sharded_solver import sharded_lp_train_step, sharded_lp_solve

__all__ = ["make_mesh", "sharded_lp_train_step", "sharded_lp_solve"]
