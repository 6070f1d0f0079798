"""Device-mesh parallelism for solver scale-out.

The port of karpenter_tpu/parallel/: the (pod-groups x instance-types)
score tensor sharded over a [groups, types] mesh of shards in one process
(parallel/mesh.py), with the cross-shard reductions GSPMD inserts in the
reference written out (parallel/collectives.py). The reference's
multi-host lead/follower protocol (parallel/spmd.py, multihost.py) is not
ported: its only entry is the solver sidecar.
"""

from karpenter_tpu_torch.parallel.mesh import make_mesh
from karpenter_tpu_torch.parallel.sharded_solver import sharded_lp_train_step, sharded_lp_solve

__all__ = ["make_mesh", "sharded_lp_train_step", "sharded_lp_solve"]
