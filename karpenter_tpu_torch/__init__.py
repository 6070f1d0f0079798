"""karpenter_tpu_torch — the provisioning solver of karpenter_tpu in PyTorch,
with hand-written CUDA kernels for one NVIDIA Hopper card (sm_90a).

The JAX package `karpenter_tpu` is the reference: every module here is held
against its counterpart on the same inputs. The port imports nothing of it
(nor of JAX); where it needs a host module it keeps its own copy.

Layout (a module's counterpart in the reference has the same name):
  api/            typed spec model: pods, provisioner constraints, requirements
  cloudprovider/  InstanceType / Offering
  ops/            encode, host FFD, native host kernels, the column-LP mix;
                  K1 dominance pricing (cuda_kernels), K2 the pack round loop
                  and plan compaction (pack_kernel), K3 the LP relaxation
                  (score_kernel); csrc/ holds the CUDA and host C++ sources
  models/         the solvers: CostSolver and the host FFD solvers
  device.py       the one device verdict: the card unless "cpu" is asked for
  convert.py      the encoded problem between numpy and torch
"""

__version__ = "0.1.0"
