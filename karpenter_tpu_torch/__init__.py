"""karpenter_tpu_torch — the provisioning solver of karpenter_tpu in PyTorch,
with hand-written CUDA kernels for one NVIDIA Hopper card (sm_90a).

The JAX package `karpenter_tpu` is the reference: every module here is held
against its counterpart on the same inputs. The port imports nothing of it
(nor of JAX); where it needs a host module it keeps its own copy.

Layout (a module's counterpart in the reference has the same name):
  api/            typed spec model: pods, provisioner constraints, requirements,
                  validation
  cloudprovider/  InstanceType / Offering, the fake cloud provider, the spot
                  market's allocation model
  ops/            encode, host FFD, native host kernels, the column-LP mix;
                  K1 dominance pricing (cuda_kernels), K2 the pack round loop,
                  plan compaction and K6 the constrained [L, G, T] dispatch
                  (pack_kernel), K3 the LP relaxation (score_kernel), K7 the
                  consolidation counterfactual (consolidate_kernel), K8 the
                  incremental encode (incremental), K10 the forecast penalty
                  (forecast_kernel); csrc/ holds the CUDA and host C++
                  sources
  constraints/    the constraint compiler, its relaxation ladder, the numpy
                  mirror of K6 and the constrained solve
  controllers/    the cluster store, the scheduler that groups pods into
                  schedules, and the provisioning, selection and market
                  controllers (copies of the reference's host modules)
  market/         the spot market's tick feed, the PriceBook that folds it,
                  and the interruption forecast
  drift/          the provisioner spec hash stamped on new nodes
  utils/          logging, metrics, clocks, crash and fault points, write
                  fences, tracing, the pod-latency tracker, options
  models/         the solvers (CostSolver, TPUSolver, the host FFD solvers)
                  and the incremental encode's device state
  runtime.py      make_solver and the Manager that wires the controllers
  device.py       the one device verdict: the card unless "cpu" is asked for
  convert.py      the encoded problem between numpy and torch
"""

__version__ = "0.1.0"
