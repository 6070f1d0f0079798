"""Well-known label vocabulary and framework constants.

Ref: pkg/apis/provisioning/v1alpha5/register.go:34-68 — the reference defines a
closed vocabulary of node labels that Requirements may constrain, plus
framework-owned annotations/taints/finalizers. We keep the same public names so
specs written for the reference remain meaningful, and add TPU-relevant
accelerator resource names.
"""

# API group (ours).
GROUP = "karpenter.tpu"

# --- Node label keys (the closed well-known set) ---------------------------
ZONE_LABEL = "topology.kubernetes.io/zone"
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
ARCH_LABEL = "kubernetes.io/arch"
OS_LABEL = "kubernetes.io/os"
HOSTNAME_LABEL = "kubernetes.io/hostname"
CAPACITY_TYPE_LABEL = "karpenter.sh/capacity-type"
PROVISIONER_NAME_LABEL = "karpenter.sh/provisioner-name"

WELL_KNOWN_LABELS = frozenset(
    {
        ZONE_LABEL,
        INSTANCE_TYPE_LABEL,
        ARCH_LABEL,
        OS_LABEL,
        HOSTNAME_LABEL,
        CAPACITY_TYPE_LABEL,
        PROVISIONER_NAME_LABEL,
    }
)

# Label domains users may not set directly on a Provisioner
# (ref: v1alpha5/register.go RestrictedLabels).
RESTRICTED_LABEL_DOMAINS = frozenset(
    {
        "kubernetes.io",
        "k8s.io",
        "karpenter.sh",
        GROUP,
    }
)
# Exceptions: well-known labels are settable via Requirements even though their
# domains are restricted for arbitrary labels.
RESTRICTED_LABEL_EXCEPTIONS = WELL_KNOWN_LABELS

# --- Capacity types --------------------------------------------------------
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_SPOT = "spot"

# --- Framework-owned markers ----------------------------------------------
NOT_READY_TAINT_KEY = "karpenter.sh/not-ready"
TERMINATION_FINALIZER = "karpenter.sh/termination"
DO_NOT_EVICT_ANNOTATION = "karpenter.sh/do-not-evict"
EMPTINESS_TIMESTAMP_ANNOTATION = "karpenter.sh/emptiness-timestamp"
# Interruption intent, stamped onto the victim Node BEFORE the provider event
# is acked — the durable record a restarted controller resumes the drain from
# (controllers/interruption.py).
INTERRUPTION_KIND_ANNOTATION = "karpenter.sh/interruption-kind"
INTERRUPTION_DEADLINE_ANNOTATION = "karpenter.sh/interruption-deadline"
# Bumped every time a pod is displaced back to pending (interruption drain).
# Part of the launch identity: a displaced pod's replacement launch must be a
# DIFFERENT logical launch than the purchase that backed its old node, or a
# restart-idempotent provider would "adopt" the dying instance and rebind the
# pod onto the node being reclaimed.
RESCHEDULE_EPOCH_ANNOTATION = "karpenter.sh/reschedule-epoch"
# Consolidation intent ("delete" | "replace"), stamped onto the victim Node
# BEFORE any pod is displaced — the durable record a restarted controller
# resumes the drain from (controllers/consolidation.py). Doubles as the
# in-flight marker that caps concurrent voluntary disruption.
CONSOLIDATION_ACTION_ANNOTATION = "karpenter.sh/consolidation-action"
# The canonical hash of the owning Provisioner's constraint envelope, stamped
# at node registration (controllers/provisioning.py) and back-filled on
# legacy/adopted nodes by the node reconciler — never treated as drift while
# missing. The drift sweep compares it against the CURRENT spec hash
# (karpenter_tpu/drift/).
PROVISIONER_HASH_ANNOTATION = "karpenter.sh/provisioner-hash"
# Drift intent (the drift KIND: "spec" | "provider" | "expired"), stamped onto
# the victim Node BEFORE any pod is displaced — the durable record a restarted
# controller resumes the rolling replacement from (controllers/drift.py).
# Doubles as the in-flight marker the shared disruption ledger counts.
DRIFT_ACTION_ANNOTATION = "karpenter.sh/drift-action"

# --- Resource names --------------------------------------------------------
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_NVIDIA_GPU = "nvidia.com/gpu"
RESOURCE_AMD_GPU = "amd.com/gpu"
RESOURCE_AWS_NEURON = "aws.amazon.com/neuron"
RESOURCE_AWS_POD_ENI = "vpc.amazonaws.com/pod-eni"
RESOURCE_GOOGLE_TPU = "google.com/tpu"

# Accelerator resources: a pod requesting any of these must land on an
# instance type that offers it, and instance types offering them are avoided
# for pods that don't (anti-waste; ref: binpacking/packable.go:220-246).
ACCELERATOR_RESOURCES = (
    RESOURCE_NVIDIA_GPU,
    RESOURCE_AMD_GPU,
    RESOURCE_AWS_NEURON,
    RESOURCE_GOOGLE_TPU,
)

# The dense-resource dimension order used by every tensor kernel.
# Units chosen so float32 stays exact over realistic magnitudes:
# cpu in millicores, memory in MiB, counts for everything else.
RESOURCE_DIMS = (
    RESOURCE_CPU,          # millicores
    RESOURCE_MEMORY,       # MiB
    RESOURCE_PODS,         # count
    RESOURCE_NVIDIA_GPU,   # count
    RESOURCE_AMD_GPU,      # count
    RESOURCE_AWS_NEURON,   # count
    RESOURCE_GOOGLE_TPU,   # count
    RESOURCE_AWS_POD_ENI,  # count
)
RESOURCE_DIM_INDEX = {name: i for i, name in enumerate(RESOURCE_DIMS)}
NUM_RESOURCE_DIMS = len(RESOURCE_DIMS)

# Scaling applied when densifying a ResourceList into the RESOURCE_DIMS vector.
CPU_SCALE = 1000.0       # cores -> millicores
MEMORY_SCALE = 1.0 / (1024.0 * 1024.0)  # bytes -> MiB
