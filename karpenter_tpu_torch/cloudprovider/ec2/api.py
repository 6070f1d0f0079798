"""The EC2-shaped cloud API model — the framework's process boundary to the
cloud control plane.

Ref: the reference talks to AWS through ec2iface.EC2API + ssmiface.SSMAPI
(aws/cloudprovider.go:40-56, aws/ami.go:28). We define the equivalent
boundary as a small typed protocol (`Ec2Api`) with plain dataclasses instead
of the AWS SDK's pointer-heavy request/response structs. Two deliberate
departures from the EC2 wire API:

- `InstanceTypeOffering` carries a price. The reference delegates price choice
  to EC2 Fleet's allocation strategy; our TPU cost solver optimizes projected
  $/hr jointly with packing, so the pricing surface must cross the boundary.
- Pagination is elided: implementations return full lists (the fake is
  in-memory; a real implementation would page internally).

Everything the controllers know about "the cloud" flows through this file, so
a real AWS/GCP binding is one class implementing `Ec2Api`.
"""

from __future__ import annotations

import abc
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

# Setup-resource cache TTL shared by subnet/SG/AMI/launch-template
# discovery (ref: aws/cloudprovider.go:53 CacheTTL 60s).
SETUP_CACHE_TTL = 60.0


def derive_client_token(*parts: str) -> str:
    """Deterministic idempotency token from the logical call's identity.
    Two processes (or one process before and after a crash) issuing the
    same logical call derive the SAME token, so the second execution is a
    server-side no-op instead of a duplicate purchase. 64-char budget per
    the EC2 ClientToken contract; 32 hex chars of SHA-256 is comfortably
    collision-free at fleet-call volumes."""
    digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:32]
    return f"ktpu-{digest}"

# --- Error model (ref: aws/errors.go:22-43) --------------------------------

INSUFFICIENT_CAPACITY_ERROR_CODE = "InsufficientInstanceCapacity"

_NOT_FOUND_CODES = frozenset(
    {
        "InvalidInstanceID.NotFound",
        "InvalidLaunchTemplateName.NotFoundException",
        "InvalidLaunchTemplateId.NotFound",
        "ParameterNotFound",
    }
)


class ApiError(Exception):
    """A coded cloud-API error (ref: awserr.Error)."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code
        self.api_message = message


def is_not_found(error: Optional[BaseException]) -> bool:
    """Ref: aws/errors.go isNotFound:28-39."""
    return isinstance(error, ApiError) and error.code in _NOT_FOUND_CODES


# --- Catalog / discovery types ---------------------------------------------


@dataclass(frozen=True)
class InstanceTypeInfo:
    """Raw instance-type record (ref: ec2.InstanceTypeInfo as consumed by
    aws/instancetype.go). Memory is the *machine* size; the adapter applies
    the VM-available factor."""

    name: str
    vcpus: int
    memory_mib: int
    architectures: Sequence[str] = ("x86_64",)
    supported_usage_classes: Sequence[str] = ("on-demand", "spot")
    # ENI model for the pods-per-node formula (instancetype.go:72-77).
    max_network_interfaces: int = 4
    ipv4_addresses_per_interface: int = 15
    nvidia_gpus: int = 0
    amd_gpus: int = 0
    neurons: int = 0
    tpus: int = 0
    pod_eni_branch_interfaces: int = 0
    bare_metal: bool = False
    fpga: bool = False
    supported_virtualization_types: Sequence[str] = ("hvm",)
    # On-demand list price, $/hr (price surface; see module docstring).
    price_on_demand: float = 0.0


@dataclass(frozen=True)
class InstanceTypeOffering:
    """One purchasable (type, zone, capacity-type) with its current price
    (ref: ec2.InstanceTypeOffering from DescribeInstanceTypeOfferings,
    aws/instancetypes.go:106-126, extended with price)."""

    instance_type: str
    zone: str
    capacity_type: str
    price: float = 0.0


@dataclass(frozen=True)
class Subnet:
    subnet_id: str
    zone: str
    tags: Mapping[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class SecurityGroup:
    group_id: str
    tags: Mapping[str, str] = field(default_factory=dict)


# --- Launch types ----------------------------------------------------------


@dataclass(frozen=True)
class LaunchTemplate:
    name: str
    template_id: str = ""
    image_id: str = ""
    instance_profile: str = ""
    security_group_ids: Sequence[str] = ()
    user_data: str = ""
    tags: Mapping[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class FleetOverride:
    """One (instance type, subnet) candidate in a fleet request
    (ref: ec2.FleetLaunchTemplateOverridesRequest, aws/instance.go:173-207).
    Zone is recorded redundantly so capacity errors can name the zone without
    a subnet lookup; priority orders spot candidates (smallest first)."""

    instance_type: str
    subnet_id: str
    zone: str
    priority: Optional[float] = None


@dataclass
class FleetRequest:
    """Ref: ec2.CreateFleetInput (instance.go:116-133). type=instant
    semantics: the call synchronously returns launched ids + per-pool
    errors; partial fulfillment is allowed.

    `client_token` is the EC2 idempotency token. Empty = the binding mints
    a random one per logical call (retries of that call still reuse it).
    Callers that need RESTART idempotency (a re-issued launch after a crash
    or ambiguous 5xx must be a server-side no-op) derive it deterministically
    from the launch content — see instances.InstanceProvider._launch."""

    launch_template_name: str
    overrides: List[FleetOverride]
    capacity_type: str
    quantity: int
    tags: Dict[str, str] = field(default_factory=dict)
    client_token: str = ""

    def idempotency_payload(self) -> str:
        """Canonical serialization of everything EC2 compares under a reused
        ClientToken. Token derivation (instances._launch) and the fake's
        IdempotentParameterMismatch check both key on this one method, so
        the two sides of the contract cannot drift apart."""
        rows = sorted(
            f"{o.instance_type}/{o.subnet_id}/{o.zone}/{o.priority}"
            for o in self.overrides
        )
        tags = sorted(f"{k}={v}" for k, v in self.tags.items())
        return "|".join(
            [self.launch_template_name, self.capacity_type, str(self.quantity)]
            + rows
            + tags
        )


@dataclass(frozen=True)
class FleetError:
    """Per-pool launch failure (ref: ec2.CreateFleetError)."""

    code: str
    message: str
    instance_type: str = ""
    zone: str = ""


@dataclass
class FleetResult:
    instance_ids: List[str] = field(default_factory=list)
    errors: List[FleetError] = field(default_factory=list)


@dataclass(frozen=True)
class QueueMessage:
    """One message from the cluster's interruption queue (ref: the reference
    ecosystem's interruption controller consumes an SQS queue fed by
    EventBridge rules for spot-interruption-warning, rebalance-recommendation
    and instance-state-change). `body` is the raw EventBridge JSON envelope;
    `receipt_handle` is the delete token — a message stays re-deliverable
    (visibility timeout) until deleted, which is what makes the interruption
    pipeline crash-consistent: record first, delete after."""

    message_id: str
    receipt_handle: str
    body: str


@dataclass(frozen=True)
class SpotPrice:
    """One DescribeSpotPriceHistory row: the spot $/hr one pool advertised
    at `timestamp` (epoch seconds). The market feed sorts rows into a
    strictly-ordered tick stream — the poll IS the replayable history, so
    the controller's PriceBook can always re-fold from zero."""

    instance_type: str
    zone: str
    price: float
    timestamp: float = 0.0


@dataclass(frozen=True)
class Instance:
    """Ref: ec2.Instance fields read by instanceToNode (instance.go:232-268).
    `tags` and `launched_at` (epoch seconds, 0.0 = unknown) feed the
    leaked-capacity GC's by-cluster-tag listing."""

    instance_id: str
    instance_type: str
    zone: str
    private_dns_name: str = ""
    image_id: str = ""
    architecture: str = "x86_64"
    spot: bool = False
    state: str = "running"
    tags: Mapping[str, str] = field(default_factory=dict)
    launched_at: float = 0.0


# --- The boundary ----------------------------------------------------------


class Ec2Api(abc.ABC):
    """Everything the provider stack may ask of the cloud. One RPC-ish method
    per EC2/SSM call the reference makes."""

    @abc.abstractmethod
    def describe_instance_types(self) -> List[InstanceTypeInfo]:
        ...

    @abc.abstractmethod
    def describe_instance_type_offerings(self) -> List[InstanceTypeOffering]:
        ...

    @abc.abstractmethod
    def describe_subnets(self, filters: Mapping[str, str]) -> List[Subnet]:
        """filters: tag-key -> value, value "*" = key existence only
        (ref: aws/subnets.go getFilters:52-69)."""

    @abc.abstractmethod
    def describe_security_groups(self, filters: Mapping[str, str]) -> List[SecurityGroup]:
        ...

    @abc.abstractmethod
    def describe_launch_template(self, name: str) -> LaunchTemplate:
        """Raises ApiError(NotFound) when absent."""

    @abc.abstractmethod
    def create_launch_template(self, template: LaunchTemplate) -> LaunchTemplate:
        ...

    @abc.abstractmethod
    def create_fleet(self, request: FleetRequest) -> FleetResult:
        ...

    @abc.abstractmethod
    def describe_instances(self, instance_ids: Sequence[str]) -> List[Instance]:
        ...

    @abc.abstractmethod
    def describe_instances_by_tag(
        self, filters: Mapping[str, str]
    ) -> List[Instance]:
        """Every instance matching a tag selector (same filter grammar as
        describe_subnets), terminated ones included with their state — the
        leaked-capacity GC's DescribeInstances-by-cluster-tag sweep."""

    @abc.abstractmethod
    def terminate_instances(self, instance_ids: Sequence[str]) -> None:
        ...

    @abc.abstractmethod
    def get_ami_parameter(self, path: str) -> str:
        """SSM GetParameter for AMI discovery (ref: aws/ami.go:62-72).
        Raises ApiError(ParameterNotFound) when absent."""

    def receive_queue_messages(self) -> List[QueueMessage]:
        """Poll the cluster's interruption queue (SQS ReceiveMessage).
        Messages remain re-deliverable until delete_queue_message — the
        at-least-once contract the interruption controller's record-then-ack
        discipline depends on. Default: no queue configured, nothing to
        receive."""
        return []

    def delete_queue_message(self, receipt_handle: str) -> None:
        """Ack one received message (SQS DeleteMessage). Deleting an unknown
        or already-deleted handle is success."""

    def describe_spot_price_history(self) -> List[SpotPrice]:
        """Spot price history for this account's pools (EC2
        DescribeSpotPriceHistory), oldest-first is NOT guaranteed — callers
        sort. Default: no spot-price feed, the market controller is inert."""
        return []


def match_tags(tags: Mapping[str, str], filters: Mapping[str, str]) -> bool:
    """Evaluate a tag-selector against a resource's tags. Empty filters match
    nothing-specified = everything (callers decide whether empty is legal)."""
    for key, value in filters.items():
        if key not in tags:
            return False
        if value not in ("*", "") and tags[key] != value:
            return False
    return True
