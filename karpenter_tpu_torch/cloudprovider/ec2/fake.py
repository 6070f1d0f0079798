"""In-memory fake of the EC2-shaped API, with fault injection.

Ref: pkg/cloudprovider/aws/fake/ec2api.go — records CreateFleet /
CreateLaunchTemplate inputs, simulates instances, injects
InsufficientInstanceCapacity per (type, zone, capacity-type) pool, and ships
a canned instance-type table (ec2api.go:214-388). fake/ssmapi.go fakes AMI
parameters. This fake is the test double for the whole provider stack and
the default backend when no real cloud is configured.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
from dataclasses import replace
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from karpenter_tpu_torch.cloudprovider.ec2.api import (
    INSUFFICIENT_CAPACITY_ERROR_CODE,
    ApiError,
    Ec2Api,
    FleetError,
    FleetRequest,
    FleetResult,
    Instance,
    InstanceTypeInfo,
    InstanceTypeOffering,
    LaunchTemplate,
    QueueMessage,
    SecurityGroup,
    SpotPrice,
    Subnet,
    match_tags,
)

ZONES = ("test-zone-1a", "test-zone-1b", "test-zone-1c")

SPOT_DISCOUNT = 0.6  # flat fake spot market: spot = 60% of on-demand


def default_instance_type_infos() -> List[InstanceTypeInfo]:
    """Canned table (ref: fake/ec2api.go:214-388): general purpose sizes,
    burstable, GPU, neuron, ARM, pod-ENI trunking, plus rows the opinionated
    filter must drop (bare metal, FPGA, unsupported family)."""
    return [
        InstanceTypeInfo(
            name="m5.large", vcpus=2, memory_mib=8 * 1024, price_on_demand=0.096,
            max_network_interfaces=3, ipv4_addresses_per_interface=10,
        ),
        InstanceTypeInfo(
            name="m5.xlarge", vcpus=4, memory_mib=16 * 1024, price_on_demand=0.192,
            max_network_interfaces=4, ipv4_addresses_per_interface=15,
        ),
        InstanceTypeInfo(
            name="m5.2xlarge", vcpus=8, memory_mib=32 * 1024, price_on_demand=0.384,
            max_network_interfaces=4, ipv4_addresses_per_interface=15,
        ),
        InstanceTypeInfo(
            name="c5.large", vcpus=2, memory_mib=4 * 1024, price_on_demand=0.085,
            max_network_interfaces=3, ipv4_addresses_per_interface=10,
        ),
        InstanceTypeInfo(
            name="r5.large", vcpus=2, memory_mib=16 * 1024, price_on_demand=0.126,
            max_network_interfaces=3, ipv4_addresses_per_interface=10,
        ),
        InstanceTypeInfo(
            name="t3.medium", vcpus=2, memory_mib=4 * 1024, price_on_demand=0.0416,
            max_network_interfaces=3, ipv4_addresses_per_interface=6,
        ),
        InstanceTypeInfo(
            name="p3.8xlarge", vcpus=32, memory_mib=244 * 1024, price_on_demand=12.24,
            nvidia_gpus=4, max_network_interfaces=8, ipv4_addresses_per_interface=30,
        ),
        InstanceTypeInfo(
            name="g4dn.8xlarge", vcpus=32, memory_mib=128 * 1024, price_on_demand=2.176,
            nvidia_gpus=1, max_network_interfaces=4, ipv4_addresses_per_interface=15,
        ),
        InstanceTypeInfo(
            name="inf1.6xlarge", vcpus=24, memory_mib=48 * 1024, price_on_demand=1.18,
            neurons=4, max_network_interfaces=8, ipv4_addresses_per_interface=30,
        ),
        InstanceTypeInfo(
            name="m6g.large", vcpus=2, memory_mib=8 * 1024, price_on_demand=0.077,
            architectures=("arm64",), max_network_interfaces=3,
            ipv4_addresses_per_interface=10,
        ),
        InstanceTypeInfo(
            name="m5.metal", vcpus=96, memory_mib=384 * 1024, price_on_demand=4.608,
            bare_metal=True, max_network_interfaces=15,
            ipv4_addresses_per_interface=50,
        ),
        InstanceTypeInfo(
            name="f1.2xlarge", vcpus=8, memory_mib=122 * 1024, price_on_demand=1.65,
            fpga=True,
        ),
        InstanceTypeInfo(
            name="d3.xlarge", vcpus=4, memory_mib=32 * 1024, price_on_demand=0.499,
        ),
        # Pod-ENI / trunking capable (security-groups-for-pods).
        InstanceTypeInfo(
            name="m5.4xlarge", vcpus=16, memory_mib=64 * 1024, price_on_demand=0.768,
            max_network_interfaces=8, ipv4_addresses_per_interface=30,
            pod_eni_branch_interfaces=54,
        ),
    ]


class FakeEc2(Ec2Api):
    """Thread-safe in-memory cloud. All mutating calls are recorded for
    assertions (ref: fake/ec2api.go CalledWithCreateFleetInput etc.)."""

    def __init__(
        self,
        instance_type_infos: Optional[List[InstanceTypeInfo]] = None,
        zones: Sequence[str] = ZONES,
        cluster_name: str = "test-cluster",
    ):
        self.zones = tuple(zones)
        self.instance_type_infos = (
            default_instance_type_infos()
            if instance_type_infos is None
            else list(instance_type_infos)
        )
        cluster_tag = f"kubernetes.io/cluster/{cluster_name}"
        self.subnets: List[Subnet] = [
            Subnet(
                subnet_id=f"subnet-{i + 1}",
                zone=zone,
                tags={cluster_tag: "owned", "Name": f"private-{zone}"},
            )
            for i, zone in enumerate(self.zones)
        ]
        self.security_groups: List[SecurityGroup] = [
            SecurityGroup(group_id="sg-test1", tags={cluster_tag: "owned"}),
            SecurityGroup(group_id="sg-test2", tags={cluster_tag: "owned"}),
            SecurityGroup(group_id="sg-test3", tags={"other-tag": "yes"}),
        ]
        self.ami_parameters: Dict[str, str] = {}  # path -> ami id; see get_ami_parameter
        # Fault injection: pools that report InsufficientInstanceCapacity
        # (ref: fake/ec2api.go InsufficientCapacityPools:54).
        self.insufficient_capacity_pools: Set[Tuple[str, str, str]] = set()

        self.launch_templates: Dict[str, LaunchTemplate] = {}
        self.instances: Dict[str, Instance] = {}
        # Terminated instances stay DESCRIBABLE with state="terminated",
        # exactly like EC2 (corpses linger in DescribeInstances for about an
        # hour): the launch path's liveness filter and corpse-replay
        # recovery only exist on the real wire surface, so the fake must
        # not hide dead instances for them to be testable.
        self.corpses: Dict[str, Instance] = {}
        # ClientToken -> (request fingerprint, instance ids) of the fleet
        # that token bought. A repeated token replays those ids instead of
        # launching again — INCLUDING since-terminated ones, which is what
        # EC2 does (idempotency replays the recorded result, not a liveness
        # check) — the server-side half of restart-safe launches. A reused
        # token with DIFFERENT request parameters is rejected, also like
        # EC2 (IdempotentParameterMismatch).
        self._fleet_tokens: Dict[str, Tuple[str, List[str]]] = {}
        # Injectable interruption queue: receipt_handle -> message, delivered
        # until deleted (the SQS visibility model, so record-then-ack crash
        # consistency is testable against this fake too).
        self.interruption_messages: Dict[str, QueueMessage] = {}
        # Injectable spot-price history (DescribeSpotPriceHistory rows):
        # append-only, re-served in full on every poll — the replayable
        # cursorless history the market controller re-folds after a restart.
        self.spot_price_history: List[SpotPrice] = []
        self.calls: Dict[str, List] = {
            "create_fleet": [],
            "create_launch_template": [],
            "terminate_instances": [],
            "delete_queue_message": [],
        }
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    # --- discovery ---------------------------------------------------------

    def describe_instance_types(self) -> List[InstanceTypeInfo]:
        return list(self.instance_type_infos)

    def describe_instance_type_offerings(self) -> List[InstanceTypeOffering]:
        offerings = []
        for info in self.instance_type_infos:
            for zone in self.zones:
                for capacity_type in info.supported_usage_classes:
                    price = info.price_on_demand
                    if capacity_type == "spot":
                        price *= SPOT_DISCOUNT
                    offerings.append(
                        InstanceTypeOffering(
                            instance_type=info.name,
                            zone=zone,
                            capacity_type=capacity_type,
                            price=price,
                        )
                    )
        return offerings

    def inject_spot_price(
        self, instance_type: str, zone: str, price: float, timestamp: float = 0.0
    ) -> SpotPrice:
        """Test hook: append one DescribeSpotPriceHistory row."""
        row = SpotPrice(
            instance_type=instance_type,
            zone=zone,
            price=price,
            timestamp=timestamp,
        )
        self.spot_price_history.append(row)
        return row

    def describe_spot_price_history(self) -> List[SpotPrice]:
        return list(self.spot_price_history)

    def describe_subnets(self, filters: Mapping[str, str]) -> List[Subnet]:
        return [s for s in self.subnets if match_tags(s.tags, filters)]

    def describe_security_groups(self, filters: Mapping[str, str]) -> List[SecurityGroup]:
        return [g for g in self.security_groups if match_tags(g.tags, filters)]

    # --- launch templates --------------------------------------------------

    def describe_launch_template(self, name: str) -> LaunchTemplate:
        with self._lock:
            if name not in self.launch_templates:
                raise ApiError("InvalidLaunchTemplateName.NotFoundException", name)
            return self.launch_templates[name]

    def create_launch_template(self, template: LaunchTemplate) -> LaunchTemplate:
        with self._lock:
            created = LaunchTemplate(
                name=template.name,
                template_id=f"lt-{next(self._ids):08d}",
                image_id=template.image_id,
                instance_profile=template.instance_profile,
                security_group_ids=tuple(template.security_group_ids),
                user_data=template.user_data,
                tags=dict(template.tags),
            )
            self.launch_templates[template.name] = created
            self.calls["create_launch_template"].append(created)
            return created

    # --- fleet -------------------------------------------------------------

    def create_fleet(self, request: FleetRequest) -> FleetResult:
        """Instant-fleet semantics: walk override pools in priority order,
        launching until quantity is met; ICE pools contribute errors instead
        (ref: fake/ec2api.go CreateFleetWithContext:90-136)."""
        with self._lock:
            self.calls["create_fleet"].append(request)
            if request.launch_template_name not in self.launch_templates:
                raise ApiError(
                    "InvalidLaunchTemplateName.NotFoundException",
                    request.launch_template_name,
                )
            if request.client_token and request.client_token in self._fleet_tokens:
                fingerprint, replay = self._fleet_tokens[request.client_token]
                if fingerprint != request.idempotency_payload():
                    raise ApiError(
                        "IdempotentParameterMismatch",
                        "client token reused with different parameters",
                    )
                return FleetResult(instance_ids=list(replay))
            template = self.launch_templates[request.launch_template_name]
            result = FleetResult()
            pools = sorted(
                request.overrides,
                key=lambda o: o.priority if o.priority is not None else 0.0,
            )
            seen_bad: Set[Tuple[str, str, str]] = set()
            usable = []
            for override in pools:
                pool = (override.instance_type, override.zone, request.capacity_type)
                if pool in self.insufficient_capacity_pools:
                    if pool not in seen_bad:
                        seen_bad.add(pool)
                        result.errors.append(
                            FleetError(
                                code=INSUFFICIENT_CAPACITY_ERROR_CODE,
                                message=f"no capacity in pool {pool}",
                                instance_type=override.instance_type,
                                zone=override.zone,
                            )
                        )
                    continue
                usable.append(override)
            if not usable:
                return result
            for n in range(request.quantity):
                override = usable[n % len(usable)] if request.capacity_type == "spot" else usable[0]
                instance_id = f"i-{next(self._ids):017d}"
                info = self._info(override.instance_type)
                instance = Instance(
                    instance_id=instance_id,
                    instance_type=override.instance_type,
                    zone=override.zone,
                    private_dns_name=f"ip-192-168-{(next(self._ids)) % 256}-{n % 256}."
                    f"{override.zone}.compute.internal",
                    image_id=template.image_id,
                    architecture=info.architectures[0] if info else "x86_64",
                    spot=request.capacity_type == "spot",
                    tags=dict(request.tags),
                )
                self.instances[instance_id] = instance
                result.instance_ids.append(instance_id)
            if request.client_token:
                self._fleet_tokens[request.client_token] = (
                    request.idempotency_payload(),
                    list(result.instance_ids),
                )
            return result

    def _info(self, name: str) -> Optional[InstanceTypeInfo]:
        for info in self.instance_type_infos:
            if info.name == name:
                return info
        return None

    # --- instances ---------------------------------------------------------

    def describe_instances(self, instance_ids: Sequence[str]) -> List[Instance]:
        with self._lock:
            known = {**self.corpses, **self.instances}
            missing = [i for i in instance_ids if i not in known]
            if missing:
                raise ApiError("InvalidInstanceID.NotFound", ",".join(missing))
            return [known[i] for i in instance_ids]

    def describe_instances_by_tag(
        self, filters: Mapping[str, str]
    ) -> List[Instance]:
        # Corpses show up here too — callers (the leaked-capacity GC's
        # listing) are expected to filter on state, as with real EC2.
        with self._lock:
            return [
                instance
                for instance in list(self.instances.values())
                + list(self.corpses.values())
                if match_tags(instance.tags, filters)
            ]

    def terminate_instances(self, instance_ids: Sequence[str]) -> None:
        with self._lock:
            self.calls["terminate_instances"].append(list(instance_ids))
            for instance_id in instance_ids:
                if instance_id in self.corpses:
                    continue  # terminating a terminated instance is a no-op
                if instance_id not in self.instances:
                    raise ApiError("InvalidInstanceID.NotFound", instance_id)
                live = self.instances.pop(instance_id)
                self.corpses[instance_id] = replace(live, state="terminated")

    # --- interruption queue --------------------------------------------------

    def inject_interruption_message(
        self, detail_type: str, instance_id: str, time_iso: str = "",
        detail: Optional[Dict] = None,
    ) -> QueueMessage:
        """Enqueue an EventBridge-shaped notice (the exact envelope the real
        queue carries) for the interruption poll to consume."""
        body = {
            "version": "0",
            "detail-type": detail_type,
            "source": "aws.ec2",
            "time": time_iso,
            "detail": {"instance-id": instance_id, **(detail or {})},
        }
        with self._lock:
            handle = f"rh-{next(self._ids):08d}"
            message = QueueMessage(
                message_id=f"mid-{handle}",
                receipt_handle=handle,
                body=json.dumps(body),
            )
            self.interruption_messages[handle] = message
            return message

    def receive_queue_messages(self) -> List[QueueMessage]:
        with self._lock:
            return list(self.interruption_messages.values())

    def delete_queue_message(self, receipt_handle: str) -> None:
        with self._lock:
            self.calls["delete_queue_message"].append(receipt_handle)
            self.interruption_messages.pop(receipt_handle, None)

    # --- ssm ---------------------------------------------------------------

    def get_ami_parameter(self, path: str) -> str:
        """Any recommended-image path resolves (ref: fake/ssmapi.go returns a
        deterministic fake AMI per parameter); explicit entries win."""
        if path in self.ami_parameters:
            return self.ami_parameters[path]
        if "recommended/image_id" in path:
            digest = hashlib.sha256(path.encode()).hexdigest()[:12]
            return f"ami-{digest}"
        raise ApiError("ParameterNotFound", path)
