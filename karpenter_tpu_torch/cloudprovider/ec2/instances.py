"""Instance launch/terminate through the fleet API.

Ref: pkg/cloudprovider/aws/instance.go — capacity-type choice (spot iff
allowed and offered), launch-template config assembly, the
(instance type × zone × subnet) override cross-product with spot priority,
instant-fleet launch with partial-fulfillment tolerance, recording
insufficient-capacity pools into the blackout cache, eventually-consistent
describe with retry, and instance → node conversion.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider import (
    CloudProviderError,
    InstanceType,
    NodeSpec,
)
from karpenter_tpu_torch.cloudprovider.ec2.api import (
    INSUFFICIENT_CAPACITY_ERROR_CODE,
    Ec2Api,
    FleetOverride,
    FleetRequest,
    FleetResult,
    Instance,
    derive_client_token,
    is_not_found,
)
from karpenter_tpu_torch.cloudprovider.ec2.instancetypes import InstanceTypeProvider
from karpenter_tpu_torch.cloudprovider.ec2.launchtemplates import LaunchTemplateProvider
from karpenter_tpu_torch.cloudprovider.ec2.network import SubnetProvider
from karpenter_tpu_torch.cloudprovider.ec2.vendor import Ec2Provider, merge_tags
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK
from karpenter_tpu_torch.utils.crashpoints import crashpoint

DESCRIBE_RETRY_ATTEMPTS = 3  # ref: instance.go:57-61
DESCRIBE_RETRY_DELAY = 1.0

# States in which the instance is not (or will not stay) usable capacity.
# EC2 keeps terminated instances DESCRIBABLE for about an hour, and a
# ClientToken replay hands back the ORIGINAL instance ids regardless of
# their state — so adoption must filter on liveness or it would register
# Nodes backed by corpses.
DEAD_INSTANCE_STATES = frozenset(
    {"shutting-down", "terminated", "stopping", "stopped"}
)

# When a replayed token yields ONLY corpses (controller down past the GC
# grace: the sweep terminated the orphans, then the restart re-issued the
# launch), the launch walks to the next token generation and buys fresh.
# The walk is deterministic — generation g derives from (launch_id, g) — so
# a crash mid-walk replays the same sequence. The cap bounds the pathology
# of every prior generation having been bought and reaped.
MAX_LAUNCH_GENERATIONS = 4

PROVIDER_ID_FORMAT = "aws:///{zone}/{instance_id}"


class FleetLaunchError(CloudProviderError):
    """CreateFleet produced zero instances (ref: instance.go
    combineFleetErrors:302-311)."""

    def __init__(self, errors):
        unique = sorted({f"{e.code}: {e.message}" for e in errors})
        super().__init__(
            "with fleet error(s), " + ("; ".join(unique) or "no usable capacity pools")
        )
        self.fleet_errors = list(errors)


class InstanceProvider:
    """Ref: aws/instance.go InstanceProvider:38-146."""

    def __init__(
        self,
        api: Ec2Api,
        instance_type_provider: InstanceTypeProvider,
        subnet_provider: SubnetProvider,
        launch_template_provider: LaunchTemplateProvider,
        cluster_name: str,
        clock: Optional[Clock] = None,
    ):
        self.api = api
        self.instance_type_provider = instance_type_provider
        self.subnet_provider = subnet_provider
        self.launch_template_provider = launch_template_provider
        self.cluster_name = cluster_name
        self.clock = clock or SYSTEM_CLOCK

    def create(
        self,
        constraints: Constraints,
        provider: Ec2Provider,
        instance_types: Sequence[InstanceType],
        quantity: int,
        pool_options=None,
        launch_id: Optional[str] = None,
    ) -> List[NodeSpec]:
        """Launch up to `quantity` nodes; partial fulfillment returns fewer
        (ref: instance.go Create:49-89). instance_types should be sorted
        smallest-first — spot priority derives from that order. `pool_options`
        (price-ranked PoolOption rows) pins per-pool override rows instead.
        `launch_id` makes the fleet calls restart-idempotent (deterministic
        ClientTokens; see _launch)."""
        instances: List[Instance] = []
        for generation in range(MAX_LAUNCH_GENERATIONS):
            generation_id = launch_id
            if launch_id and generation:
                generation_id = f"{launch_id}|g{generation}"
            instance_ids = self._launch(
                constraints, provider, instance_types, quantity, pool_options,
                launch_id=generation_id,
            )
            # Capacity is bought (instance ids in hand); nothing upstream
            # knows yet — the canonical crash/leak window the GC +
            # idempotent tokens exist for.
            crashpoint("cloud.after-create-fleet")
            described = self._describe_with_retry(instance_ids)
            instances = [
                i for i in described if i.state not in DEAD_INSTANCE_STATES
            ]
            if instances or not launch_id:
                break
            # Every id the fleet calls handed back is a corpse: the token
            # replayed a pre-crash purchase whose capacity was since
            # terminated. Walk to the next deterministic generation.
        by_name = {t.name: t for t in instance_types}
        nodes, strays = [], []
        for instance in instances:
            instance_type = by_name.get(instance.instance_type)
            if instance_type is None:
                # Fleet launched a type we didn't offer: terminate it rather
                # than leak a running, untracked instance.
                strays.append(instance.instance_id)
                continue
            nodes.append(self._to_node(instance, instance_type))
        if strays:
            self.api.terminate_instances(strays)
        if not nodes:
            raise CloudProviderError("zero nodes were created")
        return nodes

    def terminate(self, node: NodeSpec) -> None:
        """Ref: instance.go Terminate:91-105 — not-found is success."""
        self.terminate_by_id(parse_instance_id(node.provider_id))

    def terminate_by_id(self, instance_id: str) -> None:
        """Not-found is success (raced normal termination / already gone) —
        the one terminate contract, shared by node deletion and the
        leaked-capacity GC."""
        try:
            self.api.terminate_instances([instance_id])
        except Exception as error:  # noqa: BLE001 — coded errors only
            if is_not_found(error):
                return
            raise

    # --- launch ------------------------------------------------------------

    def _launch(
        self,
        constraints: Constraints,
        provider: Ec2Provider,
        instance_types: Sequence[InstanceType],
        quantity: int,
        pool_options=None,
        launch_id: Optional[str] = None,
    ) -> List[str]:
        """Ref: instance.go launchInstances:107-146.

        With `launch_id`, every CreateFleet call in the template walk gets a
        ClientToken derived from (cluster, launch_id, call index, and the
        FULL request content — template, capacity type, quantity, override
        rows, tags): the walk is deterministic (templates is
        insertion-ordered from the same inputs), so a controller that
        crashed after a fleet call and re-issues the same logical launch
        replays the identical token sequence and ADOPTS the instances the
        first attempt bought instead of buying twice. Binding the token to
        the request content matters for the OTHER restart path: the ICE
        blackout cache empties on restart (and subnets/offerings drift), so
        a re-solve can rebuild DIFFERENT override rows for the same logical
        launch — EC2 rejects a reused token whose parameters changed
        (IdempotentParameterMismatch), which would wedge the launch loop
        until the idempotency window expires. A drifted request instead
        mints a fresh token and buys fresh; the first attempt's orphans are
        the leaked-capacity GC's job."""
        capacity_type = self.pick_capacity_type(constraints, instance_types)
        templates = self.launch_template_provider.get(
            constraints,
            provider,
            instance_types,
            {wellknown.CAPACITY_TYPE_LABEL: capacity_type},
        )
        subnets = self.subnet_provider.get(provider)
        allowed_zones = constraints.effective_requirements().zones()
        result = FleetResult()
        fleet_call_index = 0
        for template_name, template_types in templates.items():
            if pool_options:
                overrides = self.build_pool_overrides(
                    pool_options, template_types, subnets, allowed_zones,
                    capacity_type,
                )
            else:
                overrides = self.build_overrides(
                    template_types, subnets, allowed_zones, capacity_type
                )
            if not overrides:
                continue
            request = FleetRequest(
                launch_template_name=template_name,
                overrides=overrides,
                capacity_type=capacity_type,
                quantity=quantity - len(result.instance_ids),
                tags=merge_tags(self.cluster_name, "", dict(provider.tags)),
            )
            if launch_id:
                request.client_token = derive_client_token(
                    "CreateFleet",
                    self.cluster_name,
                    launch_id,
                    str(fleet_call_index),
                    request.idempotency_payload(),
                )
            fleet_call_index += 1
            fleet = self.api.create_fleet(request)
            self._record_unavailable(fleet, capacity_type)
            result.instance_ids.extend(fleet.instance_ids)
            result.errors.extend(fleet.errors)
            if len(result.instance_ids) >= quantity:
                break
        if not result.instance_ids:
            raise FleetLaunchError(result.errors)
        return result.instance_ids

    def pick_capacity_type(
        self, constraints: Constraints, instance_types: Sequence[InstanceType]
    ) -> str:
        """Spot iff the constraints allow spot AND some offering has it in an
        allowed zone; otherwise on-demand (ref: instance.go
        getCapacityType:281-292)."""
        requirements = constraints.effective_requirements()
        allowed = requirements.capacity_types()
        if allowed is not None and wellknown.CAPACITY_TYPE_SPOT not in allowed:
            return wellknown.CAPACITY_TYPE_ON_DEMAND
        if allowed is None:
            # Unconstrained capacity type defaults to on-demand (the vendor
            # defaulting hook normally pins this; this is the backstop).
            return wellknown.CAPACITY_TYPE_ON_DEMAND
        zones = requirements.zones()
        for instance_type in instance_types:
            for offering in instance_type.offerings:
                if offering.capacity_type != wellknown.CAPACITY_TYPE_SPOT:
                    continue
                if zones is None or offering.zone in zones:
                    return wellknown.CAPACITY_TYPE_SPOT
        return wellknown.CAPACITY_TYPE_ON_DEMAND

    def build_overrides(
        self,
        instance_types: Sequence[InstanceType],
        subnets,
        allowed_zones,
        capacity_type: str,
    ) -> List[FleetOverride]:
        """Cross product of instance types × offerings × subnets, one subnet
        per zone, spot priority = smallest-first index (ref: instance.go
        getOverrides:173-207)."""
        subnet_by_zone: Dict[str, str] = {}
        for subnet in subnets:
            subnet_by_zone.setdefault(subnet.zone, subnet.subnet_id)
        overrides = []
        for index, instance_type in enumerate(instance_types):
            for offering in instance_type.offerings:
                if offering.capacity_type != capacity_type:
                    continue
                if allowed_zones is not None and offering.zone not in allowed_zones:
                    continue
                subnet_id = subnet_by_zone.get(offering.zone)
                if subnet_id is None:
                    continue
                overrides.append(
                    FleetOverride(
                        instance_type=instance_type.name,
                        subnet_id=subnet_id,
                        zone=offering.zone,
                        priority=float(index)
                        if capacity_type == wellknown.CAPACITY_TYPE_SPOT
                        else None,
                    )
                )
        return overrides

    def build_pool_overrides(
        self,
        pool_options,
        template_types: Sequence[InstanceType],
        subnets,
        allowed_zones,
        capacity_type: str,
    ) -> List[FleetOverride]:
        """Override rows from a cost-aware plan's pinned pools: per-POOL
        priority (price rank) instead of the reference's per-type index —
        same row budget, strictly finer control over what spot's
        capacity-optimized-prioritized allocation may pick."""
        template_names = {t.name for t in template_types}
        subnet_by_zone: Dict[str, str] = {}
        for subnet in subnets:
            subnet_by_zone.setdefault(subnet.zone, subnet.subnet_id)
        overrides = []
        for pool in pool_options:
            if pool.instance_type.name not in template_names:
                continue
            if allowed_zones is not None and pool.zone not in allowed_zones:
                continue
            subnet_id = subnet_by_zone.get(pool.zone)
            if subnet_id is None:
                continue
            offered = any(
                o.zone == pool.zone and o.capacity_type == capacity_type
                for o in pool.instance_type.offerings
            )
            if not offered:
                continue
            overrides.append(
                FleetOverride(
                    instance_type=pool.instance_type.name,
                    subnet_id=subnet_id,
                    zone=pool.zone,
                    priority=float(pool.priority)
                    if capacity_type == wellknown.CAPACITY_TYPE_SPOT
                    else None,
                )
            )
        return overrides

    def _record_unavailable(self, fleet: FleetResult, capacity_type: str) -> None:
        """Feed ICE pools into the blackout cache (ref: instance.go
        updateUnavailableOfferingsCache:270-276)."""
        for error in fleet.errors:
            if error.code == INSUFFICIENT_CAPACITY_ERROR_CODE:
                self.instance_type_provider.cache_unavailable(
                    error.instance_type, error.zone, capacity_type
                )

    # --- describe / convert ------------------------------------------------

    def _describe_with_retry(self, instance_ids: List[str]) -> List[Instance]:
        """EC2 is eventually consistent (ref: instance.go:55-65)."""
        last_error: Optional[Exception] = None
        for attempt in range(DESCRIBE_RETRY_ATTEMPTS):
            try:
                return self.api.describe_instances(instance_ids)
            except Exception as error:  # noqa: BLE001 — coded errors only
                last_error = error
                if attempt < DESCRIBE_RETRY_ATTEMPTS - 1:
                    self.clock.sleep(DESCRIBE_RETRY_DELAY)
        raise CloudProviderError(f"describing instances: {last_error}")

    def _to_node(self, instance: Instance, instance_type: InstanceType) -> NodeSpec:
        """Ref: instance.go instanceToNode:232-268."""
        capacity_type = (
            wellknown.CAPACITY_TYPE_SPOT
            if instance.spot
            else wellknown.CAPACITY_TYPE_ON_DEMAND
        )
        return NodeSpec(
            name=instance.private_dns_name or instance.instance_id,
            labels={
                wellknown.ZONE_LABEL: instance.zone,
                wellknown.INSTANCE_TYPE_LABEL: instance.instance_type,
                wellknown.CAPACITY_TYPE_LABEL: capacity_type,
            },
            capacity=dict(instance_type.capacity),
            instance_type=instance.instance_type,
            zone=instance.zone,
            capacity_type=capacity_type,
            provider_id=PROVIDER_ID_FORMAT.format(
                zone=instance.zone, instance_id=instance.instance_id
            ),
            created_at=self.clock.now(),
        )


def parse_instance_id(provider_id: str) -> str:
    """Ref: instance.go getInstanceID:294-300."""
    parts = provider_id.split("/")
    if len(parts) < 5:
        raise CloudProviderError(f"parsing instance id from {provider_id!r}")
    return parts[4]
