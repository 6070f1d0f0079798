"""Real AWS binding for the Ec2Api boundary: SigV4-signed HTTP against the
EC2 Query API and SSM JSON API, stdlib only (no boto3 in the image).

Ref: the reference performs these exact calls through the AWS SDK —
CreateFleet type=instant with allocation strategies
(pkg/cloudprovider/aws/instance.go:116-133), DescribeInstanceTypes/
DescribeInstanceTypeOfferings paginated (aws/instancetypes.go:61-104),
DescribeSubnets/DescribeSecurityGroups by tag filter (aws/subnets.go:52-69,
securitygroups.go), launch-template CRUD (aws/launchtemplate.go), SSM
GetParameter for AMI discovery (aws/ami.go:49-110). This module is the same
wire surface hand-rolled: one class, `AwsHttpEc2Api`, implementing the typed
`Ec2Api` protocol over an injectable `HttpTransport` so tests drive it with
recorded/stub responses and production uses urllib with real credentials.

Prices: the EC2 control-plane API carries no prices; the reference ships a
generated static price table (aws/zz_generated.pricing.go). `price_catalog`
plays that role here — a mapping of instance type -> on-demand $/hr, with a
flat `spot_price_ratio` for spot rows (or `spot_prices` per (type, zone)).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import random
import urllib.error
import urllib.parse
import urllib.request
import uuid
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from karpenter_tpu_torch.cloudprovider.ec2.api import (
    ApiError,
    Ec2Api,
    derive_client_token,
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
)

from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.clock import SYSTEM_CLOCK
from karpenter_tpu_torch.utils.metrics import REGISTRY

log = klog.named("aws")

EC2_API_VERSION = "2016-11-15"
_SSM_TARGET_PREFIX = "AmazonSSM"
_SQS_TARGET_PREFIX = "AmazonSQS"
# One poll's message budget (the SQS per-call maximum). The controller sweeps
# every couple of seconds, so a reclaim storm drains across a few polls.
SQS_MAX_MESSAGES = 10

# Retries by action and error code: a rising rate is the first visible sign
# of throttling or a flaky NAT path, well before calls start exhausting
# their budget and failing outright.
AWS_RETRY_TOTAL = REGISTRY.counter(
    "aws_retry_total",
    "AWS call attempts retried, by API action and error code",
    ["action", "code"],
)


# --- HTTP layer -------------------------------------------------------------


@dataclass
class HttpResponse:
    status: int
    body: bytes
    headers: Mapping[str, str] = field(default_factory=dict)


class HttpTransport:
    """Boundary for the actual socket I/O — tests inject a stub that replays
    recorded responses; production uses UrllibTransport."""

    def send(
        self, method: str, url: str, headers: Mapping[str, str], body: bytes
    ) -> HttpResponse:
        raise NotImplementedError


class UrllibTransport(HttpTransport):
    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def send(self, method, url, headers, body) -> HttpResponse:
        request = urllib.request.Request(
            url, data=body, headers=dict(headers), method=method
        )
        try:
            with urllib.request.urlopen(request, timeout=self.timeout) as resp:
                return HttpResponse(
                    status=resp.status, body=resp.read(), headers=dict(resp.headers)
                )
        except urllib.error.HTTPError as err:  # non-2xx still has a body
            return HttpResponse(
                status=err.code, body=err.read(), headers=dict(err.headers or {})
            )
        except (urllib.error.URLError, OSError) as err:
            # Socket-level failures (DNS, reset, timeout) are normalized to a
            # coded ApiError so upstream classification — and the retryer —
            # behave identically against the real cloud and the fakes.
            raise ApiError("TransportError", str(err)) from err


# --- Retry ------------------------------------------------------------------

# Throttle codes back off harder than generic transient failures, mirroring
# the SDK's throttle/retryable split (Go SDK shouldRetry / throttle lists).
THROTTLE_CODES = frozenset(
    {
        "RequestLimitExceeded",
        "Throttling",
        "ThrottlingException",
        "RequestThrottled",
        "RequestThrottledException",
        "TooManyRequestsException",
        "EC2ThrottledException",
    }
)
_TRANSIENT_CODES = frozenset(
    {
        "TransportError",
        "RequestTimeout",
        "RequestTimeoutException",
        "InternalError",
        "InternalFailure",
        "ServiceUnavailable",
        "Unavailable",
        "InternalServiceError",
        "InternalServerError",
    }
)


@dataclass
class RetryPolicy:
    """Jittered exponential backoff with a bounded attempt budget.

    Ref: the reference's AWS session installs
    `client.DefaultRetryer{NumMaxRetries: DefaultRetryerMaxNumRetries}`
    (pkg/cloudprovider/aws/cloudprovider.go:67-69), so every EC2/SSM call
    there absorbs throttles (`RequestLimitExceeded`), 5xx, and connection
    errors for free. This is that retryer for the hand-rolled binding: equal
    jitter over an exponentially growing window, with throttle codes backing
    off from a larger base than generic transient failures (the SDK's 500ms
    vs 30ms minimums).
    """

    max_retries: int = 3
    base_delay: float = 0.03
    throttle_base: float = 0.5
    max_delay: float = 20.0
    sleep: Callable[[float], None] = SYSTEM_CLOCK.sleep
    rng: Callable[[], float] = random.random

    def is_retryable(self, code: str) -> bool:
        if code in THROTTLE_CODES or code in _TRANSIENT_CODES:
            return True
        # Synthesized codes for proxy/LB failures with no parseable envelope:
        # all 5xx, plus bare 429 (throttle) and 408 (timeout), the statuses
        # the SDK DefaultRetryer retries on without an error code.
        if code in ("HTTP429", "HTTP408"):
            return True
        if code.startswith("HTTP5") and code[4:].isdigit():
            return True
        return False

    def is_throttle(self, code: str) -> bool:
        return code in THROTTLE_CODES or code == "HTTP429"

    def delay(self, attempt: int, code: str) -> float:
        base = self.throttle_base if self.is_throttle(code) else self.base_delay
        window = min(self.max_delay, base * (2.0 ** attempt))
        return window / 2.0 + self.rng() * (window / 2.0)


# --- SigV4 ------------------------------------------------------------------


@dataclass(frozen=True)
class Credentials:
    access_key_id: str
    secret_access_key: str
    session_token: str = ""

    @staticmethod
    def from_env() -> "Credentials":
        return Credentials(
            access_key_id=os.environ.get("AWS_ACCESS_KEY_ID", ""),
            secret_access_key=os.environ.get("AWS_SECRET_ACCESS_KEY", ""),
            session_token=os.environ.get("AWS_SESSION_TOKEN", ""),
        )


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_request(
    method: str,
    url: str,
    headers: Dict[str, str],
    body: bytes,
    region: str,
    service: str,
    credentials: Credentials,
    now: Optional[datetime.datetime] = None,
) -> Dict[str, str]:
    """AWS Signature Version 4. Returns the headers dict with Host,
    X-Amz-Date, optional X-Amz-Security-Token, and Authorization added.
    Deterministic given `now`, so a known-answer test can pin the output."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")
    parsed = urllib.parse.urlsplit(url)
    headers = dict(headers)
    headers["Host"] = parsed.netloc
    headers["X-Amz-Date"] = amz_date
    if credentials.session_token:
        headers["X-Amz-Security-Token"] = credentials.session_token

    canonical_uri = urllib.parse.quote(parsed.path or "/", safe="/")
    query_pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    # Spec: sort by URI-encoded name/value — encode FIRST, then sort, so keys
    # whose encodings order differently than their raw forms sign correctly.
    encoded_pairs = sorted(
        (
            urllib.parse.quote(k, safe="-_.~"),
            urllib.parse.quote(v, safe="-_.~"),
        )
        for k, v in query_pairs
    )
    canonical_query = "&".join(f"{k}={v}" for k, v in encoded_pairs)
    signed_names = sorted(headers, key=str.lower)
    canonical_headers = "".join(
        f"{name.lower()}:{' '.join(headers[name].split())}\n" for name in signed_names
    )
    signed_headers = ";".join(name.lower() for name in signed_names)
    payload_hash = hashlib.sha256(body).hexdigest()
    canonical_request = "\n".join(
        [method, canonical_uri, canonical_query, canonical_headers, signed_headers,
         payload_hash]
    )
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope,
         hashlib.sha256(canonical_request.encode()).hexdigest()]
    )
    key = _hmac(
        _hmac(
            _hmac(
                _hmac(("AWS4" + credentials.secret_access_key).encode(), date_stamp),
                region,
            ),
            service,
        ),
        "aws4_request",
    )
    signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={credentials.access_key_id}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return headers


# --- XML helpers ------------------------------------------------------------


def _strip_ns(element: ET.Element) -> ET.Element:
    """EC2 responses carry a version namespace; strip it so callers use bare
    tag names regardless of API version."""
    for node in element.iter():
        if "}" in node.tag:
            node.tag = node.tag.split("}", 1)[1]
    return element


def _text(element: Optional[ET.Element], path: str, default: str = "") -> str:
    found = element.find(path) if element is not None else None
    return found.text.strip() if found is not None and found.text else default


def _items(element: Optional[ET.Element], path: str) -> List[ET.Element]:
    return element.findall(path) if element is not None else []


def _tags(element: Optional[ET.Element]) -> Dict[str, str]:
    return {
        _text(item, "key"): _text(item, "value")
        for item in _items(element, "tagSet/item")
    }


def _parse_launch_time(value: str) -> float:
    """ISO-8601 launchTime -> epoch seconds; 0.0 when absent/unparseable
    (the GC treats 0.0 as unknown and falls back to sighting age)."""
    if not value:
        return 0.0
    try:
        return datetime.datetime.fromisoformat(
            value.replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return 0.0


# --- The binding ------------------------------------------------------------


class AwsHttpEc2Api(Ec2Api):
    """Ec2Api over real AWS wire protocols (EC2 Query XML + SSM JSON 1.1).

    Pagination: every Describe* call follows nextToken until exhausted.
    Errors: non-2xx responses are parsed (XML <Errors><Error><Code> for EC2,
    JSON __type for SSM) and raised as the boundary's ApiError, so upstream
    classification (is_not_found, ICE handling) works identically against the
    real cloud and the in-memory fake.
    """

    def __init__(
        self,
        region: str = "",
        credentials: Optional[Credentials] = None,
        transport: Optional[HttpTransport] = None,
        ec2_endpoint: str = "",
        ssm_endpoint: str = "",
        sqs_endpoint: str = "",
        interruption_queue_url: str = "",
        price_catalog: Optional[Mapping[str, float]] = None,
        spot_price_ratio: float = 0.6,
        spot_prices: Optional[Mapping[Tuple[str, str], float]] = None,
        branch_interfaces: Optional[Mapping[str, int]] = None,
        clock: Callable[[], datetime.datetime] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.region = region or os.environ.get(
            "AWS_REGION", os.environ.get("AWS_DEFAULT_REGION", "us-east-1")
        )
        self.credentials = credentials or Credentials.from_env()
        self.transport = transport or UrllibTransport()
        self.ec2_endpoint = ec2_endpoint or f"https://ec2.{self.region}.amazonaws.com/"
        self.ssm_endpoint = ssm_endpoint or f"https://ssm.{self.region}.amazonaws.com/"
        self.sqs_endpoint = sqs_endpoint or f"https://sqs.{self.region}.amazonaws.com/"
        # EventBridge-fed interruption queue (spot-interruption-warning /
        # rebalance-recommendation / instance-state-change rules). Empty =
        # no interruption feed; receive_queue_messages returns [] without a
        # wire call.
        self.interruption_queue_url = interruption_queue_url or os.environ.get(
            "KARPENTER_INTERRUPTION_QUEUE_URL", ""
        )
        self.price_catalog = dict(price_catalog or {})
        self.spot_price_ratio = spot_price_ratio
        self.spot_prices = dict(spot_prices or {})
        # Pod-ENI branch-interface counts come from a static limits table in
        # the reference (vpc-resource-controller data), not the EC2 API.
        self.branch_interfaces = dict(branch_interfaces or {})
        self._clock = clock
        self.retry = retry_policy or RetryPolicy()
        # type name -> supported usage classes, from the last
        # DescribeInstanceTypes response (see describe_instance_type_offerings).
        self._usage_classes: Optional[Dict[str, Sequence[str]]] = None

    # --- protocol plumbing --------------------------------------------------

    def _with_retries(self, attempt_fn: Callable[[], "ET.Element | Dict"], what: str):
        """Run one signed call with the retry budget: throttles, 5xx, and
        transport failures back off and re-sign (fresh X-Amz-Date per attempt);
        everything else — and budget exhaustion — propagates."""
        attempt = 0
        while True:
            try:
                return attempt_fn()
            except ApiError as error:
                if attempt >= self.retry.max_retries or not self.retry.is_retryable(
                    error.code
                ):
                    raise
                delay = self.retry.delay(attempt, error.code)
                attempt += 1
                AWS_RETRY_TOTAL.inc(what, error.code)
                log.debug(
                    "%s attempt %d failed (%s); retrying in %.2fs",
                    what, attempt, error.code, delay,
                )
                self.retry.sleep(delay)

    def _ec2_call(self, action: str, params: Mapping[str, str]) -> ET.Element:
        body_params = {"Action": action, "Version": EC2_API_VERSION}
        body_params.update(params)
        body = urllib.parse.urlencode(sorted(body_params.items())).encode()
        return self._with_retries(
            lambda: self._ec2_attempt(body), what=action
        )

    def _ec2_attempt(self, body: bytes) -> ET.Element:
        headers = {"Content-Type": "application/x-www-form-urlencoded; charset=utf-8"}
        headers = sign_request(
            "POST", self.ec2_endpoint, headers, body, self.region, "ec2",
            self.credentials, now=self._clock() if self._clock else None,
        )
        response = self.transport.send("POST", self.ec2_endpoint, headers, body)
        if response.status >= 300:
            # Parse AFTER the status check: a proxy/LB 5xx may carry HTML or
            # an empty body, which must still surface as a coded ApiError so
            # upstream classification works, not as a bare XML ParseError.
            try:
                root = _strip_ns(ET.fromstring(response.body))
                error = root.find("Errors/Error")
            except ET.ParseError:
                error = None
            code = _text(error, "Code", f"HTTP{response.status}")
            message = _text(error, "Message") or response.body[:200].decode(
                "utf-8", "replace"
            )
            raise ApiError(code, message)
        try:
            root = _strip_ns(ET.fromstring(response.body))
        except ET.ParseError as err:
            # A 2xx with a non-XML body (misbehaving proxy) must still be a
            # coded error for upstream classification, not a raw ParseError.
            raise ApiError(
                "MalformedResponse",
                f"{err}: {response.body[:200].decode('utf-8', 'replace')}",
            ) from None
        if not root.tag.endswith("Response"):
            # Well-formed XML that is not an EC2 envelope (an XHTML error
            # page) would otherwise parse as an EMPTY result set.
            raise ApiError(
                "MalformedResponse", f"unexpected root element <{root.tag}>"
            )
        return root

    def _ec2_paginated(
        self, action: str, params: Mapping[str, str], item_path: str
    ) -> List[ET.Element]:
        items: List[ET.Element] = []
        token = ""
        while True:
            page_params = dict(params)
            if token:
                page_params["NextToken"] = token
            root = self._ec2_call(action, page_params)
            items.extend(root.findall(item_path))
            token = _text(root, "nextToken")
            if not token:
                return items

    def _ssm_call(self, target: str, payload: Mapping) -> Dict:
        body = json.dumps(payload).encode()
        return self._with_retries(
            lambda: self._json_attempt(
                self.ssm_endpoint, "ssm", f"{_SSM_TARGET_PREFIX}.{target}",
                "application/x-amz-json-1.1", body,
            ),
            what=target,
        )

    def _sqs_call(self, target: str, payload: Mapping) -> Dict:
        """SQS speaks the same signed JSON-RPC shape as SSM (json 1.0 rather
        than 1.1); retries ride the shared budget and count aws_retry_total
        by action like every other call."""
        body = json.dumps(payload).encode()
        return self._with_retries(
            lambda: self._json_attempt(
                self.sqs_endpoint, "sqs", f"{_SQS_TARGET_PREFIX}.{target}",
                "application/x-amz-json-1.0", body,
            ),
            what=target,
        )

    def _json_attempt(
        self, endpoint: str, service: str, target: str, content_type: str,
        body: bytes,
    ) -> Dict:
        headers = {
            "Content-Type": content_type,
            "X-Amz-Target": target,
        }
        headers = sign_request(
            "POST", endpoint, headers, body, self.region, service,
            self.credentials, now=self._clock() if self._clock else None,
        )
        response = self.transport.send("POST", endpoint, headers, body)
        try:
            data = json.loads(response.body or b"{}")
        except ValueError:
            data = None
        if response.status >= 300:
            data = data if isinstance(data, dict) else {}
            code = str(data.get("__type", f"HTTP{response.status}")).split("#")[-1]
            raise ApiError(code, str(data.get("message", data.get("Message", ""))))
        if not isinstance(data, dict):
            # 2xx with a non-JSON body: a transient proxy glitch must not be
            # coerced into {} and misread as ParameterNotFound downstream.
            raise ApiError(
                "MalformedResponse",
                response.body[:200].decode("utf-8", "replace"),
            )
        return data

    # --- discovery ----------------------------------------------------------

    def describe_instance_types(self) -> List[InstanceTypeInfo]:
        items = self._ec2_paginated(
            "DescribeInstanceTypes", {"MaxResults": "100"}, "instanceTypeSet/item"
        )
        infos = []
        for item in items:
            name = _text(item, "instanceType")
            gpus = {"nvidia": 0, "amd": 0}
            for gpu in _items(item, "gpuInfo/gpus/item"):
                maker = _text(gpu, "manufacturer").lower()
                count = int(_text(gpu, "count", "0") or 0)
                if maker in gpus:
                    gpus[maker] += count
            neurons = sum(
                int(_text(acc, "count", "0") or 0)
                for acc in _items(item, "inferenceAcceleratorInfo/accelerators/item")
            )
            infos.append(
                InstanceTypeInfo(
                    name=name,
                    vcpus=int(_text(item, "vCpuInfo/defaultVCpus", "0") or 0),
                    memory_mib=int(_text(item, "memoryInfo/sizeInMiB", "0") or 0),
                    architectures=tuple(
                        node.text
                        for node in _items(
                            item, "processorInfo/supportedArchitectures/item"
                        )
                        if node.text
                    )
                    or ("x86_64",),
                    supported_usage_classes=tuple(
                        node.text
                        for node in _items(item, "supportedUsageClasses/item")
                        if node.text
                    )
                    or ("on-demand",),
                    max_network_interfaces=int(
                        _text(item, "networkInfo/maximumNetworkInterfaces", "4") or 4
                    ),
                    ipv4_addresses_per_interface=int(
                        _text(item, "networkInfo/ipv4AddressesPerInterface", "15") or 15
                    ),
                    nvidia_gpus=gpus["nvidia"],
                    amd_gpus=gpus["amd"],
                    neurons=neurons,
                    pod_eni_branch_interfaces=self.branch_interfaces.get(name, 0),
                    bare_metal=_text(item, "bareMetal", "false") == "true",
                    fpga=item.find("fpgaInfo") is not None,
                    supported_virtualization_types=tuple(
                        node.text
                        for node in _items(item, "supportedVirtualizationTypes/item")
                        if node.text
                    )
                    or ("hvm",),
                    price_on_demand=float(self.price_catalog.get(name, 0.0)),
                )
            )
        self._usage_classes = {
            info.name: info.supported_usage_classes for info in infos
        }
        return infos

    def describe_instance_type_offerings(self) -> List[InstanceTypeOffering]:
        """Wire rows are (type, zone); capacity types come from the type's
        supportedUsageClasses and prices from the static catalog (the wire has
        no prices — see module docstring). Usage classes reuse the last
        DescribeInstanceTypes result (refreshed by describe_instance_types,
        which the provider's own 5-minute catalog cache already drives) —
        ~8 paginated signed calls saved per offerings refresh on the real
        ~700-type EC2 catalog."""
        if self._usage_classes is None:
            self.describe_instance_types()
        usage_classes = self._usage_classes or {}
        items = self._ec2_paginated(
            "DescribeInstanceTypeOfferings",
            {"LocationType": "availability-zone", "MaxResults": "1000"},
            "instanceTypeOfferingSet/item",
        )
        offerings = []
        for item in items:
            name = _text(item, "instanceType")
            zone = _text(item, "location")
            od_price = float(self.price_catalog.get(name, 0.0))
            for capacity_type in usage_classes.get(name, ("on-demand",)):
                if capacity_type == "spot":
                    price = self.spot_prices.get(
                        (name, zone), od_price * self.spot_price_ratio
                    )
                else:
                    price = od_price
                offerings.append(
                    InstanceTypeOffering(
                        instance_type=name,
                        zone=zone,
                        capacity_type=capacity_type,
                        price=price,
                    )
                )
        return offerings

    def describe_spot_price_history(self) -> List[SpotPrice]:
        """DescribeSpotPriceHistory over the signed Query API with the
        shared retry envelope — the polling leg of the live market feed
        (karpenter_tpu/market): rows become a replayable tick stream in
        Ec2CloudProvider.poll_market_events."""
        items = self._ec2_paginated(
            "DescribeSpotPriceHistory",
            {"ProductDescription.1": "Linux/UNIX", "MaxResults": "1000"},
            "spotPriceHistorySet/item",
        )
        rows: List[SpotPrice] = []
        for item in items:
            name = _text(item, "instanceType")
            zone = _text(item, "availabilityZone")
            try:
                price = float(_text(item, "spotPrice") or "0")
            except ValueError:
                continue  # a malformed row must not poison the whole poll
            if not name or not zone or price <= 0:
                continue
            rows.append(
                SpotPrice(
                    instance_type=name,
                    zone=zone,
                    price=price,
                    timestamp=_parse_launch_time(_text(item, "timestamp")),
                )
            )
        return rows

    @staticmethod
    def _filter_params(filters: Mapping[str, str]) -> Dict[str, str]:
        """Tag selector -> EC2 Filter.N params: value "*"/"" filters on key
        existence (tag-key), else exact tag:KEY=value
        (ref: aws/subnets.go getFilters:52-69)."""
        params: Dict[str, str] = {}
        for index, (key, value) in enumerate(sorted(filters.items()), start=1):
            if value in ("*", ""):
                params[f"Filter.{index}.Name"] = "tag-key"
                params[f"Filter.{index}.Value.1"] = key
            else:
                params[f"Filter.{index}.Name"] = f"tag:{key}"
                params[f"Filter.{index}.Value.1"] = value
        return params

    def describe_subnets(self, filters: Mapping[str, str]) -> List[Subnet]:
        items = self._ec2_paginated(
            "DescribeSubnets", self._filter_params(filters), "subnetSet/item"
        )
        return [
            Subnet(
                subnet_id=_text(item, "subnetId"),
                zone=_text(item, "availabilityZone"),
                tags=_tags(item),
            )
            for item in items
        ]

    def describe_security_groups(
        self, filters: Mapping[str, str]
    ) -> List[SecurityGroup]:
        items = self._ec2_paginated(
            "DescribeSecurityGroups",
            self._filter_params(filters),
            "securityGroupInfo/item",
        )
        return [
            SecurityGroup(group_id=_text(item, "groupId"), tags=_tags(item))
            for item in items
        ]

    # --- launch templates ---------------------------------------------------

    def describe_launch_template(self, name: str) -> LaunchTemplate:
        root = self._ec2_call(
            "DescribeLaunchTemplateVersions",
            {"LaunchTemplateName": name, "LaunchTemplateVersion.1": "$Latest"},
        )
        versions = root.findall("launchTemplateVersionSet/item")
        if not versions:
            raise ApiError("InvalidLaunchTemplateName.NotFoundException", name)
        version = versions[0]
        data = version.find("launchTemplateData")
        return LaunchTemplate(
            name=_text(version, "launchTemplateName", name),
            template_id=_text(version, "launchTemplateId"),
            image_id=_text(data, "imageId"),
            instance_profile=_text(data, "iamInstanceProfile/name"),
            security_group_ids=tuple(
                node.text
                for node in _items(data, "securityGroupIdSet/item")
                if node.text
            ),
            user_data=_text(data, "userData"),
        )

    def create_launch_template(self, template: LaunchTemplate) -> LaunchTemplate:
        params: Dict[str, str] = {
            "LaunchTemplateName": template.name,
            # Same idempotency rationale as CreateFleet, strengthened to
            # survive a controller RESTART: the token derives from the
            # template's content identity (the name already embeds the
            # content hash — launchtemplates._template_name), so a retried
            # attempt re-sends the identical token (one body per logical
            # call in _ec2_call) AND a restarted controller re-ensuring the
            # same template is a server-side no-op rather than an
            # AlreadyExists surprise.
            "ClientToken": derive_client_token(
                "CreateLaunchTemplate", template.name, template.image_id
            ),
            "LaunchTemplateData.ImageId": template.image_id,
            "LaunchTemplateData.UserData": template.user_data,
        }
        if template.instance_profile:
            params["LaunchTemplateData.IamInstanceProfile.Name"] = (
                template.instance_profile
            )
        for index, group_id in enumerate(template.security_group_ids, start=1):
            params[f"LaunchTemplateData.SecurityGroupId.{index}"] = group_id
        for index, (key, value) in enumerate(sorted(template.tags.items()), start=1):
            params["LaunchTemplateData.TagSpecification.1.ResourceType"] = "instance"
            params[f"LaunchTemplateData.TagSpecification.1.Tag.{index}.Key"] = key
            params[f"LaunchTemplateData.TagSpecification.1.Tag.{index}.Value"] = value
        root = self._ec2_call("CreateLaunchTemplate", params)
        created = root.find("launchTemplate")
        return LaunchTemplate(
            name=_text(created, "launchTemplateName", template.name),
            template_id=_text(created, "launchTemplateId"),
            image_id=template.image_id,
            instance_profile=template.instance_profile,
            security_group_ids=tuple(template.security_group_ids),
            user_data=template.user_data,
            tags=dict(template.tags),
        )

    # --- fleet --------------------------------------------------------------

    def create_fleet(self, request: FleetRequest) -> FleetResult:
        """CreateFleet type=instant with the reference's allocation
        strategies: lowest-price on-demand, capacity-optimized-prioritized
        spot (ref: instance.go:116-133)."""
        params: Dict[str, str] = {
            "Type": "instant",
            # Idempotency token: a retried CreateFleet (5xx whose first
            # attempt may have executed server-side) must not double-launch.
            # The whole retry loop re-sends ONE token since the body is built
            # once per logical call in _ec2_call. When the caller supplies a
            # deterministic token (restart-safe launches, see FleetRequest),
            # it is forwarded verbatim; otherwise a random per-call token
            # preserves the retry-only guarantee.
            "ClientToken": request.client_token or str(uuid.uuid4()),
            "LaunchTemplateConfigs.1.LaunchTemplateSpecification.LaunchTemplateName":
                request.launch_template_name,
            "LaunchTemplateConfigs.1.LaunchTemplateSpecification.Version": "$Latest",
            "TargetCapacitySpecification.TotalTargetCapacity": str(request.quantity),
            "TargetCapacitySpecification.DefaultTargetCapacityType":
                request.capacity_type,
        }
        if request.capacity_type == "spot":
            params["SpotOptions.AllocationStrategy"] = "capacity-optimized-prioritized"
        else:
            params["OnDemandOptions.AllocationStrategy"] = "lowest-price"
        for index, override in enumerate(request.overrides, start=1):
            prefix = f"LaunchTemplateConfigs.1.Overrides.{index}"
            params[f"{prefix}.InstanceType"] = override.instance_type
            params[f"{prefix}.SubnetId"] = override.subnet_id
            if override.priority is not None:
                params[f"{prefix}.Priority"] = str(override.priority)
        for index, (key, value) in enumerate(sorted(request.tags.items()), start=1):
            params["TagSpecification.1.ResourceType"] = "instance"
            params[f"TagSpecification.1.Tag.{index}.Key"] = key
            params[f"TagSpecification.1.Tag.{index}.Value"] = value

        root = self._ec2_call("CreateFleet", params)
        result = FleetResult()
        for item in root.findall("fleetInstanceSet/item"):
            for node in _items(item, "instanceIds/item"):
                if node.text:
                    result.instance_ids.append(node.text)
        for item in root.findall("errorSet/item"):
            overrides = item.find("launchTemplateAndOverrides/overrides")
            result.errors.append(
                FleetError(
                    code=_text(item, "errorCode"),
                    message=_text(item, "errorMessage"),
                    instance_type=_text(overrides, "instanceType"),
                    zone=_text(overrides, "availabilityZone"),
                )
            )
        return result

    # --- instances ----------------------------------------------------------

    def describe_instances(self, instance_ids: Sequence[str]) -> List[Instance]:
        params = {
            f"InstanceId.{index}": instance_id
            for index, instance_id in enumerate(instance_ids, start=1)
        }
        return self._describe_instances(params)

    def describe_instances_by_tag(
        self, filters: Mapping[str, str]
    ) -> List[Instance]:
        """DescribeInstances with tag filters — the leaked-capacity GC's
        sweep over everything this cluster is paying for, Node or not."""
        return self._describe_instances(self._filter_params(filters))

    def _describe_instances(self, params: Mapping[str, str]) -> List[Instance]:
        items = self._ec2_paginated(
            "DescribeInstances", params, "reservationSet/item"
        )
        instances = []
        for reservation in items:
            for item in _items(reservation, "instancesSet/item"):
                instances.append(
                    Instance(
                        instance_id=_text(item, "instanceId"),
                        instance_type=_text(item, "instanceType"),
                        zone=_text(item, "placement/availabilityZone"),
                        private_dns_name=_text(item, "privateDnsName"),
                        image_id=_text(item, "imageId"),
                        architecture=_text(item, "architecture", "x86_64"),
                        spot=_text(item, "instanceLifecycle") == "spot",
                        state=_text(item, "instanceState/name", "running"),
                        tags=_tags(item),
                        launched_at=_parse_launch_time(
                            _text(item, "launchTime")
                        ),
                    )
                )
        return instances

    def terminate_instances(self, instance_ids: Sequence[str]) -> None:
        params = {
            f"InstanceId.{index}": instance_id
            for index, instance_id in enumerate(instance_ids, start=1)
        }
        self._ec2_call("TerminateInstances", params)

    # --- ssm ----------------------------------------------------------------

    def get_ami_parameter(self, path: str) -> str:
        data = self._ssm_call("GetParameter", {"Name": path})
        value = data.get("Parameter", {}).get("Value", "")
        if not value:
            raise ApiError("ParameterNotFound", path)
        return value

    # --- interruption queue (sqs) -------------------------------------------

    def receive_queue_messages(self) -> List[QueueMessage]:
        """One short poll of the EventBridge-fed interruption queue. Messages
        are NOT deleted here — they stay invisible for the queue's visibility
        timeout and re-deliver unless delete_queue_message confirms them, so
        a controller that dies after receiving loses nothing."""
        if not self.interruption_queue_url:
            return []
        data = self._sqs_call(
            "ReceiveMessage",
            {
                "QueueUrl": self.interruption_queue_url,
                "MaxNumberOfMessages": SQS_MAX_MESSAGES,
                "WaitTimeSeconds": 0,
            },
        )
        return [
            QueueMessage(
                message_id=str(item.get("MessageId", "")),
                receipt_handle=str(item.get("ReceiptHandle", "")),
                body=str(item.get("Body", "")),
            )
            for item in data.get("Messages", []) or []
        ]

    def delete_queue_message(self, receipt_handle: str) -> None:
        if not self.interruption_queue_url or not receipt_handle:
            return
        try:
            self._sqs_call(
                "DeleteMessage",
                {
                    "QueueUrl": self.interruption_queue_url,
                    "ReceiptHandle": receipt_handle,
                },
            )
        except ApiError as error:
            # An expired/unknown handle means the message already re-surfaced
            # or was deleted — ack semantics make that success.
            if error.code not in (
                "ReceiptHandleIsInvalid", "InvalidParameterValue",
            ):
                raise
