"""The port of ``k8s_dra_driver_tpu/kube/objects.py`` (copied: the port imports
nothing of the JAX package).

Typed models for the Kubernetes objects this driver touches.

Covers the DRA ``resource.k8s.io/v1beta1`` structured-parameter surface
(ResourceSlice / DeviceClass / ResourceClaim, as consumed by the reference at
cmd/nvidia-dra-plugin/device_state.go:193-259 and published at
cmd/nvidia-dra-controller/imex.go:371-416) plus the core objects the driver
reads/writes (Node, Pod, Deployment — the last for the per-host topology
daemon, the analog of the MPS control daemon Deployment render at
cmd/nvidia-dra-plugin/sharing.go:185-287).

Pod/Deployment specs are deliberately loose (raw dicts) — the driver templates
them and never introspects deeply.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional

from k8s_dra_driver_torch.kube import serde

# ---------------------------------------------------------------------------
# metav1
# ---------------------------------------------------------------------------


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: Optional[bool] = None


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generate_name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[OwnerReference] = field(default_factory=list)
    creation_timestamp: str = ""


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | Exists
    values: list[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: list[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelector:
    node_selector_terms: list[NodeSelectorTerm] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        """True if any term matches (terms are ORed, expressions ANDed).
        Per core/v1 semantics a null/empty term matches NO objects."""
        for term in self.node_selector_terms:
            if not term.match_expressions:
                continue
            if all(_req_matches(req, labels) for req in term.match_expressions):
                return True
        return False


def _req_matches(req: NodeSelectorRequirement, labels: dict[str, str]) -> bool:
    if req.operator == "Exists":
        return req.key in labels
    if req.operator == "In":
        return labels.get(req.key) in req.values
    raise ValueError(f"unsupported node selector operator {req.operator!r}")


# ---------------------------------------------------------------------------
# resource.k8s.io/v1beta1 — ResourceSlice
# ---------------------------------------------------------------------------


@dataclass
class DeviceAttribute:
    """One-of attribute value (string/int/bool/version)."""

    SERDE_NAMES = {"int_value": "int", "bool_value": "bool"}

    string: Optional[str] = None
    int_value: Optional[int] = None
    bool_value: Optional[bool] = None
    version: Optional[str] = None

    @property
    def value(self) -> Any:
        for v in (self.string, self.int_value, self.bool_value, self.version):
            if v is not None:
                return v
        return None

    @staticmethod
    def of(value: Any) -> "DeviceAttribute":
        if isinstance(value, bool):
            return DeviceAttribute(bool_value=value)
        if isinstance(value, int):
            return DeviceAttribute(int_value=value)
        return DeviceAttribute(string=str(value))


@dataclass
class BasicDevice:
    attributes: dict[str, DeviceAttribute] = field(default_factory=dict)
    capacity: dict[str, str] = field(default_factory=dict)


@dataclass
class Device:
    name: str = ""
    basic: BasicDevice = field(default_factory=BasicDevice)


@dataclass
class ResourcePool:
    name: str = ""
    generation: int = 0
    resource_slice_count: int = 1


@dataclass
class ResourceSliceSpec:
    driver: str = ""
    pool: ResourcePool = field(default_factory=ResourcePool)
    node_name: str = ""
    node_selector: Optional[NodeSelector] = None
    all_nodes: Optional[bool] = None
    devices: list[Device] = field(default_factory=list)


@dataclass
class ResourceSlice:
    KIND = "ResourceSlice"
    API_VERSION = "resource.k8s.io/v1beta1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceSliceSpec = field(default_factory=ResourceSliceSpec)


# ---------------------------------------------------------------------------
# resource.k8s.io/v1beta1 — DeviceClass
# ---------------------------------------------------------------------------


@dataclass
class CELDeviceSelector:
    expression: str = ""


@dataclass
class DeviceSelector:
    cel: Optional[CELDeviceSelector] = None


@dataclass
class OpaqueDeviceConfiguration:
    driver: str = ""
    parameters: Any = None  # runtime.RawExtension — arbitrary JSON


@dataclass
class DeviceClassConfiguration:
    opaque: Optional[OpaqueDeviceConfiguration] = None


@dataclass
class DeviceClassSpec:
    selectors: list[DeviceSelector] = field(default_factory=list)
    config: list[DeviceClassConfiguration] = field(default_factory=list)


@dataclass
class DeviceClass:
    KIND = "DeviceClass"
    API_VERSION = "resource.k8s.io/v1beta1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeviceClassSpec = field(default_factory=DeviceClassSpec)


# ---------------------------------------------------------------------------
# resource.k8s.io/v1beta1 — ResourceClaim
# ---------------------------------------------------------------------------


@dataclass
class DeviceRequest:
    name: str = ""
    device_class_name: str = ""
    selectors: list[DeviceSelector] = field(default_factory=list)
    allocation_mode: str = "ExactCount"  # ExactCount | All
    count: int = 1
    admin_access: Optional[bool] = None


@dataclass
class DeviceConstraint:
    requests: list[str] = field(default_factory=list)
    match_attribute: str = ""


@dataclass
class DeviceClaimConfiguration:
    requests: list[str] = field(default_factory=list)
    opaque: Optional[OpaqueDeviceConfiguration] = None


@dataclass
class DeviceClaim:
    requests: list[DeviceRequest] = field(default_factory=list)
    constraints: list[DeviceConstraint] = field(default_factory=list)
    config: list[DeviceClaimConfiguration] = field(default_factory=list)


@dataclass
class ResourceClaimSpec:
    devices: DeviceClaim = field(default_factory=DeviceClaim)


@dataclass
class DeviceRequestAllocationResult:
    request: str = ""
    driver: str = ""
    pool: str = ""
    device: str = ""
    admin_access: Optional[bool] = None


@dataclass
class DeviceAllocationConfiguration:
    source: str = ""  # FromClass | FromClaim
    requests: list[str] = field(default_factory=list)
    opaque: Optional[OpaqueDeviceConfiguration] = None


@dataclass
class DeviceAllocationResult:
    results: list[DeviceRequestAllocationResult] = field(default_factory=list)
    config: list[DeviceAllocationConfiguration] = field(default_factory=list)


@dataclass
class AllocationResult:
    devices: DeviceAllocationResult = field(default_factory=DeviceAllocationResult)
    node_selector: Optional[NodeSelector] = None


@dataclass
class ResourceClaimConsumerReference:
    resource: str = "pods"
    name: str = ""
    uid: str = ""


@dataclass
class ResourceClaimStatus:
    allocation: Optional[AllocationResult] = None
    reserved_for: list[ResourceClaimConsumerReference] = field(default_factory=list)


@dataclass
class ResourceClaim:
    KIND = "ResourceClaim"
    API_VERSION = "resource.k8s.io/v1beta1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceClaimSpec = field(default_factory=ResourceClaimSpec)
    status: ResourceClaimStatus = field(default_factory=ResourceClaimStatus)


@dataclass
class ResourceClaimTemplate:
    KIND = "ResourceClaimTemplate"
    API_VERSION = "resource.k8s.io/v1beta1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Any = None  # {metadata, spec: ResourceClaimSpec-shaped dict}


# ---------------------------------------------------------------------------
# core/v1 + apps/v1 (loosely typed)
# ---------------------------------------------------------------------------


@dataclass
class Node:
    KIND = "Node"
    API_VERSION = "v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Any = None
    status: Any = None


@dataclass
class PodStatus:
    phase: str = "Pending"
    message: str = ""


@dataclass
class Pod:
    KIND = "Pod"
    API_VERSION = "v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Any = field(default_factory=dict)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class Deployment:
    KIND = "Deployment"
    API_VERSION = "apps/v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Any = field(default_factory=dict)
    status: Any = None


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: int = 0
    acquire_time: str = ""
    renew_time: str = ""
    lease_transitions: int = 0


@dataclass
class Lease:
    KIND = "Lease"
    API_VERSION = "coordination.k8s.io/v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)


KINDS = {
    cls.KIND: cls
    for cls in (
        ResourceSlice,
        DeviceClass,
        ResourceClaim,
        ResourceClaimTemplate,
        Node,
        Pod,
        Deployment,
        Lease,
    )
}


# ---------------------------------------------------------------------------
# Versioned serde seam: resource.k8s.io/v1beta1 <-> v1
#
# The internal model stays v1beta1-shaped (the version the reference pins);
# the seam converts at the WIRE level, so the types can follow upstream's
# graduation without a rewrite.  The two structural differences on this
# surface:
#   * ResourceSlice devices: v1beta1 wraps per-device data in ``basic:``
#     and renders capacity as plain quantity strings; v1 flattens the
#     device and wraps each capacity in ``{value: <quantity>}``.
#   * ResourceClaim requests: v1 moves the single-device fields under the
#     ``exactly:`` one-of (deviceClassName/selectors/allocationMode/count/
#     adminAccess).
# DeviceClass is shape-identical in both versions.
# ---------------------------------------------------------------------------

RESOURCE_API_VERSIONS = ("resource.k8s.io/v1beta1", "resource.k8s.io/v1")


def _claim_spec_to_v1(spec: dict) -> dict:
    devices = dict(spec.get("devices") or {})
    reqs = []
    for r in devices.get("requests") or []:
        r = dict(r)
        exactly = {
            k: r.pop(k)
            for k in (
                "deviceClassName", "selectors", "allocationMode", "count",
                "adminAccess",
            )
            if k in r
        }
        reqs.append({**r, "exactly": exactly})
    if reqs:
        devices["requests"] = reqs
    return {**spec, "devices": devices}


def _claim_spec_from_v1(spec: dict) -> dict:
    devices = dict(spec.get("devices") or {})
    reqs = []
    for r in devices.get("requests") or []:
        r = dict(r)
        exactly = r.pop("exactly", None) or {}
        reqs.append({**r, **exactly})
    if reqs:
        devices["requests"] = reqs
    return {**spec, "devices": devices}


def _to_v1_wire(kind: str, data: dict) -> dict:
    data = _fast_deepcopy(data)
    if kind == "ResourceSlice":
        for dev in (data.get("spec") or {}).get("devices") or []:
            basic = dev.pop("basic", None) or {}
            dev.update(basic)
            if "capacity" in dev:
                dev["capacity"] = {
                    k: {"value": v} for k, v in dev["capacity"].items()
                }
    elif kind == "ResourceClaim":
        if data.get("spec"):
            data["spec"] = _claim_spec_to_v1(data["spec"])
    elif kind == "ResourceClaimTemplate":
        tmpl = data.get("spec") or {}
        if tmpl.get("spec"):
            tmpl["spec"] = _claim_spec_to_v1(tmpl["spec"])
    return data


def _from_v1_wire(kind: str, body: dict) -> dict:
    body = _fast_deepcopy(body)
    if kind == "ResourceSlice":
        for dev in (body.get("spec") or {}).get("devices") or []:
            if "basic" in dev:
                continue  # already v1beta1-shaped
            basic = {}
            if "attributes" in dev:
                basic["attributes"] = dev.pop("attributes")
            if "capacity" in dev:
                basic["capacity"] = {
                    k: (v["value"] if isinstance(v, dict) else v)
                    for k, v in dev.pop("capacity").items()
                }
            if basic:
                dev["basic"] = basic
    elif kind == "ResourceClaim":
        if body.get("spec"):
            body["spec"] = _claim_spec_from_v1(body["spec"])
    elif kind == "ResourceClaimTemplate":
        tmpl = body.get("spec") or {}
        if tmpl.get("spec"):
            tmpl["spec"] = _claim_spec_from_v1(tmpl["spec"])
    return body


def to_json(obj: Any, api_version: str | None = None) -> dict:
    """Render ``obj`` for the wire.  ``api_version`` selects the serialized
    version for resource.k8s.io kinds (default: the pinned v1beta1); other
    groups ignore it."""
    data = serde.to_json(obj)
    kind = getattr(type(obj), "KIND", None)
    if kind:
        ver = type(obj).API_VERSION
        if api_version is not None and ver.startswith("resource.k8s.io/"):
            if api_version not in RESOURCE_API_VERSIONS:
                raise ValueError(
                    f"unsupported resource.k8s.io version {api_version!r} "
                    f"(known: {RESOURCE_API_VERSIONS})"
                )
            ver = api_version
            if api_version.endswith("/v1"):
                data = _to_v1_wire(kind, data)
        data = {"apiVersion": ver, "kind": kind, **data}
    return data


def from_json(data: dict) -> Any:
    kind = data.get("kind")
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    body = {k: v for k, v in data.items() if k not in ("apiVersion", "kind")}
    if data.get("apiVersion") == "resource.k8s.io/v1":
        body = _from_v1_wire(kind, body)
    return serde.from_json(KINDS[kind], body)


def deepcopy(obj: Any) -> Any:
    """Semantic equivalent of the generated zz_generated.deepcopy.go.

    Hand-rolled recursion instead of ``copy.deepcopy``: API objects are
    acyclic trees of plain dataclasses / dicts / lists / scalars, so the
    stdlib's memo machinery is pure overhead — and this copy sits on the
    fake API server's every list/get, i.e. the claim-to-running hot path
    (it was ~90% of allocation time under profile).  The reference
    generates per-type DeepCopy for the same reason."""
    return _fast_deepcopy(obj)


_ATOMIC = (str, int, float, bool, bytes, type(None))

# Field-name tuples are constant per type; dataclasses.fields() rebuilds
# them on every call, which matters on this every-list/get hot path.
_FIELD_CACHE: dict[type, tuple[str, ...]] = {}


def _fast_deepcopy(obj: Any) -> Any:
    if isinstance(obj, _ATOMIC):
        return obj
    cls = type(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = _FIELD_CACHE.get(cls)
        if names is None:
            names = _FIELD_CACHE[cls] = tuple(f.name for f in dataclasses.fields(obj))
        out = object.__new__(cls)
        for name in names:
            object.__setattr__(out, name, _fast_deepcopy(getattr(obj, name)))
        # functools.cached_property results land in __dict__ beside fields;
        # rebuilding from fields alone drops them, which is what we want.
        return out
    # Exact-type checks: dict/list/tuple SUBCLASSES (defaultdict,
    # NamedTuple, ...) fall through to the full-fidelity catch-all.
    if cls is dict:
        return {k: _fast_deepcopy(v) for k, v in obj.items()}
    if cls is list:
        return [_fast_deepcopy(v) for v in obj]
    if cls is tuple:
        return tuple(_fast_deepcopy(v) for v in obj)
    if isinstance(obj, enum.Enum):
        return obj
    return copy.deepcopy(obj)  # anything exotic keeps full fidelity
