"""The port of ``k8s_dra_driver_tpu/api/decoder.py`` (copied: the port imports
nothing of the JAX package).

Strict decoder for the opaque config kinds.

Mirror of the reference's scheme registration + strict JSON decoder
(api.go:43-71): opaque parameters must carry apiVersion/kind, unknown kinds
and unknown fields are rejected (the reference uses
serializer strict-mode for the same reason — config typos must fail loudly at
Prepare time, not be silently dropped).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, get_args, get_origin, get_type_hints

from k8s_dra_driver_torch.api.sharing import HbmLimits
from k8s_dra_driver_torch.api.tpuconfig import (
    SliceGroupConfig,
    SliceMembershipConfig,
    SubsliceConfig,
    TpuConfig,
)
from k8s_dra_driver_torch.kube.serde import _unwrap_optional, snake_to_camel

API_GROUP = "resource.tpu.google.com"
API_VERSION = f"{API_GROUP}/v1alpha1"


class DecodeError(ValueError):
    pass


_KINDS = {
    cls.KIND: cls
    for cls in (TpuConfig, SubsliceConfig, SliceMembershipConfig, SliceGroupConfig)
}


class Decoder:
    """Decodes opaque ``parameters`` JSON into a registered config kind."""

    def decode(self, data: Any) -> Any:
        if not isinstance(data, dict):
            raise DecodeError(f"opaque parameters must be an object, got {type(data).__name__}")
        api_version = data.get("apiVersion")
        kind = data.get("kind")
        if api_version != API_VERSION:
            raise DecodeError(f"unsupported apiVersion {api_version!r} (want {API_VERSION})")
        if kind not in _KINDS:
            raise DecodeError(f"unknown kind {kind!r} (known: {sorted(_KINDS)})")
        body = {k: v for k, v in data.items() if k not in ("apiVersion", "kind")}
        return _strict(_KINDS[kind], body, path=kind)


def _strict(tp: Any, data: Any, path: str) -> Any:
    tp = _unwrap_optional(tp)
    if data is None:
        return None
    if tp is HbmLimits:
        if not isinstance(data, dict):
            raise DecodeError(f"{path}: expected object")
        return HbmLimits({str(k): v for k, v in data.items()})
    origin = get_origin(tp)
    if origin is list:
        (item_tp,) = get_args(tp)
        return [_strict(item_tp, v, f"{path}[{i}]") for i, v in enumerate(data)]
    if origin is dict:
        key_tp, val_tp = get_args(tp)
        if not isinstance(data, dict):
            raise DecodeError(f"{path}: expected object")
        return {k: _strict(val_tp, v, f"{path}.{k}") for k, v in data.items()}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        try:
            return tp(data)
        except ValueError as exc:
            raise DecodeError(f"{path}: {exc}") from exc
    if dataclasses.is_dataclass(tp):
        if not isinstance(data, dict):
            raise DecodeError(f"{path}: expected object, got {type(data).__name__}")
        hints = get_type_hints(tp)
        camel_to_field = {snake_to_camel(f.name): f for f in dataclasses.fields(tp)}
        kwargs = {}
        for key, value in data.items():
            f = camel_to_field.get(key)
            if f is None:
                raise DecodeError(f"{path}: unknown field {key!r}")
            kwargs[f.name] = _strict(hints[f.name], value, f"{path}.{key}")
        return tp(**kwargs)
    if tp is int and isinstance(data, bool):
        raise DecodeError(f"{path}: expected int, got bool")
    if tp in (int, str, bool) and not isinstance(data, tp):
        raise DecodeError(f"{path}: expected {tp.__name__}, got {type(data).__name__}")
    return data
