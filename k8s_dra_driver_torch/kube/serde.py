"""The port of ``k8s_dra_driver_tpu/kube/serde.py`` (copied: the port imports
nothing of the JAX package).

Dataclass <-> Kubernetes-style JSON (camelCase, omitempty) conversion.

Every API object in this repo is a plain ``@dataclass`` with snake_case fields;
this module supplies the single generic mapper used for wire/YAML round-trips,
so individual types carry no serialization boilerplate.
"""

from __future__ import annotations

import dataclasses
import enum
import types
import typing
from typing import Any, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")


def snake_to_camel(name: str, overrides: dict[str, str] | None = None) -> str:
    """Default field-name mapping; a dataclass can pin exceptions by defining
    a ``SERDE_NAMES = {field_name: wire_name}`` class attribute."""
    if overrides and name in overrides:
        return overrides[name]
    head, *rest = name.split("_")
    return head + "".join(part[:1].upper() + part[1:] for part in rest)


def _is_empty(value: Any) -> bool:
    # k8s omitempty semantics: zero-value strings/collections are omitted.
    return value is None or value == [] or value == {} or value == ""


def to_json(obj: Any) -> Any:
    """Convert a dataclass tree to JSON-compatible data, dropping empties."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        overrides = getattr(type(obj), "SERDE_NAMES", None)
        out = {}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if _is_empty(value):
                continue
            out[snake_to_camel(f.name, overrides)] = to_json(value)
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: to_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_json(v) for v in obj]
    return obj


def _unwrap_optional(tp: Any) -> Any:
    origin = get_origin(tp)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_json(cls: type[T], data: Any) -> T:
    """Reconstruct a dataclass tree from camelCase JSON data."""
    return _from_json(cls, data)


def _from_json(tp: Any, data: Any) -> Any:
    tp = _unwrap_optional(tp)
    if data is None:
        return None
    origin = get_origin(tp)
    if origin in (list, tuple):
        (item_tp,) = get_args(tp) or (Any,)
        return [_from_json(item_tp, v) for v in data]
    if origin is dict:
        args = get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: _from_json(val_tp, v) for k, v in data.items()}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(data)
    if dataclasses.is_dataclass(tp):
        hints = get_type_hints(tp)
        overrides = getattr(tp, "SERDE_NAMES", None)
        camel_to_field = {snake_to_camel(f.name, overrides): f for f in dataclasses.fields(tp)}
        kwargs = {}
        for key, value in data.items():
            f = camel_to_field.get(key)
            if f is None:
                continue  # forward-compatible: ignore unknown fields
            kwargs[f.name] = _from_json(hints[f.name], value)
        return tp(**kwargs)
    if tp is Any:
        return data
    return data
