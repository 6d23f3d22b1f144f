"""The port of ``k8s_dra_driver_tpu/kube/quantity.py`` (copied: the port imports
nothing of the JAX package).

Subset of k8s ``resource.Quantity`` parsing/formatting.

The reference leans on apimachinery's Quantity for capacities (device memory,
MPS pinned-memory limits — api/nvidia.com/resource/gpu/v1alpha1/sharing.go:229-247).
We need the same for HBM capacities and per-partition memory limits.  Supports
plain integers, binary suffixes (Ki..Ei) and decimal suffixes (k..E, m for
milli is intentionally unsupported — device capacities are integral).
"""

from __future__ import annotations

import math

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}


class InvalidQuantity(ValueError):
    pass


def parse(s: str | int) -> int:
    """Parse a quantity string to an integer number of base units."""
    if isinstance(s, int):
        return s
    s = s.strip()
    if not s:
        raise InvalidQuantity("empty quantity")
    for suffix, mult in sorted({**_BINARY, **_DECIMAL}.items(), key=lambda kv: -len(kv[0])):
        if s.endswith(suffix):
            num = s[: -len(suffix)]
            break
    else:
        suffix, mult, num = "", 1, s
    try:
        value = float(num) if "." in num else int(num)
    except ValueError as exc:
        raise InvalidQuantity(f"invalid quantity {s!r}") from exc
    if isinstance(value, float) and not math.isfinite(value):
        # float('9.9e999') is inf; int(inf) would leak OverflowError out of
        # the parse-or-InvalidQuantity contract (HbmLimits.normalize and the
        # CEL quantity() both catch exactly InvalidQuantity).
        raise InvalidQuantity(f"quantity {s!r} is not finite")
    result = value * mult
    if isinstance(result, float) and not math.isfinite(result):
        # finite mantissa x suffix multiplier can still overflow
        # (e.g. '9.9e307M'); int(inf) would leak OverflowError.
        raise InvalidQuantity(f"quantity {s!r} overflows")
    if result != int(result):
        raise InvalidQuantity(f"quantity {s!r} is not integral")
    return int(result)


def format_bytes(n: int) -> str:
    """Format with the largest exact binary suffix (k8s canonical-ish form)."""
    for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
        mult = _BINARY[suffix]
        if n >= mult and n % mult == 0:
            return f"{n // mult}{suffix}"
    return str(n)
