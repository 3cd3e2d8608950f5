"""Kubernetes resource-quantity parsing.

Counterpart of ``k8s_gpu_hpa_tpu/utils/quantity.py``.  HPA manifests write
metric targets as Kubernetes quantities: plain numbers (``"40"``), decimal
SI suffixes (``"500m"``, ``"2k"``) or binary SI suffixes (``"13Gi"``).  The
HBM HPA's target is a byte quantity, so the controller parses the whole
grammar rather than assuming bare floats.
"""

from __future__ import annotations

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}


def parse_quantity(q: str | int | float) -> float:
    """Parse a Kubernetes quantity into a float (bytes, cores or plain units)."""
    if isinstance(q, (int, float)):
        return float(q)
    s = q.strip()
    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    if s and s[-1] in _DECIMAL:
        try:
            return float(s[:-1]) * _DECIMAL[s[-1]]
        except ValueError:
            pass  # a bare "m" or a malformed number: fall through
    return float(s)
