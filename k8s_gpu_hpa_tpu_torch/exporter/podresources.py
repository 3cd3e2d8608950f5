"""Device→pod attribution (the subset the headline loop uses).

Counterpart of ``k8s_gpu_hpa_tpu/exporter/podresources.py``.  The kubelet
PodResources client is not ported; the loop attributes its one real device
to its pod with a static table.
"""

from __future__ import annotations

from typing import Protocol


class StaticAttributor:
    """Hardware-free attributor for tests and the headline loop."""

    def __init__(self, mapping: dict[int, tuple[str, str]] | None = None):
        self.mapping = dict(mapping or {})

    def list_allocations(self) -> dict[int, tuple[str, str]]:
        return dict(self.mapping)


class Attributor(Protocol):
    """Anything that can report {device_index: (namespace, pod)} allocations."""

    def list_allocations(self) -> dict[int, tuple[str, str]]: ...
