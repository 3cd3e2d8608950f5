"""Device→pod attribution via the kubelet PodResources API.

Counterpart of ``k8s_gpu_hpa_tpu/exporter/podresources.py``.  dcgm-exporter
attributes GPUs to pods by mounting the kubelet pod-resources socket and
setting DCGM_EXPORTER_KUBERNETES=true (dcgm-exporter.yaml:33-34, 50-52,
57-59).  This client queries the same API — ``v1.PodResourcesLister/List`` on
``/var/lib/kubelet/pod-resources/kubelet.sock`` — for allocations of the
extended resource ``nvidia.com/gpu`` (the reference's request,
cuda-test-deployment.yaml:20-22), and joins on the device's NVML index.

NVIDIA's device plugin names a device by its UUID (``GPU-xxxxxxxx-…``) under
its default ``deviceIDStrategy=uuid``, or by its integer index under
``index``.  A UUID is mapped to its index through a resolver (in production
NVML: ``NvmlSource.uuid_to_index``); the trailing-integer rule is never run
on it, since a UUID that happens to end in digits would give a wrong index.
A UUID the resolver does not know is skipped, never guessed.  MIG devices
(``MIG-…``) are out of scope and skipped.

Wire schema consumed (unknown fields skipped — see utils/protowire):

    ListPodResourcesResponse { repeated PodResources pod_resources = 1; }
    PodResources  { string name = 1; string namespace = 2;
                    repeated ContainerResources containers = 3; }
    ContainerResources { string name = 1; repeated ContainerDevices devices = 2; }
    ContainerDevices   { string resource_name = 1; repeated string device_ids = 2; }
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Protocol

from k8s_gpu_hpa_tpu_torch.utils import protowire

GPU_RESOURCE = "nvidia.com/gpu"
DEFAULT_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"

_TRAILING_INT = re.compile(r"(\d+)\s*$")


def parse_device_index(device_id: str) -> int | None:
    """Map a plain device-plugin id to a device index: the trailing integer
    (``"3"``, ``"nvidia3"``, ``"/dev/nvidia3"``), as the JAX package does.
    Never call it on a UUID."""
    m = _TRAILING_INT.search(device_id)
    return int(m.group(1)) if m else None


def _device_index(
    device_id: str, resolve_uuid: Callable[[str], int | None] | None
) -> int | None:
    if device_id.startswith("MIG-"):
        return None  # MIG instances: out of scope
    if device_id.startswith("GPU-"):
        return resolve_uuid(device_id) if resolve_uuid is not None else None
    return parse_device_index(device_id)


def parse_list_response(
    data: bytes,
    resource_name: str = GPU_RESOURCE,
    resolve_uuid: Callable[[str], int | None] | None = None,
) -> dict[int, tuple[str, str]]:
    """Decode a ListPodResourcesResponse into {device_index: (namespace, pod)}.

    ``resolve_uuid`` maps a ``GPU-`` UUID to its index (None: unknown, and
    the id is skipped); without it every UUID is skipped."""
    mapping: dict[int, tuple[str, str]] = {}
    for pod_blob in protowire.fields_by_number(data).get(1, []):
        pod_fields = protowire.fields_by_number(pod_blob)
        name = (pod_fields.get(1, [b""])[0]).decode()
        namespace = (pod_fields.get(2, [b""])[0]).decode()
        for container_blob in pod_fields.get(3, []):
            container_fields = protowire.fields_by_number(container_blob)
            for device_blob in container_fields.get(2, []):
                device_fields = protowire.fields_by_number(device_blob)
                res = (device_fields.get(1, [b""])[0]).decode()
                if res != resource_name:
                    continue
                for device_id in device_fields.get(2, []):
                    idx = _device_index(device_id.decode(), resolve_uuid)
                    if idx is not None:
                        mapping[idx] = (namespace, name)
    return mapping


@dataclass
class PodResourcesClient:
    """gRPC client for the kubelet socket; raw-bytes marshalling so no
    generated stubs are needed (the request message is empty)."""

    socket_path: str = DEFAULT_SOCKET
    resource_name: str = GPU_RESOURCE
    resolve_uuid: Callable[[str], int | None] | None = None

    def list_allocations(self) -> dict[int, tuple[str, str]]:
        import grpc  # deferred: only the on-node daemon needs it

        channel = grpc.insecure_channel(f"unix://{self.socket_path}")
        try:
            call = channel.unary_unary(
                "/v1.PodResourcesLister/List",
                request_serializer=lambda _: b"",
                response_deserializer=lambda raw: raw,
            )
            raw = call(None, timeout=5.0)
            return parse_list_response(raw, self.resource_name, self.resolve_uuid)
        finally:
            channel.close()


class StaticAttributor:
    """Hardware-free attributor for tests and the headline loop."""

    def __init__(self, mapping: dict[int, tuple[str, str]] | None = None):
        self.mapping = dict(mapping or {})

    def list_allocations(self) -> dict[int, tuple[str, str]]:
        return dict(self.mapping)


class Attributor(Protocol):
    """Anything that can report {device_index: (namespace, pod)} allocations."""

    def list_allocations(self) -> dict[int, tuple[str, str]]: ...
