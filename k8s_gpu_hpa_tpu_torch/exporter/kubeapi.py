"""Kubernetes-API device→pod attributor: the stub exporter's e2e path.

Counterpart of ``k8s_gpu_hpa_tpu/exporter/kubeapi.py``, the same code.  On a
real GPU node the exporter attributes devices to pods through the kubelet
PodResources socket (podresources.py — the dcgm-exporter mechanism,
dcgm-exporter.yaml:50-52,57-59).  On a cluster with no accelerators (the kind
e2e harness), nothing allocates ``nvidia.com/gpu``, so the stub exporter
instead asks the API server which pods carry the workload label and deals
its synthetic devices across them round-robin.  Pure stdlib (urllib + the
in-cluster service-account token) — the exporter image needs no kubernetes
client dependency.
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.parse
import urllib.request

TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
CACERT_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


class KubeApiAttributor:
    """{chip_index: (namespace, pod)} by dealing chips across the running pods
    that match ``app_label``, newest-name-last for stable ordering.

    Needs RBAC: ``get``/``list`` on pods in the target namespace (the kind-e2e
    manifests ship the Role + binding).
    """

    def __init__(
        self,
        app_label: str,
        namespace: str = "default",
        num_chips: int = 4,
        api_base: str | None = None,
        token: str | None = None,
        cacert_path: str | None = None,
    ):
        self.app_label = app_label
        self.namespace = namespace
        self.num_chips = num_chips
        if api_base is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            api_base = f"https://{host}:{port}"
        self.api_base = api_base.rstrip("/")
        self._token = token
        self._cacert_path = cacert_path if cacert_path is not None else CACERT_PATH

    def _read_token(self) -> str:
        if self._token is not None:
            return self._token
        # re-read every call: service-account tokens rotate (BoundServiceAccountTokenVolume)
        with open(TOKEN_PATH) as f:
            return f.read().strip()

    def _context(self) -> ssl.SSLContext | None:
        if not self.api_base.startswith("https"):
            return None
        if os.path.exists(self._cacert_path):
            return ssl.create_default_context(cafile=self._cacert_path)
        return ssl.create_default_context()

    def _list_pods(self) -> list[dict]:
        selector = urllib.parse.quote(f"app={self.app_label}")
        url = (
            f"{self.api_base}/api/v1/namespaces/{self.namespace}/pods"
            f"?labelSelector={selector}"
        )
        req = urllib.request.Request(url)
        req.add_header("Authorization", f"Bearer {self._read_token()}")
        req.add_header("Accept", "application/json")
        with urllib.request.urlopen(req, timeout=5, context=self._context()) as r:
            return json.loads(r.read().decode()).get("items", [])

    def list_allocations(self) -> dict[int, tuple[str, str]]:
        running = sorted(
            pod["metadata"]["name"]
            for pod in self._list_pods()
            if pod.get("status", {}).get("phase") == "Running"
            and not pod["metadata"].get("deletionTimestamp")
        )
        if not running:
            return {}
        return {
            chip: (self.namespace, running[chip % len(running)])
            for chip in range(self.num_chips)
        }
