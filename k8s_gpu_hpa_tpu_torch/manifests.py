"""Manifest generation for GPU nodes: one source for the pipeline's string
contracts.

Counterpart of ``k8s_gpu_hpa_tpu/manifests.py``, cut to the manifests of
the pipelines the port runs.  The reference's five layers are joined only
by string contracts (a pod label, a metric name, a port name, a release
label) duplicated by hand across files, so breaking one string silently
breaks the loop.  Here every manifest is a function of the constants below
and of the port's own rule ASTs, HPA constants and behavior stanzas, so the
YAML an operator applies is what the port's closed loops test.  The
contracts are the JAX package's, string for string; only what a GPU node
needs changes:

- workloads request ``nvidia.com/gpu`` (the reference's request,
  cuda-test-deployment.yaml:20-22) instead of ``google.com/tpu``;
- pods select GKE's GPU node pools (``cloud.google.com/gke-accelerator``)
  and tolerate their ``nvidia.com/gpu`` taint, unless a ``node_selector``
  and ``tolerations`` replace them;
- the containers run the port's commands (``python -m
  k8s_gpu_hpa_tpu_torch.loadgen``, ``…loadgen.train``,
  ``…loadgen.multihost``, ``…exporter``, ``…control.operator``) in the
  port's images;
- the exporter DaemonSet reads the node's GPUs through NVML (``SOURCE=nvml``):
  it runs privileged with the host's driver libraries mounted, as the
  reference's dcgm-exporter does (dcgm-exporter.yaml:30-62), beside the
  kubelet pod-resources socket that ``exporter/podresources.py`` reads and
  the telemetry hostPath of the self-report.

``python -m k8s_gpu_hpa_tpu_torch.manifests --out DIR`` writes
``default_bundle()`` as one YAML file each; ``render_pipeline`` renders a
whole pipeline for any app, single-host or a StatefulSet of slices.  The
bundle also holds the CPU busy-loop and its Resource HPA, the JAX
package's, unchanged.  ``to_yaml`` writes YAML and ``load_yaml`` /
``load_yaml_all`` read the subset the shipped HPA files and ``to_yaml``
use, so the port needs no YAML library.
"""

from __future__ import annotations

import argparse
import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.control.hpa import (
    HBM_APP,
    HBM_MAX_REPLICAS,
    HBM_MIN_REPLICAS,
    HBM_SERIES,
    HBM_TARGET,
    MULTIHOST_MAX_REPLICAS,
    MULTIHOST_MIN_REPLICAS,
    MULTIHOST_QUANTUM,
    MULTIHOST_SERIES,
    MULTIHOST_TARGET,
    QUANTUM_ANNOTATION,
    QUEUE_APP,
    QUEUE_HPA,
    QUEUE_MAX_REPLICAS,
    QUEUE_MIN_REPLICAS,
    QUEUE_SELECTOR,
    QUEUE_SERIES,
    QUEUE_TARGET,
    TRAIN_BW_SERIES,
    TRAIN_BW_TARGET,
    TRAIN_DUTY_SERIES,
    TRAIN_DUTY_TARGET,
    HPABehavior,
    ScalingPolicy,
    ScalingRules,
    shipped_behavior,
    shipped_multihost_behavior,
)
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    SERVE_BW_TARGET,
    AlertRule,
    RecordingRule,
    shipped_alert_rules,
    tpu_test_avg_rule,
    tpu_test_multihost_avg_rule,
    tpu_test_pod_max_rule,
)
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_DUTY_CYCLE,
    TPU_HBM_BW_UTIL,
    TPU_HBM_USAGE,
    TPU_TENSORCORE_UTIL,
)
from k8s_gpu_hpa_tpu_torch.obs.slo import shipped_slo_alerts

# ---------------------------------------------------------------------------
# The string contracts: the JAX package's, unless a GPU node needs another.

EXPORTER_NAME = "tpu-metrics-exporter"  # DaemonSet/Service/scrape relabel key
EXPORTER_PORT = 9400  # dcgm-exporter's port (dcgm-exporter.yaml:31)
EXPORTER_PORT_NAME = "metrics"  # the *name* the scrape config binds to
EXPORTER_IMAGE = "ghcr.io/k8s-tpu-hpa/tpu-metrics-exporter-cuda:0.1.0"
WORKLOAD_IMAGE = "ghcr.io/k8s-tpu-hpa/tpu-test-cuda:0.1.0"
VERSION = "0.1.0"

SCRAPE_JOB = "tpu-metrics"
SCRAPE_INTERVAL = "1s"  # reference parity (kube-prometheus-stack-values.yaml:5)
RULE_INTERVAL = "1s"  # not Prometheus' default 30s: freshness bounds the loop
RELEASE_LABEL = "kube-prometheus-stack"  # the operator's rule-selector label
PROMETHEUS_URL = "http://kube-prometheus-stack-prometheus.default.svc.cluster.local"

GPU_RESOURCE = "nvidia.com/gpu"  # the device plugin's resource and node taint
ACCEL_H100 = "nvidia-h100-80gb"
NODE_SELECTOR_ACCEL = "cloud.google.com/gke-accelerator"

INTENSITY_FILE = "/tmp/tpu-test-intensity"  # the runtime load knob
COORDINATOR_PORT = 8476  # the slice's rendezvous port (multihost rung)

#: workload self-telemetry hostPath: pods write their report there, the
#: exporter DaemonSet reads it (loadgen/telemetry.py ↔ exporter/selfreport.py)
TELEMETRY_HOST_PATH = "/var/run/tpu-telemetry"
#: the kubelet's PodResources socket directory (exporter/podresources.py)
POD_RESOURCES_PATH = "/var/lib/kubelet/pod-resources"
#: where GKE installs the NVIDIA driver's libraries on a GPU node, and where
#: the exporter mounts them for NVML (``libnvidia-ml.so.1``)
NVIDIA_HOST_PATH = "/home/kubernetes/bin/nvidia"
NVIDIA_MOUNT_PATH = "/usr/local/nvidia"

#: device metric -> short stem used in recorded-series names
METRIC_STEMS = {
    TPU_TENSORCORE_UTIL: "tensorcore",
    TPU_DUTY_CYCLE: "duty_cycle",
    TPU_HBM_BW_UTIL: "hbm_bw",
    TPU_HBM_USAGE: "hbm_used_bytes",
}


def gpu_tolerations() -> list[dict]:
    return [{"key": GPU_RESOURCE, "operator": "Exists", "effect": "NoSchedule"}]


def _target(value: float) -> str:
    """An HPA target value as the manifests write it: ``40``, ``2.5``."""
    return f"{value:g}"


def _rules_doc(rules: ScalingRules) -> dict:
    return {
        "stabilizationWindowSeconds": int(rules.stabilization_window_seconds),
        "selectPolicy": rules.select_policy,
        "policies": [
            {"type": p.type, "value": p.value, "periodSeconds": int(p.period_seconds)}
            for p in rules.policies
        ],
    }


def behavior_doc(behavior: HPABehavior) -> dict:
    """The ``behavior:`` stanza of an HPA, from the behavior the port's HPA
    runs (``shipped_behavior()``, ``shipped_multihost_behavior()``)."""
    return {
        "scaleUp": _rules_doc(behavior.scale_up),
        "scaleDown": _rules_doc(behavior.scale_down),
    }


def object_metric(name: str, kind: str, target_name: str, value: str) -> dict:
    """One Object-type HPA metric entry (the reference's only metric shape,
    cuda-test-hpa.yaml:13-21, upgraded to autoscaling/v2)."""
    return {
        "type": "Object",
        "object": {
            "metric": {"name": name},
            "describedObject": {
                "apiVersion": "apps/v1",
                "kind": kind,
                "name": target_name,
            },
            "target": {"type": "Value", "value": value},
        },
    }


def pods_metric(name: str, average_value: str) -> dict:
    """One Pods-type HPA metric entry: a per-pod metric averaged over the
    target's pods against an AverageValue target."""
    return {
        "type": "Pods",
        "pods": {
            "metric": {"name": name},
            "target": {"type": "AverageValue", "averageValue": average_value},
        },
    }


def resource_metric(name: str, average_utilization: int) -> dict:
    """One Resource-type HPA metric entry: the pods' mean use of a resource,
    percent of their request (metrics.k8s.io)."""
    return {
        "type": "Resource",
        "resource": {
            "name": name,
            "target": {"type": "Utilization", "averageUtilization": average_utilization},
        },
    }


def external_metric(name: str, selector: dict[str, str], average_value: str) -> dict:
    """One External-type HPA metric entry: the sum of the series the label
    selector matches, per current replica against an AverageValue target."""
    return {
        "type": "External",
        "external": {
            "metric": {"name": name, "selector": {"matchLabels": dict(selector)}},
            "target": {"type": "AverageValue", "averageValue": average_value},
        },
    }


def hpa_manifest(
    name: str,
    *,
    target_kind: str = "Deployment",
    target_name: str | None = None,
    metrics: list[dict],
    min_replicas: int = 1,
    max_replicas: int = 4,
    behavior: dict | None = None,
    annotations: dict[str, str] | None = None,
) -> dict:
    doc: dict = {
        "apiVersion": "autoscaling/v2",
        "kind": "HorizontalPodAutoscaler",
        "metadata": {"name": name},
        "spec": {
            "scaleTargetRef": {
                "apiVersion": "apps/v1",
                "kind": target_kind,
                "name": target_name or name,
            },
            "minReplicas": min_replicas,
            "maxReplicas": max_replicas,
            "metrics": metrics,
            "behavior": behavior if behavior is not None else behavior_doc(shipped_behavior()),
        },
    }
    if annotations:
        doc["metadata"]["annotations"] = annotations
    return doc


def _placement(
    accelerator: str, node_selector: dict[str, str] | None, tolerations: list[dict] | None
) -> dict:
    """A pod's nodeSelector and tolerations: GKE's GPU node pool of
    ``accelerator``, or the given ones wholesale (clusters without GKE's
    labels; the reference labels its nodes by hand, README.md:26-30)."""
    return {
        "nodeSelector": (
            dict(node_selector)
            if node_selector is not None
            else {NODE_SELECTOR_ACCEL: accelerator}
        ),
        "tolerations": (
            [dict(t) for t in tolerations] if tolerations is not None else gpu_tolerations()
        ),
    }


def workload_deployment(
    name: str,
    *,
    command: list[str],
    env: dict[str, str],
    gpu_limit: int,
    accelerator: str = ACCEL_H100,
    container_name: str | None = None,
    node_selector: dict[str, str] | None = None,
    tolerations: list[dict] | None = None,
) -> dict:
    """A GPU workload Deployment (the reference's cuda-test-deployment.yaml):
    the ``app: <name>`` label is the pipeline join key, ``spec.replicas`` is
    absent so the HPA takes ownership, the intensity-file env gives the
    runtime load knob, and the telemetry hostPath with the Downward API's
    identity lets the workload self-report the gauges NVML cannot give
    (loadgen/telemetry.py)."""
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    **_placement(accelerator, node_selector, tolerations),
                    "containers": [
                        {
                            "name": container_name or name,
                            "image": WORKLOAD_IMAGE,
                            "command": command,
                            "env": [{"name": k, "value": v} for k, v in env.items()]
                            + telemetry_identity_env(queue=name),
                            "resources": {"limits": {GPU_RESOURCE: gpu_limit}},
                            "volumeMounts": [telemetry_volume_mount()],
                        }
                    ],
                    "volumes": [telemetry_volume()],
                },
            },
        },
    }


def telemetry_volume() -> dict:
    return {
        "name": "tpu-telemetry",
        "hostPath": {"path": TELEMETRY_HOST_PATH, "type": "DirectoryOrCreate"},
    }


def telemetry_volume_mount(read_only: bool = False) -> dict:
    """A workload's mount is its own ``<ns>_<pod>/`` subdirectory of the
    shared hostPath (``subPathExpr``), so a pod cannot write a report under
    another pod's identity; the exporter's read-only mount sees them all."""
    mount = {"name": "tpu-telemetry", "mountPath": TELEMETRY_HOST_PATH}
    if read_only:
        mount["readOnly"] = True
    else:
        mount["subPathExpr"] = "$(POD_NAMESPACE)_$(POD_NAME)"
    return mount


def telemetry_identity_env(queue: str) -> list[dict]:
    """TPU_TELEMETRY_DIR and the Downward API's pod identity the self-report
    carries."""
    return [
        {"name": "TPU_TELEMETRY_DIR", "value": TELEMETRY_HOST_PATH},
        {"name": "QUEUE_NAME", "value": queue},
        {"name": "POD_NAME", "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}}},
        {
            "name": "POD_NAMESPACE",
            "valueFrom": {"fieldRef": {"fieldPath": "metadata.namespace"}},
        },
    ]


def loadgen_env(intensity: str = "0.5", matmul_size: str = "4096") -> dict[str, str]:
    return {
        "MATMUL_SIZE": matmul_size,
        "TPU_TEST_INTENSITY": intensity,
        "TPU_TEST_INTENSITY_FILE": INTENSITY_FILE,
    }


# ---------------------------------------------------------------------------
# L2: the exporter DaemonSet + Service (the reference's dcgm-exporter.yaml).


def exporter_daemonset(
    accelerator: str = ACCEL_H100,
    *,
    node_selector: dict[str, str] | None = None,
    tolerations: list[dict] | None = None,
) -> dict:
    labels = {
        "app.kubernetes.io/name": EXPORTER_NAME,
        "app.kubernetes.io/version": VERSION,
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {"name": EXPORTER_NAME, "labels": dict(labels)},
        "spec": {
            "updateStrategy": {"type": "RollingUpdate"},
            "selector": {"matchLabels": {"app.kubernetes.io/name": EXPORTER_NAME}},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    **_placement(accelerator, node_selector, tolerations),
                    "hostNetwork": True,
                    "containers": [
                        {
                            "name": "exporter",
                            "image": EXPORTER_IMAGE,
                            "command": ["python", "-m", "k8s_gpu_hpa_tpu_torch.exporter"],
                            "env": [
                                {"name": "SOURCE", "value": "nvml"},
                                {"name": "LD_LIBRARY_PATH", "value": f"{NVIDIA_MOUNT_PATH}/lib64"},
                                {"name": "LISTEN_PORT", "value": str(EXPORTER_PORT)},
                                {"name": "COLLECT_MS", "value": "1000"},
                                {"name": "TPU_TELEMETRY_DIR", "value": TELEMETRY_HOST_PATH},
                                {
                                    "name": "NODE_NAME",
                                    "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}},
                                },
                            ],
                            "ports": [{"name": EXPORTER_PORT_NAME, "containerPort": EXPORTER_PORT}],
                            # NVML opens every GPU's device node, which a pod
                            # that requests no nvidia.com/gpu is not given
                            "securityContext": {"privileged": True},
                            "volumeMounts": [
                                {
                                    "name": "pod-resources",
                                    "mountPath": POD_RESOURCES_PATH,
                                    "readOnly": True,
                                },
                                {
                                    "name": "nvidia-install-dir-host",
                                    "mountPath": NVIDIA_MOUNT_PATH,
                                    "readOnly": True,
                                },
                                telemetry_volume_mount(read_only=True),
                            ],
                        }
                    ],
                    "volumes": [
                        {"name": "pod-resources", "hostPath": {"path": POD_RESOURCES_PATH}},
                        {"name": "nvidia-install-dir-host", "hostPath": {"path": NVIDIA_HOST_PATH}},
                        telemetry_volume(),
                    ],
                },
            },
        },
    }


def exporter_service() -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": EXPORTER_NAME,
            "labels": {"app.kubernetes.io/name": EXPORTER_NAME},
        },
        "spec": {
            "selector": {"app.kubernetes.io/name": EXPORTER_NAME},
            "ports": [{"name": EXPORTER_PORT_NAME, "port": EXPORTER_PORT}],
        },
    }


# ---------------------------------------------------------------------------
# L3: Prometheus stack values + PrometheusRule.


def prom_stack_values() -> dict:
    """Helm values for kube-prometheus-stack: the 1 s ``tpu-metrics`` scrape
    job with the reference's node relabel (kube-prometheus-stack-values.yaml:
    13-16) and keep-filters pinning it to the exporter Service's named port,
    and the ``quantum-operator`` job that scrapes the slice-quantum
    operator's own families from its health port."""
    return {
        "prometheus": {
            "prometheusSpec": {
                "additionalScrapeConfigs": [
                    {
                        "job_name": SCRAPE_JOB,
                        "scrape_interval": SCRAPE_INTERVAL,
                        "metrics_path": "/metrics",
                        "kubernetes_sd_configs": [
                            {"role": "endpoints", "namespaces": {"names": ["default"]}}
                        ],
                        "relabel_configs": [
                            {
                                "source_labels": ["__meta_kubernetes_service_name"],
                                "regex": EXPORTER_NAME,
                                "action": "keep",
                            },
                            {
                                "source_labels": ["__meta_kubernetes_endpoint_port_name"],
                                "regex": EXPORTER_PORT_NAME,
                                "action": "keep",
                            },
                            {
                                "source_labels": ["__meta_kubernetes_pod_node_name"],
                                "separator": ";",
                                "regex": "^(.*)$",
                                "target_label": "node",
                                "replacement": "$1",
                                "action": "replace",
                            },
                        ],
                    },
                    {
                        # control/operator.py::OperatorMetrics: its counters
                        # and the partial_slice_held gauge that the
                        # TpuSliceHeldPartial alert reads
                        "job_name": "quantum-operator",
                        "scrape_interval": "15s",
                        "metrics_path": "/metrics",
                        "kubernetes_sd_configs": [
                            {"role": "pod", "namespaces": {"names": ["default"]}}
                        ],
                        "relabel_configs": [
                            {
                                "source_labels": ["__meta_kubernetes_pod_label_app"],
                                "regex": "quantum-operator",
                                "action": "keep",
                            },
                            {
                                "source_labels": ["__meta_kubernetes_pod_container_port_name"],
                                "regex": "health",
                                "action": "keep",
                            },
                        ],
                    },
                ]
            }
        }
    }


def _rule_entry(rule: RecordingRule) -> dict:
    entry: dict = {"record": rule.record, "expr": rule.expr.promql()}
    if rule.labels:
        entry["labels"] = dict(rule.labels)
    return entry


def _alert_entry(rule: AlertRule) -> dict:
    entry: dict = {"alert": rule.alert, "expr": rule.expr.promql()}
    if rule.for_seconds:
        entry["for"] = f"{int(rule.for_seconds)}s"
    if rule.labels:
        entry["labels"] = dict(rule.labels)
    if rule.annotations:
        entry["annotations"] = dict(rule.annotations)
    return entry


def shipped_rule_groups() -> list[tuple[str, list[RecordingRule]]]:
    """Every recording rule the port's loops evaluate, grouped as in
    deploy/tpu-test-prometheusrule.yaml, from the same ASTs the loops run
    (metrics/rules.py)."""
    return [
        (
            "tpu-test",
            [
                tpu_test_avg_rule(),
                tpu_test_avg_rule(metric=TPU_DUTY_CYCLE, record="tpu_test_duty_cycle_avg"),
                tpu_test_avg_rule(metric=TPU_HBM_BW_UTIL, record="tpu_test_hbm_bw_avg"),
            ],
        ),
        (HBM_APP, [tpu_test_pod_max_rule(app=HBM_APP, record=HBM_SERIES)]),
        (
            "tpu-serve",
            [
                tpu_test_avg_rule(
                    app="tpu-serve", deployment="tpu-serve", metric=TPU_HBM_BW_UTIL,
                    record="tpu_serve_hbm_bw_avg",
                )
            ],
        ),
        (
            "tpu-train",
            [
                tpu_test_avg_rule(
                    app="tpu-train", deployment="tpu-train", metric=TPU_DUTY_CYCLE,
                    record=TRAIN_DUTY_SERIES,
                ),
                tpu_test_avg_rule(
                    app="tpu-train", deployment="tpu-train", metric=TPU_HBM_BW_UTIL,
                    record=TRAIN_BW_SERIES,
                ),
            ],
        ),
        ("tpu-test-multihost", [tpu_test_multihost_avg_rule(record=MULTIHOST_SERIES)]),
    ]


def prometheusrule_manifest(
    name: str = "tpu-test",
    groups: list[tuple[str, list[RecordingRule]]] | None = None,
) -> dict:
    """A PrometheusRule of recording-rule groups.  With none given it is the
    shipped one: every recording rule, then ``tpu-pipeline-alerts``
    (``shipped_alert_rules``) and ``tpu-slo-burn`` (the pipeline's SLO
    burn-rate pairs).  Given groups carry no alert group."""
    group_docs = [
        {"name": group_name, "interval": RULE_INTERVAL, "rules": [_rule_entry(r) for r in rules]}
        for group_name, rules in (groups or shipped_rule_groups())
    ]
    if groups is None:
        group_docs += [
            {"name": "tpu-pipeline-alerts", "interval": RULE_INTERVAL,
             "rules": [_alert_entry(a) for a in shipped_alert_rules()]},
            {"name": "tpu-slo-burn", "interval": RULE_INTERVAL,
             "rules": [_alert_entry(a) for a in shipped_slo_alerts()]},
        ]
    return {
        "apiVersion": "monitoring.coreos.com/v1",
        "kind": "PrometheusRule",
        "metadata": {"name": name, "labels": {"release": RELEASE_LABEL}},
        "spec": {"groups": group_docs},
    }


# ---------------------------------------------------------------------------
# L4: prometheus-adapter values (explicit rules, not default discovery).


def adapter_rule(series: str, resource: str = "deployment") -> dict:
    """One explicit seriesQuery rule: expose ``series`` addressed by its
    ``namespace`` and object labels (the association trick of
    cuda-test-prometheusrule.yaml:14-16, made explicit)."""
    return {
        "seriesQuery": f'{series}{{namespace!="",{resource}!=""}}',
        "resources": {
            "overrides": {
                "namespace": {"resource": "namespace"},
                resource: {"resource": resource},
            }
        },
        "name": {"as": series},
        "metricsQuery": "max by (<<.GroupBy>>) (<<.Series>>{<<.LabelMatchers>>})",
    }


def external_rule(series: str) -> dict:
    """One ``externalRules`` entry: ``series`` served on
    ``external.metrics.k8s.io``, addressed by name and label selector within
    the namespace, associated with no Kubernetes object (the queue-depth
    idiom); the API sums the matched series by the selector's labels."""
    return {
        "seriesQuery": f'{series}{{namespace!=""}}',
        "resources": {"overrides": {"namespace": {"resource": "namespace"}}},
        "name": {"as": series},
        "metricsQuery": "sum by (<<.GroupBy>>) (<<.Series>>{<<.LabelMatchers>>})",
    }


def adapter_values(
    rules: list[dict] | None = None, external_rules: list[dict] | None = None
) -> dict:
    """The adapter's values: the custom-metrics rules (Object metrics on
    their objects, the HBM series on its pods) and the external rules (the
    serving queue's depth)."""
    if rules is None:
        rules = [
            adapter_rule("tpu_test_tensorcore_avg"),
            adapter_rule("tpu_test_duty_cycle_avg"),
            adapter_rule("tpu_test_hbm_bw_avg"),
            adapter_rule(HBM_SERIES, resource="pod"),
            adapter_rule("tpu_serve_hbm_bw_avg"),
            adapter_rule(TRAIN_DUTY_SERIES),
            adapter_rule(TRAIN_BW_SERIES),
            adapter_rule(MULTIHOST_SERIES, resource="statefulset"),
        ]
    if external_rules is None:
        external_rules = [external_rule(QUEUE_SERIES)]
    return {
        "prometheus": {"url": PROMETHEUS_URL, "port": 9090},
        "rules": {"default": False, "custom": rules, "external": external_rules},
    }


# ---------------------------------------------------------------------------
# The bundle: every manifest of the port's pipelines.


def _tpu_test_deployment() -> dict:
    return workload_deployment(
        "tpu-test",
        command=["python", "-m", "k8s_gpu_hpa_tpu_torch.loadgen"],
        env=loadgen_env(),
        gpu_limit=1,
    )


def _tpu_test_v5e8_deployment() -> dict:
    """The HBM rung's workload: one pod on the whole of an 8-GPU H100 node
    (GKE's a3-highgpu-8g pool), the matmul container at 8192 over all its
    GPUs, each running its own product chain."""
    return workload_deployment(
        HBM_APP,
        command=["python", "-m", "k8s_gpu_hpa_tpu_torch.loadgen"],
        env=loadgen_env(matmul_size="8192"),
        gpu_limit=8,
        container_name="tpu-test",
    )


def hbm_hpa_doc() -> dict:
    """deploy/tpu-test-hbm-hpa.yaml: the Pods metric on the per-pod
    hottest device's bytes in use, AverageValue 13Gi, pods 1..4."""
    return hpa_manifest(
        HBM_APP,
        metrics=[pods_metric(HBM_SERIES, HBM_TARGET)],
        min_replicas=HBM_MIN_REPLICAS,
        max_replicas=HBM_MAX_REPLICAS,
    )


def external_hpa_doc() -> dict:
    """deploy/tpu-test-external-hpa.yaml: the External metric on the serving
    fleet's queue depth under ``queue=tpu-serve``, AverageValue 100 a
    replica, on the tpu-serve Deployment, pods 1..4."""
    return hpa_manifest(
        QUEUE_HPA,
        target_name=QUEUE_APP,
        metrics=[external_metric(QUEUE_SERIES, QUEUE_SELECTOR, QUEUE_TARGET)],
        min_replicas=QUEUE_MIN_REPLICAS,
        max_replicas=QUEUE_MAX_REPLICAS,
    )


def _tpu_serve_deployment() -> dict:
    return workload_deployment(
        "tpu-serve",
        command=["python", "-m", "k8s_gpu_hpa_tpu_torch.loadgen"],
        env={
            "WORKLOAD": "decode",
            "DECODE_BATCH": "8",
            "MAX_SEQ": "2048",
            "D_MODEL": "512",
            # head_dim 128 (512/4): the prefill rides the flash kernel
            "N_HEADS": "4",
            "N_LAYERS": "4",
            "PREFILL_LEN": "512",
            "TPU_TEST_INTENSITY": "1.0",
            "TPU_TEST_INTENSITY_FILE": INTENSITY_FILE,
        },
        gpu_limit=1,
    )


def _tpu_train_deployment() -> dict:
    return workload_deployment(
        "tpu-train",
        command=["python", "-m", "k8s_gpu_hpa_tpu_torch.loadgen.train"],
        env={
            "BATCH_SIZE": "256",
            "IMAGE_SIZE": "32",
            "TPU_TEST_INTENSITY": "1.0",
            "TPU_TEST_INTENSITY_FILE": INTENSITY_FILE,
        },
        gpu_limit=4,
    )


def _cpu_busyloop() -> dict:
    """The rung without an accelerator: a shell busy-loop whose CPU use,
    against its 500m request, a Resource HPA scales on.  It is the JAX
    package's Deployment unchanged, as it asks for no device."""
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": "cpu-busyloop", "labels": {"app": "cpu-busyloop"}},
        "spec": {
            "selector": {"matchLabels": {"app": "cpu-busyloop"}},
            "template": {
                "metadata": {"labels": {"app": "cpu-busyloop"}},
                "spec": {
                    "containers": [
                        {
                            "name": "busyloop",
                            "image": "busybox:1.36",
                            "command": ["sh", "-c", "while :; do :; done"],
                            "resources": {"requests": {"cpu": "500m"}, "limits": {"cpu": "1"}},
                        }
                    ]
                },
            },
        },
    }


def cpu_busyloop_hpa_doc() -> dict:
    """deploy/cpu-busyloop-hpa.yaml: the Resource metric on cpu at 60% of
    the request, pods 1..4, the shipped behavior but for the scale-up's
    Percent policy: 2 pods a 15 s period."""
    behavior = shipped_behavior()
    behavior.scale_up.policies = [ScalingPolicy("Pods", 2, 15.0)]
    return hpa_manifest(
        "cpu-busyloop",
        metrics=[resource_metric("cpu", 60)],
        behavior=behavior_doc(behavior),
    )


def multihost_service(name: str = "tpu-test-multihost") -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {
            # the literal string "None" is the headless-service sentinel
            "clusterIP": "None",
            # the coordinator's DNS must exist while it is still starting
            "publishNotReadyAddresses": True,
            "selector": {"app": name},
            "ports": [{"name": "coordinator", "port": COORDINATOR_PORT}],
        },
    }


def multihost_statefulset(
    name: str = "tpu-test-multihost",
    *,
    hosts_per_slice: int = MULTIHOST_QUANTUM,
    gpu_limit: int = 4,
    accelerator: str = ACCEL_H100,
    intensity: str = "0.5",
    node_selector: dict[str, str] | None = None,
    tolerations: list[dict] | None = None,
) -> dict:
    """One StatefulSet holds every slice: pod ordinal N is worker N %
    hosts_per_slice of slice N // hosts_per_slice, whose worker 0 is the
    rendezvous at the headless service's per-pod DNS
    (loadgen/multihost.py::topology_from_env)."""
    return {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {
            "serviceName": name,
            "podManagementPolicy": "Parallel",  # slice hosts start together
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    **_placement(accelerator, node_selector, tolerations),
                    "containers": [
                        {
                            "name": "tpu-test",
                            "image": WORKLOAD_IMAGE,
                            "command": [
                                "python", "-m", "k8s_gpu_hpa_tpu_torch.loadgen.multihost",
                            ],
                            "env": [
                                {"name": "HOSTS_PER_SLICE", "value": str(hosts_per_slice)},
                                {"name": "HEADLESS_SERVICE", "value": name},
                                {
                                    "name": "POD_NAMESPACE",
                                    "valueFrom": {
                                        "fieldRef": {"fieldPath": "metadata.namespace"}
                                    },
                                },
                                {"name": "BUFFER_MB", "value": "64"},
                                {"name": "TPU_TEST_INTENSITY", "value": intensity},
                                {"name": "TPU_TEST_INTENSITY_FILE", "value": INTENSITY_FILE},
                            ],
                            "ports": [{"name": "coordinator", "containerPort": COORDINATOR_PORT}],
                            "resources": {"limits": {GPU_RESOURCE: gpu_limit}},
                        }
                    ],
                },
            },
        },
    }


def multihost_hpa(
    name: str, record: str, target: str, quantum: int, min_slices: int, max_slices: int
) -> dict:
    """The slice HPA: its Object metric on the StatefulSet, bounds in whole
    slices, the quantum annotation, and a behavior in slices."""
    return hpa_manifest(
        name,
        target_kind="StatefulSet",
        metrics=[object_metric(record, "StatefulSet", name, target)],
        min_replicas=min_slices * quantum,
        max_replicas=max_slices * quantum,
        annotations={QUANTUM_ANNOTATION: str(quantum)},
        behavior=behavior_doc(shipped_multihost_behavior(quantum)),
    )


def quantum_operator_bundle() -> list[dict]:
    """The slice-quantum operator (control/operator.py): its ServiceAccount,
    the RBAC to read HPAs, patch scale subresources and hold its Lease, and
    the Deployment of one replica, running the port's operator in the
    exporter's image."""
    name = "quantum-operator"
    return [
        {"apiVersion": "v1", "kind": "ServiceAccount", "metadata": {"name": name}},
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "Role",
            "metadata": {"name": name},
            "rules": [
                {
                    "apiGroups": ["autoscaling"],
                    "resources": ["horizontalpodautoscalers"],
                    "verbs": ["get", "list"],
                },
                {
                    "apiGroups": ["apps"],
                    "resources": ["deployments/scale", "statefulsets/scale", "replicasets/scale"],
                    "verbs": ["get", "patch"],
                },
                {
                    # the election's Lease, for the rolling update's overlap
                    "apiGroups": ["coordination.k8s.io"],
                    "resources": ["leases"],
                    "verbs": ["get", "create", "patch"],
                },
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {"name": name},
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "Role", "name": name},
            "subjects": [{"kind": "ServiceAccount", "name": name}],
        },
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "labels": {"app": name}},
            "spec": {
                "replicas": 1,
                # Recreate: a surge pod could never pass /readyz while the
                # old one holds the Lease (maxUnavailable rounds to 0 at one
                # replica), so the rollout would stall
                "strategy": {"type": "Recreate"},
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": {
                        "serviceAccountName": name,
                        "containers": [
                            {
                                "name": "operator",
                                "image": EXPORTER_IMAGE,
                                "command": [
                                    "python", "-m", "k8s_gpu_hpa_tpu_torch.control.operator",
                                ],
                                "env": [
                                    {
                                        "name": "NAMESPACE",
                                        "valueFrom": {
                                            "fieldRef": {"fieldPath": "metadata.namespace"}
                                        },
                                    },
                                    {
                                        "name": "POD_NAME",
                                        "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}},
                                    },
                                    {"name": "INTERVAL_S", "value": "5"},
                                    {"name": "HEALTH_PORT", "value": "8086"},
                                ],
                                "ports": [{"name": "health", "containerPort": 8086}],
                                # /healthz goes stale when the loop hangs;
                                # /readyz also wants the Lease held
                                "livenessProbe": {
                                    "httpGet": {"path": "/healthz", "port": "health"},
                                    "initialDelaySeconds": 10,
                                    "periodSeconds": 15,
                                },
                                "readinessProbe": {
                                    "httpGet": {"path": "/readyz", "port": "health"},
                                    "initialDelaySeconds": 5,
                                    "periodSeconds": 10,
                                },
                                "resources": {"requests": {"cpu": "10m", "memory": "64Mi"}},
                            }
                        ],
                    },
                },
            },
        },
    ]


def default_bundle() -> dict[str, list[dict]]:
    """filename -> documents, for every manifest of the port's pipelines:
    the exporter, the Prometheus and adapter values, the PrometheusRule,
    each of the five workloads with its HPA, the serving fleet's
    queue-depth HPA, the slice-quantum operator, and the CPU busy-loop with
    its Resource HPA."""
    return {
        "tpu-metrics-exporter.yaml": [exporter_daemonset(), exporter_service()],
        "kube-prometheus-stack-values.yaml": [prom_stack_values()],
        "prometheus-adapter-values.yaml": [adapter_values()],
        "tpu-test-prometheusrule.yaml": [prometheusrule_manifest()],
        "tpu-test-deployment.yaml": [_tpu_test_deployment()],
        "tpu-test-hpa.yaml": [
            hpa_manifest(
                "tpu-test",
                metrics=[object_metric("tpu_test_tensorcore_avg", "Deployment", "tpu-test", "40")],
            )
        ],
        "tpu-test-v5e8-deployment.yaml": [_tpu_test_v5e8_deployment()],
        "tpu-test-hbm-hpa.yaml": [hbm_hpa_doc()],
        "tpu-serve-deployment.yaml": [_tpu_serve_deployment()],
        "tpu-serve-hpa.yaml": [
            hpa_manifest(
                "tpu-serve",
                metrics=[object_metric(
                    "tpu_serve_hbm_bw_avg", "Deployment", "tpu-serve", _target(SERVE_BW_TARGET)
                )],
            )
        ],
        "tpu-train-deployment.yaml": [_tpu_train_deployment()],
        "tpu-train-hpa.yaml": [
            hpa_manifest(
                "tpu-train",
                metrics=[
                    object_metric(
                        TRAIN_DUTY_SERIES, "Deployment", "tpu-train", _target(TRAIN_DUTY_TARGET)
                    ),
                    object_metric(
                        TRAIN_BW_SERIES, "Deployment", "tpu-train", _target(TRAIN_BW_TARGET)
                    ),
                ],
            )
        ],
        "tpu-test-external-hpa.yaml": [external_hpa_doc()],
        "tpu-test-multihost.yaml": [multihost_service(), multihost_statefulset()],
        "tpu-test-multihost-hpa.yaml": [
            multihost_hpa(
                "tpu-test-multihost", MULTIHOST_SERIES, _target(MULTIHOST_TARGET),
                MULTIHOST_QUANTUM, MULTIHOST_MIN_REPLICAS // MULTIHOST_QUANTUM,
                MULTIHOST_MAX_REPLICAS // MULTIHOST_QUANTUM,
            )
        ],
        "quantum-operator.yaml": quantum_operator_bundle(),
        "cpu-busyloop.yaml": [_cpu_busyloop()],
        "cpu-busyloop-hpa.yaml": [cpu_busyloop_hpa_doc()],
    }


# ---------------------------------------------------------------------------
# Parameterized pipelines: the whole vertical stack for any app.


@dataclass
class PipelineSpec:
    """A complete autoscaling pipeline for one GPU workload: workload,
    recording rule, adapter rule and HPA, with every string contract derived
    from ``app`` once, so they cannot drift."""

    app: str
    device_metric: str = TPU_TENSORCORE_UTIL
    target: str = "40"
    min_replicas: int = 1
    max_replicas: int = 4
    gpu_limit: int = 1
    accelerator: str = ACCEL_H100
    namespace: str = "default"
    intensity: str = "0.5"
    command: list[str] = field(
        default_factory=lambda: ["python", "-m", "k8s_gpu_hpa_tpu_torch.loadgen"]
    )
    #: >1 renders the multi-host shape: StatefulSet of slices, headless
    #: service and the slice-quantum HPA (one logical replica = this many pods)
    hosts_per_slice: int = 1
    #: slices at min/max for the multi-host shape (pods = slices * hosts)
    min_slices: int = 1
    max_slices: int = 4
    #: clusters without GKE's labels: the node labels and taints to use
    #: instead; the pipeline then carries its own exporter DaemonSet, since
    #: the bundle's GKE-labelled one would not schedule there
    node_selector: dict[str, str] | None = None
    tolerations: list[dict] | None = None

    def __post_init__(self) -> None:
        # RFC 1123 label: what every derived contract must survive (object
        # names, the app label, and via '-'→'_' the recorded series name)
        if not re.fullmatch(r"[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?", self.app):
            raise ValueError(
                f"app {self.app!r} is not a DNS-1123 label (lowercase "
                "alphanumerics and '-', at most 63 chars, alphanumeric ends)"
            )
        if self.device_metric not in METRIC_STEMS:
            raise ValueError(
                f"unknown device metric {self.device_metric!r}; one of {sorted(METRIC_STEMS)}"
            )

    @property
    def record(self) -> str:
        """The recorded series' name, derived from the app's as the
        reference derives cuda_test_gpu_avg from cuda-test."""
        return f"{self.app.replace('-', '_')}_{METRIC_STEMS[self.device_metric]}_avg"

    @property
    def multihost(self) -> bool:
        return self.hosts_per_slice > 1

    def recording_rule(self) -> RecordingRule:
        if self.multihost:
            return tpu_test_multihost_avg_rule(
                app=self.app, statefulset=self.app, namespace=self.namespace,
                metric=self.device_metric, record=self.record,
            )
        return tpu_test_avg_rule(
            app=self.app, deployment=self.app, namespace=self.namespace,
            metric=self.device_metric, record=self.record,
        )


def render_pipeline(spec: PipelineSpec) -> dict[str, list[dict]]:
    """filename -> documents for the app's own artifacts of one pipeline.

    The shared layers (exporter DaemonSet, Prometheus values) come from
    ``default_bundle()``; the adapter values here carry this pipeline's rule
    alone: merge them into the adapter's config beside others.
    ``hosts_per_slice > 1`` renders the multi-host shape: headless Service
    and StatefulSet of slices, the rule addressed at the StatefulSet, and
    the slice-quantum HPA."""
    extra: dict[str, list[dict]] = {}
    if spec.node_selector is not None:
        extra[f"{spec.app}-exporter-daemonset.yaml"] = [
            exporter_daemonset(
                spec.accelerator, node_selector=spec.node_selector, tolerations=spec.tolerations
            ),
            exporter_service(),
        ]
    rules = [
        prometheusrule_manifest(spec.app, groups=[(spec.app, [spec.recording_rule()])])
    ]
    if spec.multihost:
        q = spec.hosts_per_slice
        return {
            f"{spec.app}-statefulset.yaml": [
                multihost_service(spec.app),
                multihost_statefulset(
                    spec.app, hosts_per_slice=q, gpu_limit=spec.gpu_limit,
                    accelerator=spec.accelerator, intensity=spec.intensity,
                    node_selector=spec.node_selector, tolerations=spec.tolerations,
                ),
            ],
            **extra,
            f"{spec.app}-prometheusrule.yaml": rules,
            f"{spec.app}-adapter-values.yaml": [
                adapter_values([adapter_rule(spec.record, resource="statefulset")],
                               external_rules=[])
            ],
            f"{spec.app}-hpa.yaml": [
                multihost_hpa(spec.app, spec.record, spec.target, q, spec.min_slices,
                              spec.max_slices)
            ],
        }
    return {
        f"{spec.app}-deployment.yaml": [
            workload_deployment(
                spec.app, command=spec.command, env=loadgen_env(intensity=spec.intensity),
                gpu_limit=spec.gpu_limit, accelerator=spec.accelerator,
                node_selector=spec.node_selector, tolerations=spec.tolerations,
            )
        ],
        **extra,
        f"{spec.app}-prometheusrule.yaml": rules,
        f"{spec.app}-adapter-values.yaml": [
            adapter_values([adapter_rule(spec.record)], external_rules=[])
        ],
        f"{spec.app}-hpa.yaml": [
            hpa_manifest(
                spec.app,
                metrics=[object_metric(spec.record, "Deployment", spec.app, spec.target)],
                min_replicas=spec.min_replicas,
                max_replicas=spec.max_replicas,
            )
        ],
    }


#: a string that YAML reads back as the same string when written plain
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*")
#: plain words YAML 1.1 reads as booleans or null
_RESERVED = {"true", "false", "yes", "no", "on", "off", "y", "n", "null", "~"}


def _scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text:  # YAML 1.1 floats need the point
            mantissa, exponent = text.split("e")
            text = f"{mantissa}.0e{exponent}"
        return text
    text = str(value)
    if _PLAIN.fullmatch(text) and text.lower() not in _RESERVED:
        return text
    return json.dumps(text)  # a double-quoted YAML scalar: JSON's escapes are YAML's


def _emit(node, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key, value in node.items():
            if isinstance(value, (dict, list)) and value:
                out.append(f"{pad}{_scalar(key)}:")
                _emit(value, indent + 2, out)
            else:
                out.append(f"{pad}{_scalar(key)}: {_block_or_scalar(value)}")
    else:
        for item in node:
            if isinstance(item, (dict, list)) and item:
                lines: list[str] = []
                _emit(item, indent + 2, lines)
                out.append(f"{pad}- {lines[0][indent + 2:]}" if isinstance(item, dict) else f"{pad}-")
                out.extend(lines[1:] if isinstance(item, dict) else lines)
            else:
                out.append(f"{pad}- {_block_or_scalar(item)}")


def _block_or_scalar(value) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def to_yaml(docs: list[dict]) -> str:
    """The documents as one YAML stream, in block style, keys in their
    order.  Written here, so that the generator needs no YAML library."""
    texts = []
    for doc in docs:
        lines: list[str] = []
        _emit(doc, 0, lines)
        texts.append("\n".join(lines) + "\n")
    return "---\n".join(texts)


# ---------------------------------------------------------------------------
# Reading YAML back: the subset the shipped HPA files and ``to_yaml`` use.

#: YAML 1.1's implicit scalar types, as a safe loader resolves plain scalars
_YAML_BOOL = re.compile(
    r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF"
)
_YAML_NULL = re.compile(r"~|null|Null|NULL")
_YAML_INT = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
)
_YAML_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
)
#: a plain scalar that a YAML 1.1 loader would read as a date or time
_YAML_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
#: characters that cannot begin a plain scalar here: flow, anchor, alias,
#: tag, block-scalar, directive and reserved indicators
_YAML_INDICATORS = set("[]{},#&*!|>%@`")
_YAML_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
    "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
    "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_YAML_HEX = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


def _yaml_error(no: int, message: str) -> ValueError:
    return ValueError(f"YAML line {no}: {message}")


def _sexagesimal(text: str, cast):
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve_plain(text: str, no: int):
    """A plain scalar's value by YAML 1.1's implicit types."""
    if _YAML_NULL.fullmatch(text):
        return None
    if _YAML_BOOL.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _YAML_INT.fullmatch(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits.startswith("0"):
            return sign * int(digits, 8)
        if ":" in digits:
            return sign * _sexagesimal(digits, int)
        return sign * int(digits)
    if _YAML_FLOAT.fullmatch(text):
        digits = text.replace("_", "").lower()
        sign = -1.0 if digits[0] == "-" else 1.0
        digits = digits.lstrip("+-")
        if digits == ".inf":
            return sign * math.inf
        if digits == ".nan":
            return math.nan
        if ":" in digits:
            return sign * _sexagesimal(digits, float)
        return sign * float(digits)
    if _YAML_TIMESTAMP.match(text):
        raise _yaml_error(no, f"timestamps are not supported: {text!r}")
    if text in ("<<", "="):
        raise _yaml_error(no, f"merge and value keys are not supported: {text!r}")
    return text


def _after_scalar(text: str, pos: int, no: int) -> None:
    """Only blanks and a comment may follow a scalar on its line."""
    rest = text[pos:]
    if rest.strip() and not (rest.lstrip().startswith("#") and rest[:1] in (" ", "\t")):
        raise _yaml_error(no, f"unexpected text after a scalar: {rest.strip()!r}")


def _scan_quoted(text: str, pos: int, no: int) -> tuple[str, int]:
    """The quoted scalar starting at ``pos`` and the index after its close."""
    quote = text[pos]
    out: list[str] = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
        elif c == '"':
            return "".join(out), i + 1
        elif c == "\\":
            code = text[i + 1:i + 2]
            if code in _YAML_ESCAPES:
                out.append(_YAML_ESCAPES[code])
                i += 2
                continue
            width = _YAML_HEX.get(code)
            digits = text[i + 2:i + 2 + width] if width else ""
            if not width or len(digits) != width or any(
                    d not in "0123456789abcdefABCDEF" for d in digits):
                raise _yaml_error(
                    no, f"unsupported escape in a double-quoted scalar: {text[i:i + 2]!r}"
                )
            out.append(chr(int(digits, 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise _yaml_error(no, "a quoted scalar must close on its line")


def _plain(text: str, no: int):
    """A plain scalar that runs to the end of ``text`` (its comment cut)."""
    if text[0] in _YAML_INDICATORS or (text[0] in "-?:" and text[1:2] in ("", " ")):
        raise _yaml_error(no, f"unsupported construct: {text!r}")
    cut = re.search(r"[ \t]#", text)
    value = (text[:cut.start()] if cut else text).rstrip()
    if ": " in value or value.endswith(":") or "\t" in value:
        raise _yaml_error(no, f"a mapping is not allowed here: {value!r}")
    return _resolve_plain(value, no)


def _flow_sequence(text: str, no: int) -> tuple[list, int]:
    """A one-line flow sequence of scalars, ``[a, "b", 3]``."""
    items: list = []
    i = 1
    while True:
        while text[i:i + 1] == " ":
            i += 1
        if text[i:i + 1] == "]" and not items:
            return items, i + 1
        if i >= len(text):
            raise _yaml_error(no, "a flow sequence must close on its line")
        if text[i] in "'\"":
            value, i = _scan_quoted(text, i, no)
        else:
            m = re.compile(r"[^,\[\]{}#]*").match(text, i)
            raw = m.group().rstrip()
            if not raw or text[m.end():m.end() + 1] in ("[", "{", "#"):
                raise _yaml_error(no, f"only scalars are supported in a flow sequence: {text!r}")
            value, i = _plain(raw, no), m.end()
        items.append(value)
        while text[i:i + 1] == " ":
            i += 1
        if text[i:i + 1] == "]":
            return items, i + 1
        if text[i:i + 1] != ",":
            raise _yaml_error(no, f"malformed flow sequence: {text!r}")
        i += 1


def _inline(text: str, no: int):
    """The value written after ``key:`` or ``- `` on the same line."""
    c = text[0]
    if c in "'\"":
        value, end = _scan_quoted(text, 0, no)
    elif c == "[":
        value, end = _flow_sequence(text, no)
    elif c == "{":
        m = re.match(r"\{ *\}", text)
        if not m:
            raise _yaml_error(no, f"flow mappings are not supported: {text!r}")
        value, end = {}, m.end()
    elif c in "|>":
        raise _yaml_error(no, f"block scalars are not supported: {text!r}")
    else:
        return _plain(text, no)
    _after_scalar(text, end, no)
    return value


def _split_key(text: str, no: int):
    """``(key, rest)`` when the line is a mapping entry, else None."""
    if text[0] in "'\"":
        key, end = _scan_quoted(text, 0, no)
        rest = text[end:].lstrip(" ")
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:]
    m = re.search(r":(?: |$)", text)
    cut = re.search(r"(?:^|[ \t])#", text)
    if m is None or (cut and cut.start() < m.start()):
        return None
    raw = text[:m.start()].rstrip()
    if not raw:
        raise _yaml_error(no, "an empty mapping key is not supported")
    if raw[0] in "?" and raw[1:2] in ("", " "):
        raise _yaml_error(no, "complex mapping keys are not supported")
    key = _plain(raw, no)
    if isinstance(key, (list, dict)):
        raise _yaml_error(no, "a mapping key must be a scalar")
    return key, text[m.start() + 1:]


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _empty(rest: str) -> bool:
    rest = rest.strip()
    return not rest or rest.startswith("#")


def _block(lines: list[_Line], i: int, indent: int):
    """The node whose first line is ``lines[i]``, at column ``indent``."""
    line = lines[i]
    if _is_item(line.text):
        return _sequence(lines, i, indent)
    if _split_key(line.text, line.no) is not None:
        return _mapping(lines, i, indent)
    value = _inline(line.text, line.no)
    if i + 1 < len(lines) and lines[i + 1].indent > indent:
        raise _yaml_error(lines[i + 1].no, "multi-line scalars are not supported")
    return value, i + 1


def _nested(lines: list[_Line], i: int, indent: int, allow_same_indent_items: bool):
    """The block under a key or item whose inline value is empty: a more
    indented block, a sequence at the key's own column, or null."""
    if i < len(lines) and lines[i].indent > indent:
        return _block(lines, i, lines[i].indent)
    if allow_same_indent_items and i < len(lines) and lines[i].indent == indent \
            and _is_item(lines[i].text):
        return _sequence(lines, i, indent)
    return None, i


def _sequence(lines: list[_Line], i: int, indent: int):
    items: list = []
    while i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
        line = lines[i]
        rest = line.text[1:]
        if _empty(rest):
            value, i = _nested(lines, i + 1, indent, False)
        else:
            stripped = rest.lstrip(" ")
            col = indent + 1 + len(rest) - len(stripped)
            # the item's content as a line of its own at its column, so that a
            # mapping begun on the item's line takes the keys below it
            lines[i] = _Line(col, stripped, line.no)
            value, i = _block(lines, i, col)
        items.append(value)
    if i < len(lines) and lines[i].indent > indent:
        raise _yaml_error(lines[i].no, "bad indentation")
    return items, i


def _mapping(lines: list[_Line], i: int, indent: int):
    out: dict = {}
    while i < len(lines) and lines[i].indent == indent and not _is_item(lines[i].text):
        line = lines[i]
        entry = _split_key(line.text, line.no)
        if entry is None:
            raise _yaml_error(line.no, f"expected a mapping entry: {line.text!r}")
        key, rest = entry
        if key in out:
            raise _yaml_error(line.no, f"duplicate key {key!r}")
        if _empty(rest):
            value, i = _nested(lines, i + 1, indent, True)
        else:
            value = _inline(rest.lstrip(" "), line.no)
            i += 1
            if i < len(lines) and lines[i].indent > indent:
                raise _yaml_error(lines[i].no, "multi-line scalars are not supported")
        out[key] = value
    if i < len(lines) and lines[i].indent > indent:
        raise _yaml_error(lines[i].no, "bad indentation")
    return out, i


def _document(lines: list[_Line]):
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0].indent)
    if i < len(lines):
        raise _yaml_error(lines[i].no, "bad indentation")
    return value


def load_yaml_all(text: str) -> list:
    """Every document of a YAML stream, as a safe loader reads them, for
    the subset the shipped HPA files and ``to_yaml`` write: block mappings
    and sequences (``- key: value`` items too), comments, plain and quoted
    scalars with YAML 1.1's int, float, bool and null resolution (``"40"``
    stays a string), one-line flow sequences of scalars, ``{}`` and ``[]``,
    and ``---`` between documents.  Anything else raises ValueError naming
    the line: the reader never guesses."""
    docs: list[list[_Line]] = [[]]
    explicit = False
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t":
            raise _yaml_error(no, "tabs are not allowed in indentation")
        if raw.startswith("---") and (len(raw) == 3 or raw[3] in " \t"):
            if not _empty(raw[3:]):
                raise _yaml_error(no, "content on a '---' line is not supported")
            if docs[-1] or explicit:
                docs.append([])
            explicit = True
            continue
        if raw.startswith(("...", "%")) and raw == body:
            raise _yaml_error(no, "directives and document end markers are not supported")
        docs[-1].append(_Line(len(raw) - len(body), body.rstrip(), no))
    if not explicit and not docs[0]:
        return []
    return [_document(lines) for lines in docs]


def load_yaml(text: str):
    """The one document of a YAML stream (None for an empty stream); see
    ``load_yaml_all`` for what it reads."""
    docs = load_yaml_all(text)
    if len(docs) > 1:
        raise ValueError(f"expected one YAML document, found {len(docs)}")
    return docs[0] if docs else None


def main(argv: list[str] | None = None) -> int:
    """``python -m k8s_gpu_hpa_tpu_torch.manifests --out DIR``: write the
    GPU manifests of ``default_bundle()`` into DIR, one YAML file each, and
    print each path."""
    parser = argparse.ArgumentParser(prog="python -m k8s_gpu_hpa_tpu_torch.manifests")
    parser.add_argument("--out", required=True, help="directory to write the YAML files into")
    out = Path(parser.parse_args(argv).out)
    out.mkdir(parents=True, exist_ok=True)
    for name, docs in default_bundle().items():
        (out / name).write_text(to_yaml(docs))
        print(out / name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
