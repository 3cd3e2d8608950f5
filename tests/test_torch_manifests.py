"""The GPU manifest generator against the JAX package's: the same string
contracts, leaf for leaf, except where a GPU node needs another value.

``default_bundle()`` is walked against the JAX package's bundle, file by
file and leaf by leaf.  A leaf may differ only under one of ``GPU_PATHS``
(the accelerator's resource key, node selector and taint, the images, the
commands, and the exporter's NVML access), and each of them must differ
somewhere, so the list cannot go stale.  Where the port renders a subset of
the JAX package's entries (``SUBSET_PATHS``: the scrape jobs; the rule
groups, the alert groups among them, and the adapter's custom and external
rules are whole now), each entry it renders must equal the JAX entry of the
same name.  Each recording rule's PromQL is JAX's, character for
character."""

import fnmatch
from pathlib import Path

import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu import manifests as jax_manifests
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu_torch import manifests
from k8s_gpu_hpa_tpu_torch.metrics import rules
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_DUTY_CYCLE,
    TPU_HBM_BW_UTIL,
    TPU_HBM_USAGE,
    TPU_TENSORCORE_UTIL,
)
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

_POD = ("spec", "template", "spec")
_CONTAINER = (*_POD, "containers", "*")
_EXPORTER = ("tpu-metrics-exporter.yaml", "0")
#: (file, document, *keys) patterns, "*" any one key: where a GPU node needs
#: another value than a TPU node, each with everything under it
GPU_PATHS = [
    ("*", "*", *_POD, "nodeSelector"),
    ("*", "*", *_POD, "tolerations", "*", "key"),
    ("*", "*", *_CONTAINER, "image"),
    ("*", "*", *_CONTAINER, "command"),
    ("*", "*", *_CONTAINER, "resources", "limits"),
    # NVML instead of libtpu: its env, the driver's libraries, privileged
    (*_EXPORTER, *_CONTAINER, "env"),
    (*_EXPORTER, *_CONTAINER, "securityContext"),
    (*_EXPORTER, *_CONTAINER, "volumeMounts"),
    (*_EXPORTER, *_POD, "volumes"),
]
#: lists whose port entries are a subset of the JAX package's, by name
SUBSET_PATHS = {
    ("kube-prometheus-stack-values.yaml", "0", "prometheus", "prometheusSpec",
     "additionalScrapeConfigs"): "job_name",
    ("prometheus-adapter-values.yaml", "0", "rules", "custom"): "seriesQuery",
    ("prometheus-adapter-values.yaml", "0", "rules", "external"): "seriesQuery",
    ("tpu-test-prometheusrule.yaml", "0", "spec", "groups"): "name",
}


def _walk(port, ref, path: tuple, out: list) -> None:
    """The paths at which ``port`` and ``ref`` differ: a key one side
    lacks, a list of another length, a leaf of another value or type."""
    if isinstance(port, dict) and isinstance(ref, dict):
        for key in [*port, *(k for k in ref if k not in port)]:
            if key in port and key in ref:
                _walk(port[key], ref[key], (*path, str(key)), out)
            else:
                out.append((*path, str(key)))
    elif isinstance(port, list) and isinstance(ref, list):
        if len(port) != len(ref):
            out.append(path)
        else:
            for i, (a, b) in enumerate(zip(port, ref)):
                _walk(a, b, (*path, str(i)), out)
    elif type(port) is not type(ref) or port != ref:
        out.append(path)


def _under(path: tuple, pattern: tuple) -> bool:
    return len(path) >= len(pattern) and all(
        fnmatch.fnmatchcase(key, want) for key, want in zip(path, pattern)
    )


def _differences(port: dict, ref: dict) -> list[tuple]:
    out: list[tuple] = []
    for name, docs in port.items():
        _walk(docs, ref[name], (name,), out)
    return out


def _by(entries: list[dict], key: str) -> dict:
    return {e[key]: e for e in entries}


def _lookup(bundle: dict, path: tuple):
    node = bundle[path[0]]
    for key in path[1:]:
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


def test_the_bundle_holds_the_jax_bundle_s_manifests_of_the_port_s_pipelines():
    port, ref = manifests.default_bundle(), jax_manifests.default_bundle()
    # with the slice-quantum operator the port renders every file of JAX's
    assert set(port) == set(ref)
    assert set(port) == {
        "tpu-metrics-exporter.yaml", "kube-prometheus-stack-values.yaml",
        "prometheus-adapter-values.yaml", "tpu-test-prometheusrule.yaml",
        *(f"{w}-{kind}.yaml" for w in ("tpu-test", "tpu-serve", "tpu-train")
          for kind in ("deployment", "hpa")),
        "tpu-test-v5e8-deployment.yaml", "tpu-test-hbm-hpa.yaml", "tpu-test-external-hpa.yaml",
        "tpu-test-multihost.yaml", "tpu-test-multihost-hpa.yaml", "quantum-operator.yaml",
        "cpu-busyloop.yaml", "cpu-busyloop-hpa.yaml",
    }
    for name, docs in port.items():
        assert [d.get("kind") for d in docs] == [d.get("kind") for d in ref[name]]


def test_every_leaf_of_the_bundle_is_jax_s_but_where_a_gpu_node_needs_another():
    diffs = _differences(manifests.default_bundle(), jax_manifests.default_bundle())
    allowed = GPU_PATHS + list(SUBSET_PATHS)
    stray = [d for d in diffs if not any(_under(d, p) for p in allowed)]
    assert stray == []
    # each GPU path differs somewhere: the list names real differences
    stale = [p for p in GPU_PATHS if not any(_under(d, p) for d in diffs)]
    assert stale == []
    # no list is rendered in part any more: the scrape jobs (the operator's
    # among them), the adapter's rules, custom and external, and the
    # PrometheusRule's groups, alert groups included, are JAX's whole
    partial = {p[0] for p in SUBSET_PATHS if any(_under(d, p) for d in diffs)}
    assert partial == set()


@pytest.mark.parametrize("path", list(SUBSET_PATHS), ids=lambda p: "/".join(p[:1] + p[-1:]))
def test_each_entry_the_port_renders_of_a_list_is_jax_s_entry(path):
    key = SUBSET_PATHS[path]
    port = _by(_lookup(manifests.default_bundle(), path), key)
    ref = _by(_lookup(jax_manifests.default_bundle(), path), key)
    assert set(port) <= set(ref)
    for name, entry in port.items():
        assert entry == ref[name]


def test_the_quantum_operator_and_its_scrape_job_are_jax_s_but_image_and_command():
    """The operator's ServiceAccount, Role, RoleBinding and Deployment are
    JAX's leaf for leaf but for the container's image and command (the
    port's operator in the port's exporter image), and the Prometheus values
    carry JAX's ``quantum-operator`` scrape job beside ``tpu-metrics``."""
    port, ref = manifests.quantum_operator_bundle(), jax_manifests.quantum_operator_bundle()
    diffs: list = []
    _walk(port, ref, ("quantum-operator.yaml",), diffs)
    container = ("quantum-operator.yaml", "3", *_CONTAINER[:-1], "0")
    assert sorted(diffs) == [(*container, "command", "2"), (*container, "image")]
    got = port[3]["spec"]["template"]["spec"]["containers"][0]
    assert got["command"] == ["python", "-m", "k8s_gpu_hpa_tpu_torch.control.operator"]
    assert got["image"] == manifests.EXPORTER_IMAGE
    jobs = manifests.prom_stack_values()["prometheus"]["prometheusSpec"]["additionalScrapeConfigs"]
    ref_jobs = jax_manifests.prom_stack_values()["prometheus"]["prometheusSpec"][
        "additionalScrapeConfigs"]
    assert [j["job_name"] for j in jobs] == ["tpu-metrics", "quantum-operator"]
    assert jobs == ref_jobs
    assert manifests.default_bundle()["quantum-operator.yaml"] == port


def test_the_gpu_values_are_the_ones_a_gpu_node_needs():
    bundle = manifests.default_bundle()
    # every workload but the CPU busy-loop and the quantum operator, which
    # ask for no device (and select no GPU node)
    workloads = [d for name, docs in bundle.items() for d in docs
                 if d.get("kind") in ("Deployment", "StatefulSet", "DaemonSet")
                 and d["metadata"]["name"] not in ("cpu-busyloop", "quantum-operator")]
    operator = bundle["quantum-operator.yaml"][3]["spec"]["template"]["spec"]
    assert "nodeSelector" not in operator and "tolerations" not in operator
    for doc in workloads:
        pod = doc["spec"]["template"]["spec"]
        assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert pod["tolerations"] == [
            {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}
        ]
        command = pod["containers"][0]["command"]
        assert command[:2] == ["python", "-m"]
        assert command[2].startswith("k8s_gpu_hpa_tpu_torch.")
    limits = {d["metadata"]["name"]: d["spec"]["template"]["spec"]["containers"][0]["resources"]
              for d in workloads if d["kind"] != "DaemonSet"}
    # the JAX manifests' device counts, as nvidia.com/gpu
    assert limits == {
        "tpu-test": {"limits": {"nvidia.com/gpu": 1}},
        "tpu-test-v5e8": {"limits": {"nvidia.com/gpu": 8}},
        "tpu-serve": {"limits": {"nvidia.com/gpu": 1}},
        "tpu-train": {"limits": {"nvidia.com/gpu": 4}},
        "tpu-test-multihost": {"limits": {"nvidia.com/gpu": 4}},
    }
    exporter = bundle["tpu-metrics-exporter.yaml"][0]["spec"]["template"]["spec"]
    container = exporter["containers"][0]
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert env["SOURCE"] == "nvml" and env["LD_LIBRARY_PATH"] == "/usr/local/nvidia/lib64"
    mounts = {m["mountPath"] for m in container["volumeMounts"]}
    assert mounts == {"/var/lib/kubelet/pod-resources", "/usr/local/nvidia",
                      "/var/run/tpu-telemetry"}
    hosts = {v["hostPath"]["path"] for v in exporter["volumes"]}
    assert hosts == {"/var/lib/kubelet/pod-resources", "/home/kubernetes/bin/nvidia",
                     "/var/run/tpu-telemetry"}


def _rule_pairs():
    """Each recording rule of the port's groups beside the JAX rule of the
    same record, and the slice rule and PipelineSpec rules on every metric."""
    ref = {r.record: r for _, group in jax_manifests.shipped_rule_groups() for r in group}
    pairs = [(r, ref[r.record]) for _, group in manifests.shipped_rule_groups() for r in group]
    for metric in (TPU_TENSORCORE_UTIL, TPU_DUTY_CYCLE, TPU_HBM_BW_UTIL, TPU_HBM_USAGE):
        pairs.append((
            rules.tpu_test_multihost_avg_rule("s-app", "s-app", "ml", metric, "r"),
            jax_rules.tpu_test_multihost_avg_rule("s-app", "s-app", "ml", metric, "r"),
        ))
        for hosts in (1, 2):
            pairs.append((
                manifests.PipelineSpec("my-app", metric, hosts_per_slice=hosts).recording_rule(),
                jax_manifests.PipelineSpec("my-app", metric, hosts_per_slice=hosts).recording_rule(),
            ))
    return pairs


@pytest.mark.parametrize("port,ref", _rule_pairs(),
                         ids=lambda r: getattr(r, "record", None))
def test_each_rule_s_promql_is_jax_s(port, ref):
    assert port.record == ref.record
    assert port.expr.promql() == ref.expr.promql()
    assert port.labels == ref.labels


def test_the_rule_asts_render_jax_s_promql_node_by_node():
    sel = rules.Select("kube_pod_labels", {"label_app": "a", "b": "c"})
    jsel = jax_rules.Select("kube_pod_labels", {"label_app": "a", "b": "c"})
    assert sel.promql() == jsel.promql() == 'kube_pod_labels{b="c",label_app="a"}'
    assert rules.Select("m").promql() == jax_rules.Select("m").promql() == "m"
    by = rules.MaxBy(("pod", "label_app"), sel)
    assert by.promql() == jax_rules.MaxBy(("pod", "label_app"), jsel).promql()
    mul = rules.MulOnGroupLeft(rules.Select("x"), by, ("pod",), ("label_app",))
    jmul = jax_rules.MulOnGroupLeft(
        jax_rules.Select("x"), jax_rules.MaxBy(("pod", "label_app"), jsel), ("pod",), ("label_app",)
    )
    assert mul.promql() == jmul.promql()
    assert rules.Avg(mul).promql() == jax_rules.Avg(jmul).promql()
    assert rules.tpu_test_multihost_avg_rule().expr.promql() == (
        'avg(max by(node,pod,namespace)(tpu_tensorcore_utilization) * on(pod) '
        'group_left(label_app) max by(pod,label_app)'
        '(kube_pod_labels{label_app="tpu-test-multihost"}))'
    )


def test_the_bundle_round_trips_through_yaml():
    for name, docs in manifests.default_bundle().items():
        assert list(yaml.safe_load_all(manifests.to_yaml(docs))) == docs, name


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_render_pipeline_round_trips_and_matches_jax_s(hosts):
    kwargs = {"hosts_per_slice": hosts, "min_slices": 1, "max_slices": 3, "target": "55",
              "device_metric": TPU_DUTY_CYCLE}
    port = manifests.render_pipeline(manifests.PipelineSpec("my-app", gpu_limit=4, **kwargs))
    ref = jax_manifests.render_pipeline(jax_manifests.PipelineSpec("my-app", tpu_limit=4, **kwargs))
    assert list(port) == list(ref)
    for name, docs in port.items():
        assert list(yaml.safe_load_all(manifests.to_yaml(docs))) == docs, name
    stray = [d for d in _differences(port, ref) if not any(_under(d, p) for p in GPU_PATHS)]
    assert stray == []


def test_the_multihost_pipeline_shape():
    spec = manifests.PipelineSpec("slice-app", hosts_per_slice=4, min_slices=1, max_slices=3)
    out = manifests.render_pipeline(spec)
    assert list(out) == ["slice-app-statefulset.yaml", "slice-app-prometheusrule.yaml",
                         "slice-app-adapter-values.yaml", "slice-app-hpa.yaml"]
    service, sts = out["slice-app-statefulset.yaml"]
    assert service["spec"]["clusterIP"] == "None" and service["spec"]["publishNotReadyAddresses"]
    assert sts["kind"] == "StatefulSet" and sts["spec"]["serviceName"] == "slice-app"
    env = {e["name"]: e.get("value") for e in
           sts["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert (env["HOSTS_PER_SLICE"], env["HEADLESS_SERVICE"]) == ("4", "slice-app")
    (rule_doc,) = out["slice-app-prometheusrule.yaml"]
    (rule,) = rule_doc["spec"]["groups"][0]["rules"]
    assert rule["record"] == "slice_app_tensorcore_avg"
    assert rule["labels"] == {"namespace": "default", "statefulset": "slice-app"}
    (adapter,) = out["slice-app-adapter-values.yaml"][0]["rules"]["custom"]
    assert adapter == manifests.adapter_rule("slice_app_tensorcore_avg", resource="statefulset")
    (hpa,) = out["slice-app-hpa.yaml"]
    assert hpa["metadata"]["annotations"] == {"k8s-tpu-hpa/replica-quantum": "4"}
    assert (hpa["spec"]["minReplicas"], hpa["spec"]["maxReplicas"]) == (4, 12)
    assert hpa["spec"]["scaleTargetRef"]["kind"] == "StatefulSet"
    assert hpa["spec"]["behavior"]["scaleUp"]["policies"] == [
        {"type": "Pods", "value": 8, "periodSeconds": 15}
    ]
    assert hpa["spec"]["behavior"]["scaleDown"]["policies"] == [
        {"type": "Pods", "value": 4, "periodSeconds": 60}
    ]


def test_a_node_selector_replaces_gke_s_and_brings_the_exporter():
    selector, tolerations = {"accelerator": "nvidia-gpu"}, [{"operator": "Exists"}]
    out = manifests.render_pipeline(manifests.PipelineSpec(
        "my-app", node_selector=selector, tolerations=tolerations))
    deployment = out["my-app-deployment.yaml"][0]["spec"]["template"]["spec"]
    exporter = out["my-app-exporter-daemonset.yaml"][0]["spec"]["template"]["spec"]
    for pod in (deployment, exporter):
        assert pod["nodeSelector"] == selector and pod["tolerations"] == tolerations


@pytest.mark.parametrize("kwargs", [{"app": "Bad_App"}, {"app": "ok", "device_metric": "nope"}])
def test_pipeline_spec_refuses_what_would_break_a_contract(kwargs):
    with pytest.raises(ValueError):
        manifests.PipelineSpec(**kwargs)


def test_the_cli_writes_the_bundle(tmp_path, capsys):
    assert manifests.main(["--out", str(tmp_path / "gpu")]) == 0
    bundle = manifests.default_bundle()
    written = sorted(p.name for p in (tmp_path / "gpu").iterdir())
    assert written == sorted(bundle)
    for name, docs in bundle.items():
        assert list(yaml.safe_load_all((tmp_path / "gpu" / name).read_text())) == docs
    assert len(capsys.readouterr().out.splitlines()) == len(bundle)


DEPLOY = Path(__file__).resolve().parent.parent / "deploy"


@pytest.mark.parametrize("name,doc", [("tpu-test-hbm-hpa.yaml", manifests.hbm_hpa_doc),
                                      ("tpu-test-external-hpa.yaml", manifests.external_hpa_doc)])
def test_the_pods_and_external_hpas_are_jax_s_and_the_shipped_manifests(name, doc):
    assert manifests.default_bundle()[name] == [doc()]
    assert [doc()] == jax_manifests.default_bundle()[name]
    assert doc() == yaml.safe_load((DEPLOY / name).read_text())


def test_the_v5e8_deployment_runs_the_matmul_container_on_eight_gpus():
    (port,) = manifests.default_bundle()["tpu-test-v5e8-deployment.yaml"]
    (ref,) = jax_manifests.default_bundle()["tpu-test-v5e8-deployment.yaml"]
    pod = port["spec"]["template"]["spec"]
    (container,) = pod["containers"]
    assert container["name"] == "tpu-test" == ref["spec"]["template"]["spec"]["containers"][0]["name"]
    assert container["resources"] == {"limits": {"nvidia.com/gpu": 8}}
    assert container["command"] == ["python", "-m", "k8s_gpu_hpa_tpu_torch.loadgen"]
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert (env["MATMUL_SIZE"], env["QUEUE_NAME"]) == ("8192", "tpu-test-v5e8")
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    stray = [d for d in _differences({"d": [port]}, {"d": [ref]})
             if not any(_under(d, p) for p in GPU_PATHS)]
    assert stray == []


def test_the_adapter_values_are_jax_s_with_the_pod_and_external_rules():
    port = manifests.adapter_values()["rules"]
    ref = jax_manifests.adapter_values()["rules"]
    assert port == ref
    pod_rule = _by(port["custom"], "seriesQuery")['tpu_test_hbm_used_bytes{namespace!="",pod!=""}']
    assert pod_rule["resources"]["overrides"]["pod"] == {"resource": "pod"}
    (queue,) = port["external"]
    assert queue == manifests.external_rule("tpu_test_queue_depth")
    assert queue["metricsQuery"].startswith("sum by (<<.GroupBy>>)")
    groups = {g: [r.record for r in rs] for g, rs in manifests.shipped_rule_groups()}
    assert groups["tpu-test-v5e8"] == ["tpu_test_hbm_used_bytes"]
    assert "tpu_test_hbm_bw_avg" in groups["tpu-test"]


AWKWARD = [
    "yes", "No", "ON", "off", "true", "null", "~", "8192", "1x1", "", " lead", "trail ",
    "a: b", "- x", "#c", "key: [1]", ".inf", ".5", "1e3", "0x1F", "$(POD_NAMESPACE)_$(POD_NAME)",
    "line\nbreak", 'quote"s', "back\\slash", "ü", "@at", "*star", "&amp", "!tag", "%pct",
    1.5, 1e20, 1e-05, -0.0, 0, -7, True, False, None, float("inf"), [], {}, [[1, "a"], []],
    [{"k": "v", "n": [1, 2]}, {}],
]


@pytest.mark.parametrize("value", AWKWARD)
def test_to_yaml_round_trips_awkward_values(value):
    doc = {"value": value, "nested": {"list": [value, {"inner": value}]}, value_key(value): 1}
    assert yaml.safe_load(manifests.to_yaml([doc])) == doc


def value_key(value) -> str:
    """A mapping key made of the value, where the value can be a key."""
    return value if isinstance(value, str) and value else "plain-key"


def test_the_cpu_busyloop_pair_is_jax_s_and_the_shipped_manifests():
    """The rung without an accelerator: JAX's Deployment and Resource HPA,
    leaf by leaf (no GPU path applies), and the files in deploy/."""
    port, ref = manifests.default_bundle(), jax_manifests.default_bundle()
    for name in ("cpu-busyloop.yaml", "cpu-busyloop-hpa.yaml"):
        assert _differences({name: port[name]}, {name: ref[name]}) == []
        assert port[name] == list(yaml.safe_load_all((DEPLOY / name).read_text()))
    assert port["cpu-busyloop-hpa.yaml"] == [manifests.cpu_busyloop_hpa_doc()]


HPA_FILES = sorted(p.name for p in DEPLOY.glob("*-hpa.yaml"))


@pytest.mark.parametrize("name", HPA_FILES)
def test_load_yaml_reads_each_shipped_hpa_as_a_safe_loader_does(name):
    text = (DEPLOY / name).read_text()
    assert manifests.load_yaml_all(text) == list(yaml.safe_load_all(text))
    assert manifests.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", sorted(manifests.default_bundle()))
def test_load_yaml_reads_back_each_file_of_the_bundle(name):
    text = manifests.to_yaml(manifests.default_bundle()[name])
    assert manifests.load_yaml_all(text) == list(yaml.safe_load_all(text))


def _alike(a, b) -> bool:
    """Equal, with NaN equal to NaN and types compared."""
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_alike(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_alike(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("value", AWKWARD + [float("nan"), "2020-1-1x", "tab\there"])
def test_load_yaml_reads_to_yaml_s_awkward_values_back(value):
    doc = {"value": value, "nested": {"list": [value, {"inner": value}]}, value_key(value): 1}
    text = manifests.to_yaml([doc])
    assert _alike(manifests.load_yaml(text), yaml.safe_load(text))


#: streams a safe loader reads, in the block style of hand-written manifests
STREAMS = [
    "a: 1\n---\n", "---\n---\na: 1\n", "", "# only a comment\n", "word\n", "- a\n- b\n",
    "k:\n- a\n- b\nj: 2\n", "a: 'it''s'  # trailing\n", 'a: "x\\ty\\u00e9"\n',
    "a: [1, 'b', c d, 2.5, \"q\"]  # flow\n", "a: 017\nb: 1_000\nc: 1:30\nd: -0\ne: +.inf\nf: 0b101\n",
    "- - a\n  - b\n- c\n", "-\n  - a\n", "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n", "a: { }\nb: []\n",
    "key with spaces: v\n", '"quoted key": v\n', "- a: 1\n  b: 2\n- c: 3\n",
    "a: b # c: d\n", "a: b#c\n", "- x#y # z\n", "a: http://x:80/y\n", "a:\n\n  b: 1\n",
    "v: Yes\nw: NULL\nx: ~\ny: .NaN\n",
]


@pytest.mark.parametrize("text", STREAMS)
def test_load_yaml_all_reads_each_stream_as_a_safe_loader_does(text):
    assert _alike(manifests.load_yaml_all(text), list(yaml.safe_load_all(text)))


#: what the reader does not support; each raises ValueError with a line number
UNSUPPORTED = [
    "a: |\n  block\n", "a: >-\n  folded\n", "a: {b: 1}\n", "a: &anchor 1\n", "a: *alias\n",
    "a: !tag 1\n", "? complex\n", "a: x\n  continued\n", "a: 2001-12-14\n", "a: [1, [2]]\n",
    "a: [1, 2\n", "a: 'open\n", "a: 1\na: 2\n", "a: b: c\n", "\ta: 1\n", "%YAML 1.1\n---\na: 1\n",
    "a: 1\n...\n", "--- a: 1\n", "a:\n  - 1\n b: 2\n", 'a: "bad \\q escape"\n', "<<: x\n",
]


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_load_yaml_refuses_what_it_does_not_support(text):
    with pytest.raises(ValueError, match="YAML line [0-9]+: "):
        manifests.load_yaml_all(text)


def test_load_yaml_wants_one_document():
    with pytest.raises(ValueError, match="one YAML document"):
        manifests.load_yaml("a: 1\n---\nb: 2\n")
    assert manifests.load_yaml("") is None
