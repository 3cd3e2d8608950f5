"""The port's CLI umbrella: ``python -m k8s_gpu_hpa_tpu_torch <command>``.

Counterpart of ``k8s_gpu_hpa_tpu/__main__.py``, with the commands whose
modules the port has:

    doctor        run the runbook's probes in order, stop at the broken
                  joint; ``--nvml`` probes this host's NVML instead
    exporter      the metrics exporter daemon (the DaemonSet's command)
    loadgen       the load generator (the tpu-test container's command;
                  WORKLOAD=decode serves instead)
    train         the ResNet-50 training workload (tpu-train's command)
    multihost     the multi-host load generator (the StatefulSet's command)
    simulate      play a load scenario against a shipped HPA manifest
    gen-pipeline  render a whole custom pipeline (workload, rule, adapter
                  values, HPA) for GPU nodes
    gen-manifests write the GPU manifests of the generator's bundle

The container commands stay reachable at their module paths too
(``python -m k8s_gpu_hpa_tpu_torch.exporter`` and so on, the forms the
manifests run).  Each command imports its module only when chosen, so
``simulate`` loads no torch.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _cmd_gen_pipeline(args: argparse.Namespace) -> int:
    """The JAX package's ``gen-pipeline`` over the port's ``PipelineSpec``:
    ``--gpu-limit`` where JAX has ``--tpu-limit`` and ``--topology``.  Exit
    2 on a malformed ``--node-selector`` or ``--toleration``."""
    from k8s_gpu_hpa_tpu_torch import manifests
    from k8s_gpu_hpa_tpu_torch.metrics import schema

    metric = {
        "tensorcore": schema.TPU_TENSORCORE_UTIL,
        "duty-cycle": schema.TPU_DUTY_CYCLE,
        "hbm-bw": schema.TPU_HBM_BW_UTIL,
    }[args.metric]
    node_selector = None
    if args.node_selector:
        node_selector = {}
        for item in args.node_selector:
            key, sep, value = item.partition("=")
            if not sep or not key:
                print(f"--node-selector {item!r}: expected KEY=VALUE", file=sys.stderr)
                return 2
            node_selector[key] = value
    tolerations = None
    if args.toleration:
        tolerations = []
        for item in args.toleration:
            head, sep, effect = item.rpartition(":")
            if not sep or not head or not effect:
                print(f"--toleration {item!r}: expected KEY[=VALUE]:EFFECT", file=sys.stderr)
                return 2
            key, eq, value = head.partition("=")
            tol: dict = {"key": key, "effect": effect}
            if eq:
                tol["operator"] = "Equal"
                tol["value"] = value
            else:
                tol["operator"] = "Exists"
            tolerations.append(tol)
    spec = manifests.PipelineSpec(
        app=args.app,
        device_metric=metric,
        target=args.target,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        gpu_limit=args.gpu_limit,
        accelerator=args.accelerator,
        namespace=args.namespace,
        hosts_per_slice=args.hosts_per_slice,
        min_slices=args.min_slices,
        max_slices=args.max_slices,
        node_selector=node_selector,
        tolerations=tolerations,
    )
    files = manifests.render_pipeline(spec)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        for name, docs in files.items():
            (out / name).write_text(manifests.to_yaml(docs))
            print(f"wrote {out / name}")
    else:
        for i, (name, docs) in enumerate(files.items()):
            if i:
                print("---")
            print(f"# ===== {name} =====")
            print(manifests.to_yaml(docs))
    return 0


def _add_gen_pipeline(sub) -> None:
    from k8s_gpu_hpa_tpu_torch.manifests import ACCEL_H100

    gen = sub.add_parser("gen-pipeline", help="render a complete custom autoscaling pipeline")
    gen.add_argument("--app", required=True, help="app name (the pipeline join key)")
    gen.add_argument(
        "--metric",
        choices=["tensorcore", "duty-cycle", "hbm-bw"],
        default="tensorcore",
        help="device metric to autoscale on",
    )
    gen.add_argument("--target", default="40", help="HPA target value")
    gen.add_argument("--min-replicas", type=int, default=1)
    gen.add_argument("--max-replicas", type=int, default=4)
    gen.add_argument("--gpu-limit", type=int, default=1, help="GPUs per pod")
    gen.add_argument("--accelerator", default=ACCEL_H100)
    gen.add_argument("--namespace", default="default")
    gen.add_argument(
        "--hosts-per-slice",
        type=int,
        default=1,
        help=">1 renders the multi-host shape: StatefulSet of slices, headless "
        "service and the slice-quantum HPA",
    )
    gen.add_argument("--min-slices", type=int, default=1)
    gen.add_argument("--max-slices", type=int, default=4)
    gen.add_argument(
        "--node-selector",
        action="append",
        metavar="KEY=VALUE",
        help="replace GKE's GPU node labels with hand-applied ones (repeatable); "
        "also renders a matching exporter DaemonSet into the pipeline",
    )
    gen.add_argument(
        "--toleration",
        action="append",
        metavar="KEY[=VALUE]:EFFECT",
        help="replace the default nvidia.com/gpu:NoSchedule toleration "
        "(repeatable; KEY=VALUE:EFFECT tolerates Equal, KEY:EFFECT Exists)",
    )
    gen.add_argument("-o", "--out", help="directory to write files (default: stdout)")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_gpu_hpa_tpu_torch", description=__doc__.split("\n\n")[0]
    )
    sub = parser.add_subparsers(dest="command", required=True)

    doc = sub.add_parser("doctor", help="probe every pipeline joint in order")
    doc.add_argument(
        "--nvml",
        nargs="?",
        const="",
        default=None,
        metavar="LIBRARY",
        help="instead of the pipeline probes, probe this host's NVML "
        "(default: NVIDIA's libnvidia-ml.so.1)",
    )
    sub.add_parser("exporter", help="run the metrics exporter daemon")
    sub.add_parser("loadgen", help="run the load generator (WORKLOAD=decode: serving)")
    sub.add_parser("train", help="run the ResNet-50 training workload")
    sub.add_parser("multihost", help="run the multi-host load generator")
    _add_gen_pipeline(sub)

    sim = sub.add_parser(
        "simulate",
        help="play a load scenario against a shipped HPA manifest (virtual time)",
    )
    from k8s_gpu_hpa_tpu_torch.simulate import add_arguments

    add_arguments(sim)

    genm = sub.add_parser("gen-manifests", help="write the generated GPU manifests")
    genm.add_argument("-o", "--out", required=True, help="directory to write the YAML files into")

    args = parser.parse_args(argv)

    if args.command == "doctor":
        if args.nvml is not None:
            from k8s_gpu_hpa_tpu_torch.doctor import nvml, probe_nvml

            return probe_nvml(args.nvml or nvml.DEFAULT_LIBRARY)
        from k8s_gpu_hpa_tpu_torch.doctor import main as doctor_main

        return doctor_main()
    if args.command == "exporter":
        from k8s_gpu_hpa_tpu_torch.exporter.daemon import main as exporter_main

        exporter_main()
        return 0
    if args.command == "loadgen":
        from k8s_gpu_hpa_tpu_torch.loadgen.__main__ import main as loadgen_main

        loadgen_main()
        return 0
    if args.command == "train":
        from k8s_gpu_hpa_tpu_torch.loadgen.train import main as train_main

        train_main()
        return 0
    if args.command == "multihost":
        from k8s_gpu_hpa_tpu_torch.loadgen.multihost import main as multihost_main

        multihost_main()
        return 0
    if args.command == "simulate":
        from k8s_gpu_hpa_tpu_torch.simulate import main as simulate_main

        return simulate_main(args)
    if args.command == "gen-pipeline":
        return _cmd_gen_pipeline(args)
    if args.command == "gen-manifests":
        from k8s_gpu_hpa_tpu_torch import manifests

        return manifests.main(["--out", args.out])
    raise AssertionError(f"unhandled command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
