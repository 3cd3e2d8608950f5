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
    gen-manifests write the GPU manifests of the generator's bundle

The container commands stay reachable at their module paths too
(``python -m k8s_gpu_hpa_tpu_torch.exporter`` and so on, the forms the
manifests run).  Each command imports its module only when chosen, so
``simulate`` loads no torch.
"""

from __future__ import annotations

import argparse
import sys


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
    if args.command == "gen-manifests":
        from k8s_gpu_hpa_tpu_torch import manifests

        return manifests.main(["--out", args.out])
    raise AssertionError(f"unhandled command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
