"""Entry point: ``python -m k8s_gpu_hpa_tpu_torch.exporter`` (the DaemonSet
container's command; see ``daemon.main`` for its environment)."""

from k8s_gpu_hpa_tpu_torch.exporter.daemon import main

if __name__ == "__main__":
    main()
