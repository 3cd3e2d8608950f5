"""Entry point: ``python -m k8s_gpu_hpa_tpu_torch.loadgen`` (the container command).

``WORKLOAD`` selects the load profile: ``decode`` the KV-cache serving
generator (memory-bandwidth-bound), anything else the matmul busy-loop
(tensor-core-bound), the default."""

import os

if os.environ.get("WORKLOAD", "matmul") == "decode":
    from k8s_gpu_hpa_tpu_torch.loadgen.decode import main
else:
    from k8s_gpu_hpa_tpu_torch.loadgen.matmul import main

if __name__ == "__main__":
    main()
