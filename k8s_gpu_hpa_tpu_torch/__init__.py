"""k8s_gpu_hpa_tpu_torch — the closed autoscaling loop on PyTorch and CUDA.

A port of ``k8s_gpu_hpa_tpu`` from JAX on a TPU to PyTorch on an NVIDIA
Hopper GPU.  It keeps the JAX package's module paths and names so that each
part has an obvious counterpart, imports nothing of that package and never
imports JAX.  Entry points run on CUDA unless the caller passes
``device="cpu"``.

The loop, by layer:

    L1 workload    loadgen/matmul.py   bf16 matmul busy-loop, duty-cycle knob,
                   ops/matmul.py       on a hand-written Hopper GEMM;
                   loadgen/decode.py   or the serving load: prefill + KV-cache
                   models/transformer.py  decode, one CUDA graph a burst, its
                   ops/flash_attention.py prefill on a hand-written Hopper
                                       flash-attention kernel
                   loadgen/train.py    or the training rung, data-parallel
                   loadgen/allreduce.py  or the slice's collective rung, over
                   parallel/mesh.py    a torch.distributed DeviceMesh, one
                   loadgen/multihost.py  process a GPU (initialize, launch)
    L2 exporter    exporter/           device source → C++ core → /metrics
    L3 metrics     metrics/            scrape → TSDB → recording rule
    L4 adapter     control/adapter.py  custom-metrics API semantics
    L5 controller  control/hpa.py      autoscaling/v2 HPA with behavior

``trial.py`` wires them into the headline, serve, training and slice
trials (the slice trial scales a StatefulSet of multi-host slices in whole
slices); ``chip_smoke.py`` at the repository root drives them on the card.
On a virtual clock, ``control/cluster.py`` simulates the cluster (nodes,
pod lifecycle, node exporters, kube-state-metrics, faults),
``control/loop.py`` assembles the five layers over it, and ``simulate.py``
plays a load scenario against a shipped HPA manifest
(``python -m k8s_gpu_hpa_tpu_torch simulate``, the CLI umbrella of
``__main__.py``).  The deploy side: ``manifests.py`` renders the GPU
manifests from the pipeline's string contracts and reads YAML back, and
``doctor.py`` probes a deployed pipeline joint by joint and a node's NVML.
"""

__version__ = "0.1.0"
