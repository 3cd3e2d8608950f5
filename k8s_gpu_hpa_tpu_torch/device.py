"""Which device the port runs on, and what that device can do at most.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (the
tests do).  Without a GPU, a request for CUDA raises: nothing quietly runs
on the CPU.

The peak tables are keyed by the name ``torch.cuda.get_device_name()``
reports and matched by longest prefix, so a more specific entry ("NVIDIA
H100 PCIe") wins over a shorter one ("NVIDIA H100", which the SXM part
reports as "NVIDIA H100 80GB HBM3").  Values are NVIDIA's public data sheets,
dense (no sparsity), at the part's full power limit.
"""

from __future__ import annotations

import torch

#: dense bf16 tensor-core peak, TFLOP/s
PEAK_BF16_TFLOPS = {
    "NVIDIA H100": 989.0,  # SXM
    "NVIDIA H100 PCIe": 756.0,
}

#: device-memory bandwidth peak, GB/s
PEAK_HBM_GBPS = {
    "NVIDIA H100": 3350.0,  # SXM, HBM3
    "NVIDIA H100 PCIe": 2000.0,
}


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: CUDA by default, the CPU only when asked.

    Raises RuntimeError when CUDA is asked for (or defaulted to) and there is
    no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """Every local device of the resolved device's type: all GPUs, or the CPU."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def device_name(device: str | torch.device) -> str:
    """The name the device reports ("NVIDIA H100 80GB HBM3"; "cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _peak_for(name: str, table: dict[str, float]) -> float | None:
    # longest-prefix match so "NVIDIA H100 PCIe" wins over "NVIDIA H100"
    best = None
    for prefix, value in table.items():
        if name.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), value)
    return best[1] if best else None


def peak_tflops_for(device: str | torch.device) -> float | None:
    """Dense bf16 peak of a device, given as a ``torch.device`` or by the
    name it reports; None where the table has no entry (the CPU)."""
    return _peak_for(_name_of(device), PEAK_BF16_TFLOPS)


def peak_hbm_gbps_for(device: str | torch.device) -> float | None:
    return _peak_for(_name_of(device), PEAK_HBM_GBPS)


def _name_of(device: str | torch.device) -> str:
    if isinstance(device, torch.device):
        return device_name(device)
    try:
        return device_name(torch.device(device))
    except RuntimeError:
        return device  # not a device spec: already a reported name
