"""The card's published peaks, chosen by its name (NVIDIA's H100 data
sheet, dense rates without sparsity; the port's `tools/common.py`
`peak_bf16` rule, copied): the PCIe card where the name says PCIe, else the
SXM part."""

from __future__ import annotations

PEAKS = {
    "H100 SXM": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
    "H100 PCIe": {"bf16_flops": 756e12, "fp32_flops": 51e12, "hbm_bytes_s": 2.0e12},
}


def peaks(device_name: str) -> dict:
    return PEAKS["H100 PCIe" if "pcie" in device_name.lower() else "H100 SXM"]
