"""Published peaks of the cards the benchmark may run on (NVIDIA's data
sheets, dense rates without sparsity), by the name ``torch.cuda.
get_device_name`` gives. They hold at the card's full power limit; the
traced run prints the limit it found beside them."""
from __future__ import annotations

import subprocess

PEAKS = {
    # H100 SXM: 80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}


def peaks(kind: str):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(kind)


def power_limit() -> str:
    """``name, power.limit`` as ``nvidia-smi`` reads them ("" where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()
