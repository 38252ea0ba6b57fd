"""The yardstick's table of peaks and the kernels' bytes models.

Peaks are NVIDIA's data-sheet figures at the full power limit; a card set
below it runs slower, so every run's context line gives the card's power
limit beside them.  A bytes model counts each input byte read once and
each output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12}
I32 = 4


def hbm_bytes_per_s(device_name: str) -> float | None:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in device_name:
            return rate
    return None


def device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""


def merge_bytes(S: int, E: int, R: int) -> int:
    """K4, the S-way OR-Set state merge: S clocks (R) and S add and
    remove planes (E, R) in, one clock and one add and remove plane out."""
    return I32 * (S * (2 * E * R + R) + (2 * E * R + R))


def roofline_pct(bytes_needed: float, device_seconds: float) -> float | None:
    """Share of the card's memory rate: None where nothing was timed or
    the card is not in the table."""
    rate = hbm_bytes_per_s(device_name())
    if not rate or device_seconds <= 0 or bytes_needed <= 0:
        return None
    return 100.0 * bytes_needed / device_seconds / rate
