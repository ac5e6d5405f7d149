"""Roofline constants for the target accelerator: one NVIDIA H100 SXM.

Side-effect-free home for the machine model, with the names of the
reference's ``launch/rooflines.py``.  Values are NVIDIA's H100 SXM data
sheet figures (dense bf16 tensor-core rate, HBM3 bandwidth, NVLink per
direction) at the full 700 W power limit; a card capped below that runs
slower.  ``diffusion.tiers.roofline_tier_bw`` calibrates tier bandwidths
from them; the serving path's tiers use ``bw=inf`` and never read them.
"""

PEAK_FLOPS = 989e12         # bf16, dense
HBM_BW = 3.35e12            # bytes/s
ICI_BW = 450e9              # bytes/s, NVLink 4 per direction
# Local-disk class for the KV spill tier: pinned at 1/25 of the interconnect,
# the ratio ``diffusion.tiers.roofline_tier_bw`` has always used.
DISK_BW = ICI_BW / 25.0     # bytes/s

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "DISK_BW"]
