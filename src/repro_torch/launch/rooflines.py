"""Roofline constants for the target accelerator: one NVIDIA H100 SXM.

Side-effect-free home for the machine model, with the names of the
reference's ``launch/rooflines.py``.  Values are NVIDIA's H100 SXM data
sheet figures (dense bf16 tensor-core rate, HBM3 bandwidth, the host link
per direction) at the full 700 W power limit; a card capped below that runs
slower.  ``diffusion.tiers.roofline_tier_bw`` calibrates tier bandwidths
from them; the serving path's tiers use ``bw=inf`` and never read them.
"""

PEAK_FLOPS = 989e12         # bf16, dense
HBM_BW = 3.35e12            # bytes/s
# The link the dram tier's roofline reads (``roofline_tier_bw("dram")``).
# Keeping the reference's name: on one H100 SXM a host<->device swap-in
# rides PCIe Gen5 x16, 64 GB/s per direction, not NVLink (450 GB/s, which
# joins cards, never a card and its host).
ICI_BW = 64e9               # bytes/s
# Local-disk class for the KV spill tier (the reference's 1/25 of a 450 GB/s
# link), pinned as a literal so the host-link constant does not move it.
DISK_BW = 18e9              # bytes/s
# Card-to-card links of an H100 cluster, for the dry run's collective term.
# A TPU pod's ICI is one fabric; a 256-card H100 cluster is 32 NVLink
# domains of 8 joined by InfiniBand.  NVLink 4 inside one 8-card HGX node:
# 900 GB/s bidirectional per card on the H100 SXM data sheet, 450 GB/s per
# direction.  Between nodes: one 400 Gb/s NDR InfiniBand adapter per card
# (NVIDIA DGX H100 user guide), 50 GB/s per direction.
NVLINK_BW = 450e9           # bytes/s
IB_BW = 50e9                # bytes/s
NODE_CARDS = 8              # cards one NVLink domain joins

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "DISK_BW", "NVLINK_BW", "IB_BW",
           "NODE_CARDS"]
