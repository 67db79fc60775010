"""Target hardware model of the port: the NVIDIA H100 SXM5 80 GB (port of
:mod:`repro.roofline.hw`, whose constants are a TPU's), and the paper's
UCIe-Memory alternatives for its memory system.

The field names are the reference's, so a term maps onto its
counterpart: ``ici_*`` is the chip-to-chip fabric, here NVLink 4.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "h100-sxm5-80gb"
    #: dense bf16 tensor-core rate (the bound every kernel row of PERF.md
    #: is held to)
    peak_bf16_flops: float = 989e12
    hbm_bandwidth: float = 3.35e12         # bytes/s, HBM3
    hbm_capacity: float = 80e9             # bytes
    #: NVLink 4, NVIDIA's H100 datasheet: 900 GB/s over 18 links, so
    #: 50 GB/s a link (both directions together, as the datasheet's total
    #: counts them)
    ici_link_bandwidth: float = 50e9
    ici_links: int = 18
    #: across hosts: one 400 Gb/s ConnectX-7 port a GPU (NVIDIA's DGX H100
    #: datasheet)
    dcn_bandwidth: float = 50e9


H100 = ChipSpec()


def memsys_alternatives(shoreline_mm: float = 8.0):
    """The paper's memory systems sized to a die shoreline: what the HBM
    term becomes if the chip's memory were attached via UCIe-Memory."""
    from repro_torch.core.memsys import standard_catalog
    return standard_catalog(), shoreline_mm
