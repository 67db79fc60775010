"""UCIe PHY metric model — Table 1 and §IV.B of the paper.

Every quantity the protocol mappings (A-E) scale from lives here:
raw bandwidth, linear (shoreline) and areal bandwidth density, power
efficiency (pJ/b), dynamic power-gating parameters, and round-trip latency.

The canonical instances (``UCIE_S_32G``, ``UCIE_A_32G_55U``) carry the
paper's published density numbers (see DESIGN.md §6.4 for the one
ambiguity in the paper's UCIe-A arithmetic — we adopt the published
numbers as ground truth since Figures 10-12 scale from them).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Tuple


class Packaging(enum.Enum):
    STANDARD = "UCIe-S"   # 2D, 100-130um bump pitch, 25mm reach
    ADVANCED = "UCIe-A"   # 2.5D, 25-55um bump pitch, 2mm reach
    THREE_D = "UCIe-3D"   # hybrid bonding, <=9um pitch


# Idle lane power fraction under fine-grained dynamic power gating
# (§IV.B: "consuming p fraction (p = 0.15) of peak power").
IDLE_POWER_FRACTION = 0.15

# <1ns entry/exit with 85% savings (Table 1) -> we treat gating as free
# to enter/exit at flit granularity, consistent with the paper's analysis.
POWER_GATE_ENTRY_NS = 1.0

#: UCIePhy fields an analytic ``catalog_param`` perturbation may scale
#: (multiplicatively) — the closed-form counterpart of
#: :data:`repro.core.flitsim.PERTURBABLE_FIELDS`: PHY power efficiency and
#: the published shoreline/areal bandwidth densities.
PERTURBABLE_PHY_FIELDS: Tuple[str, ...] = (
    "areal_density_gbs_mm2", "linear_density_gbs_mm", "power_pj_per_bit")


@dataclasses.dataclass(frozen=True)
class UCIePhy:
    """One UCIe module configuration (per direction width)."""

    name: str
    packaging: Packaging
    data_rate_gtps: float          # per-lane signaling rate
    lanes_per_direction: int       # N data lanes each way (16 S / 64 A)
    bump_pitch_um: float
    modules_stacked: int = 2       # paper's density calcs double-stack
    # Published density numbers (GB/s per mm shoreline / per mm^2).
    linear_density_gbs_mm: float = 0.0
    areal_density_gbs_mm2: float = 0.0
    power_pj_per_bit: float = 0.5
    channel_reach_mm: float = 25.0
    # Footprint of the density reference block (both modules).
    edge_mm: float = 0.0
    depth_mm: float = 0.0

    @property
    def raw_bandwidth_gbs(self) -> float:
        """Both directions, all stacked modules, GB/s (GT/s * lanes / 8)."""
        return (2 * self.lanes_per_direction * self.modules_stacked
                * self.data_rate_gtps) / 8.0

    @property
    def raw_bandwidth_per_direction_gbs(self) -> float:
        return (self.lanes_per_direction * self.modules_stacked
                * self.data_rate_gtps) / 8.0

    def scaled(self, data_rate_gtps: float) -> "UCIePhy":
        """Same module at a different data rate (density scales linearly).

        §V: "UCIe should increase the operating frequency while continuing
        to be bump-limited with constant power efficiency."
        """
        f = data_rate_gtps / self.data_rate_gtps
        return dataclasses.replace(
            self,
            name=f"{self.name}@{data_rate_gtps:g}G",
            data_rate_gtps=data_rate_gtps,
            linear_density_gbs_mm=self.linear_density_gbs_mm * f,
            areal_density_gbs_mm2=self.areal_density_gbs_mm2 * f,
        )

    def perturbed(self, pert: Mapping[str, float]) -> "UCIePhy":
        """Multiplicative ``{field: scale}`` perturbation of the analytic
        PHY parameters — the catalog counterpart of the flit simulator's
        ``protocol_param`` scaling (see ``flitsim.apply_perturbation``).

        Only :data:`PERTURBABLE_PHY_FIELDS` may be scaled; anything else
        raises rather than silently producing a baseline labelled as
        perturbed.
        """
        unknown = sorted(k for k in pert if k not in PERTURBABLE_PHY_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown catalog perturbation fields {unknown}; choose "
                f"from {PERTURBABLE_PHY_FIELDS}")
        if not pert:
            return self
        return dataclasses.replace(
            self, **{k: getattr(self, k) * float(s)
                     for k, s in pert.items()})


# --- Canonical instances (paper §IV.B) -------------------------------------

# "A doubly stacked UCIe-S at 32G has a b/w = 2 directions x 32 data lanes
#  x 32 GT/s = 256 GB/s, bandwidth density is 224 GB/s/mm (linear) and
#  145.44 GB/s/mm2 at 110 um bump-pitch."
# x32 link footprint: 1.143mm (die edge) x 1.54mm (depth).
UCIE_S_32G = UCIePhy(
    name="UCIe-S-32G-110u",
    packaging=Packaging.STANDARD,
    data_rate_gtps=32.0,
    lanes_per_direction=16,        # x16 module; x32 link = 2 modules stacked
    bump_pitch_um=110.0,
    modules_stacked=2,
    linear_density_gbs_mm=224.0,
    areal_density_gbs_mm2=145.44,
    power_pj_per_bit=0.5,          # §IV.B: "0.25 to 0.5 pJ/b for UCIe-A/S"
    channel_reach_mm=25.0,
    edge_mm=1.143,
    depth_mm=1.54,
)

# "UCIe-A delivers 512 GB/s bandwidth for 64 data lanes; at 55um bump-pitch,
#  the bandwidth density is 658.44 GB/s/mm and 416.27 GB/s/mm2."
# UCIe-A fixed die-edge 388.8um; depth 1585um at 55um pitch.
UCIE_A_32G_55U = UCIePhy(
    name="UCIe-A-32G-55u",
    packaging=Packaging.ADVANCED,
    data_rate_gtps=32.0,
    lanes_per_direction=64,
    bump_pitch_um=55.0,
    modules_stacked=2,
    linear_density_gbs_mm=658.44,
    areal_density_gbs_mm2=416.27,
    power_pj_per_bit=0.25,
    channel_reach_mm=2.0,
    edge_mm=2 * 0.3888,
    depth_mm=1.585,
)

# 45um-pitch UCIe-A variant (depth 1043um). Density scales with bump count
# ~ (55/45)^2 areally; we scale the published 55u numbers by pitch ratio.
UCIE_A_32G_45U = dataclasses.replace(
    UCIE_A_32G_55U,
    name="UCIe-A-32G-45u",
    bump_pitch_um=45.0,
    depth_mm=1.043,
    linear_density_gbs_mm=658.44 * (55.0 / 45.0),
    areal_density_gbs_mm2=416.27 * (55.0 / 45.0) ** 2,
)


# --- Forward-looking UCIe 2.0 / 48G data points (§V scaling) ----------------
#
# §V: "UCIe should increase the operating frequency while continuing to be
# bump-limited with constant power efficiency" — the 48 GT/s generation
# keeps the lane counts and bump pitches of today's modules, so density
# scales linearly with data rate at constant pJ/b (``UCIePhy.scaled``).

# Standard package at 48 GT/s: 256 -> 384 GB/s per doubly-stacked x32 link.
UCIE_S_48G_110U = dataclasses.replace(
    UCIE_S_32G.scaled(48.0), name="UCIe-S-48G-110u")

# Advanced package at 48 GT/s on the 45um pitch: the paper's densest
# 2.5D point scaled to the next signaling generation.
UCIE_A_48G_45U = dataclasses.replace(
    UCIE_A_32G_45U.scaled(48.0), name="UCIe-A-48G-45u")


def table1() -> dict:
    """Reproduce the key-metrics rows of Table 1 from the model."""
    return {
        "UCIe-2D": {
            "data_rates_gtps": [4, 8, 12, 16, 24, 32],
            "width_per_direction": 16,
            "bump_pitch_um": (100, 130),
            "channel_reach_mm": 25,
            "bw_shoreline_gbs_mm": (28, 224),
            "bw_density_gbs_mm2": (22, 125),
            "power_pj_per_bit": {"<=16G": 0.5, ">16G": 0.6},
            "latency_roundtrip_ns": 2.0,
        },
        "UCIe-2.5D": {
            "data_rates_gtps": [4, 8, 12, 16, 24, 32],
            "width_per_direction": 64,
            "bump_pitch_um": (25, 55),
            "channel_reach_mm": 2,
            "bw_shoreline_gbs_mm": (165, 1317),
            "bw_density_gbs_mm2": None,  # 2.5D @ 45um covered by areal row
            "power_pj_per_bit": 0.25,
            "latency_roundtrip_ns": 2.0,
        },
        "UCIe-3D": {
            "data_rates_gtps": [4],
            "width_per_direction": 80,
            "bump_pitch_um": (1, 9),
            "channel_reach_mm": 0.0,
            "bw_density_gbs_mm2": (4000, 300000),
            "power_pj_per_bit": (0.01, 0.05),
            "latency_roundtrip_ns": 1.0,
        },
    }
