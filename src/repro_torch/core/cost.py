"""Relative cost model — the paper's fourth axis ("low cost").

The paper argues cost qualitatively from two cited facts:
  * HBM is 5-10x more expensive per bit than LPDDR (refs 9-11);
  * advanced (2.5D) packaging costs more than standard (2D) packaging,
    and wire-bonded LPDDR stacks are cheaper than TSV HBM stacks.

We encode these as a parameterized relative-cost calculator so the
benchmark can rank full memory systems ($/GB and $/(GB/s)) under the
same assumptions the paper states.  All numbers are *relative* to
LPDDR-bit-cost = 1.0; absolute dollars are out of scope (and of the
paper's).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostParams:
    lpddr_bit_cost: float = 1.0
    hbm_bit_cost: float = 7.5          # middle of the cited 5-10x range
    # packaging adders, relative units per mm^2 of interconnect footprint
    standard_pkg_cost_mm2: float = 1.0  # organic substrate (UCIe-S, LPDDR)
    advanced_pkg_cost_mm2: float = 2.5  # silicon bridge/interposer (UCIe-A, HBM)
    # die adders
    logic_die_cost: float = 0.5        # per stack: buffer/controller die
    tsv_stack_premium: float = 1.5     # HBM TSV stacking premium (per stack)
    wirebond_stack_premium: float = 0.2  # LPDDR wire-bonded stack (per stack)


@dataclasses.dataclass(frozen=True)
class MemorySystemCost:
    name: str
    dram_kind: str                 # "lpddr" | "hbm"
    packaging: str                 # "standard" | "advanced"
    uses_logic_die: bool
    stacked_tsv: bool
    footprint_mm2: float           # interconnect footprint per stack
    capacity_gb: float = 16.0
    bandwidth_gbs: float = 256.0

    def relative_cost(self, p: CostParams = CostParams()) -> float:
        bit = p.lpddr_bit_cost if self.dram_kind == "lpddr" else p.hbm_bit_cost
        cost = bit * self.capacity_gb
        cost += (p.standard_pkg_cost_mm2 if self.packaging == "standard"
                 else p.advanced_pkg_cost_mm2) * self.footprint_mm2
        if self.uses_logic_die:
            cost += p.logic_die_cost
        cost += p.tsv_stack_premium if self.stacked_tsv else p.wirebond_stack_premium
        return cost

    def cost_per_gb(self, p: CostParams = CostParams()) -> float:
        return self.relative_cost(p) / self.capacity_gb

    def cost_per_gbs(self, p: CostParams = CostParams()) -> float:
        return self.relative_cost(p) / self.bandwidth_gbs


def reference_systems() -> list:
    """The paper's comparison set, at equal 16 GB capacity per stack."""
    return [
        MemorySystemCost("HBM4(native)", "hbm", "advanced",
                         uses_logic_die=True, stacked_tsv=True,
                         footprint_mm2=8.0 * 2.5, bandwidth_gbs=1638.4),
        MemorySystemCost("LPDDR6(native)", "lpddr", "standard",
                         uses_logic_die=False, stacked_tsv=False,
                         footprint_mm2=8.7 * 1.75, bandwidth_gbs=307.2),
        MemorySystemCost("UCIe-A+HBM-stack(B)", "hbm", "advanced",
                         uses_logic_die=True, stacked_tsv=True,
                         footprint_mm2=0.7776 * 1.585, bandwidth_gbs=512.0),
        MemorySystemCost("UCIe-A+LPDDR6-wirebond(E)", "lpddr", "advanced",
                         uses_logic_die=True, stacked_tsv=False,
                         footprint_mm2=0.7776 * 1.585, bandwidth_gbs=512.0),
        MemorySystemCost("UCIe-S+LPDDR6-wirebond(E)", "lpddr", "standard",
                         uses_logic_die=True, stacked_tsv=False,
                         footprint_mm2=1.143 * 1.54, bandwidth_gbs=256.0),
        MemorySystemCost("UCIe-S+LPDDR6-native(A)", "lpddr", "standard",
                         uses_logic_die=False, stacked_tsv=False,
                         footprint_mm2=1.143 * 1.54, bandwidth_gbs=256.0),
    ]
