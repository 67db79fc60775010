"""Micro-architecture latency model — Fig 9 of the paper (§IV.A).

UCIe-Memory round-trip pipeline at a 2 GHz logic clock (32 GT/s link,
internal clock = forwarded clock / 16):

    analog PHY TX .......... 0.5 ns        } 1 ns round-trip
    analog PHY RX .......... 0.5 ns        }
    logical PHY (FDI<->bump, (de)scramble single ex-or level, CRC 5 gate
    levels, mux/demux, drift FIFO) ... 2 ns round-trip *including* analog
    flit pack .............. 0.5 ns (1 cycle @ 2 GHz, half counted each way)
    flit unpack ............ 0.5 ns

    => 3 ns round-trip from the memory protocol layer.

Measured silicon equivalents for the incumbent front-ends: LPDDR5 7.5 ns,
HBM3 6 ns (LPDDR6 / HBM4 expected similar).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class PipelineStage:
    name: str
    cycles: float            # logic-clock cycles, round-trip contribution


@dataclasses.dataclass(frozen=True)
class UCIeMemoryLatency:
    """Round-trip interconnect latency of UCIe-Memory (protocol layer)."""

    logic_clock_ghz: float = 2.0
    # Fig 9 decomposition (round-trip cycles at the logic clock).
    stages: Tuple[PipelineStage, ...] = (
        PipelineStage("analog-phy-tx+rx", 2.0),       # 0.5 ns x2
        PipelineStage("logical-phy(fdi<->bump)", 2.0),  # remainder of the 2ns RT
        PipelineStage("flit-pack+unpack", 2.0),       # 1 cycle each way
    )

    @property
    def roundtrip_ns(self) -> float:
        return sum(s.cycles for s in self.stages) / self.logic_clock_ghz

    def breakdown_ns(self) -> Dict[str, float]:
        return {s.name: s.cycles / self.logic_clock_ghz for s in self.stages}

    def at_data_rate(self, gtps: float) -> "UCIeMemoryLatency":
        """Other data rates keep the 1/16 internal-clock ratio (§IV.A)."""
        return dataclasses.replace(self, logic_clock_ghz=gtps / 16.0)


#: Measured silicon equivalents (paper §IV.A).
MEASURED_FRONTEND_LATENCY_NS = {
    "UCIe-Memory": UCIeMemoryLatency().roundtrip_ns,   # 3.0
    "LPDDR5": 7.5,
    "LPDDR6": 7.5,   # "similar results expected in LPDDR6"
    "HBM3": 6.0,
    "HBM4": 6.0,     # "... and HBM4 respectively"
}


def latency_speedup() -> Dict[str, float]:
    """Paper headline: 'lower latency (up to 3x)' vs incumbents."""
    u = MEASURED_FRONTEND_LATENCY_NS["UCIe-Memory"]
    return {k: v / u for k, v in MEASURED_FRONTEND_LATENCY_NS.items()
            if k != "UCIe-Memory"}
