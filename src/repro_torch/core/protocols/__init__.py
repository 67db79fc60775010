"""The paper's five protocol mappings (A-E) + incumbent bus baselines
(port of :mod:`repro.core.protocols`)."""
from repro_torch.core.protocols.base import MemoryProtocol
from repro_torch.core.protocols.lpddr6_ucie import (
    LPDDR6NativeUCIe, LPDDR6OnUCIe,
)
from repro_torch.core.protocols.hbm_ucie import HBMOnUCIe
from repro_torch.core.protocols.chi_ucie import CHIOnUCIe
from repro_torch.core.protocols.cxl_mem import CXLMemOnUCIe
from repro_torch.core.protocols.cxl_mem_opt import CXLMemOptOnUCIe
from repro_torch.core.protocols.baselines import (
    HBM3, HBM4, LPDDR5, LPDDR6, BidirectionalBusMemory,
)

#: The paper's approaches, instantiated (A, B, C, D, E).
APPROACH_A = LPDDR6OnUCIe()
APPROACH_A_NATIVE = LPDDR6NativeUCIe()
APPROACH_B = HBMOnUCIe()
APPROACH_C = CHIOnUCIe()
APPROACH_D = CXLMemOnUCIe()
APPROACH_E = CXLMemOptOnUCIe()

ALL_APPROACHES = {
    "A:lpddr6-asym": APPROACH_A,
    "A2:lpddr6-native": APPROACH_A_NATIVE,
    "B:hbm-asym": APPROACH_B,
    "C:chi-sym": APPROACH_C,
    "D:cxl-mem": APPROACH_D,
    "E:cxl-mem-opt": APPROACH_E,
}

BASELINES = {
    "LPDDR5": LPDDR5,
    "LPDDR6": LPDDR6,
    "HBM3": HBM3,
    "HBM4": HBM4,
}

__all__ = [
    "ALL_APPROACHES", "BASELINES", "BidirectionalBusMemory", "CHIOnUCIe",
    "CXLMemOnUCIe", "CXLMemOptOnUCIe", "HBMOnUCIe", "LPDDR6NativeUCIe",
    "LPDDR6OnUCIe", "MemoryProtocol",
]
