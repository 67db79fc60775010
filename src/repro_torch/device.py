"""Device selection shared by every entry point of the port.

The port runs on the card: ``device=None`` means ``"cuda"``.  A caller
that wants the CPU says so with ``device="cpu"``; nothing falls back to
the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """The ``torch.device`` an entry point runs on; raises when a CUDA
    device is asked for (explicitly or by default) and none is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
