"""PyTorch/CUDA port of :mod:`repro` — the UCIe on-package memory
design-space engine on one NVIDIA H100.

The package imports ``torch``, numpy and the standard library only; it
keeps its own copies of every dataclass and constant it needs from the
JAX reference.  Module paths mirror ``repro`` (``core/ucie.py``,
``kernels/flit_sim/ref.py``, ...).  Entry points run on the card unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
