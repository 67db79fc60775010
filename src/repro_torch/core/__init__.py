"""Paper models of the port: PHY catalog, protocol closed forms, flit
simulators, catalog programs, selection, the axes-first design space and
its streamed evaluation (:mod:`repro_torch.core.streaming`, reached
through ``DesignSpace.evaluate(..., stream=StreamConfig(...))``).

Submodules are imported directly (``from repro_torch.core import
space``); this package module imports nothing, so importing one model
never drags in the others.
"""
