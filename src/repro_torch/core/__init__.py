"""Paper models of the port: PHY catalog, protocol closed forms, flit
simulators, catalog programs, selection and the axes-first design space.

Submodules are imported directly (``from repro_torch.core import
space``); this package module imports nothing, so importing one model
never drags in the others.
"""
