"""Roofline of the port: the H100 chip model (``hw``), the FLOP, byte and
collective counts of a traced step (``counts``), the roofline terms and the
workload -> design-space bridge (``analysis``)."""
