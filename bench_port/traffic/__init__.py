"""Traffic mixes (``<mix>.json``, parameters only) and the one generator
that reads them (:mod:`bench_port.traffic.generator`)."""
