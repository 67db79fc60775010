"""Benchmark of the PyTorch/CUDA port (``src/repro_torch``): closed-loop
serving cells on one card.  ``python3 bench_port/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``; see ``README.md``."""
