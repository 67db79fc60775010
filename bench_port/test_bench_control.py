"""The control of the correctness check: the plain reference in fp8, the
precision below the port's bf16, put in the port's place (its top token at
each served position, judged by the f32 reference) must come out as not
correct.  On the card at each cell's own size (``cuda``: skips without a
card); on the CPU at the reduced sizes, where its widest gap over three
seeds must pass the port's."""
import time

import pytest
import torch

from bench_port import spec
from bench_port.conftest import reduced
from bench_port.session import readings, serve

CELLS = [w["name"] for w in spec.read_json(spec.ROOT / "BENCHMARK.json")
         ["workloads"]]
SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


def _readings(cell, seed, seconds, device):
    sv = serve(cell, seed, seconds, False, torch.device(device),
               time.perf_counter())
    chosen, g = readings(cell, sv, seed, ("fp8",))
    assert chosen, "no request finished in the window"
    return float(g["served"].max()), float(g["fp8"].max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, need_cuda):
    cell = spec.load_cell(name)
    limit = cell.workload["check"]["limits"]["logit_gap"]
    for seed in SEEDS:
        # a window long enough that the sample fills (chat: 32 requests)
        served, control = _readings(cell, seed, 25.0, "cuda")
        assert served <= limit < control, (seed, served, limit, control)


@pytest.mark.parametrize("name", ["olmoe-1b-7b.code_long_prompt",
                                  "mamba2-2.7b.code_long_prompt"])
def test_control_reads_above_the_port_reduced(name):
    cell = reduced(name, requests=6)
    got = [_readings(cell, seed, 2.5, "cpu") for seed in SEEDS]
    assert max(c for _, c in got) > max(s for s, _ in got), got
