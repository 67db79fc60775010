"""Pytest settings of the benchmark's tests: the ``cuda`` marker (tests
that need a card skip without one, deciding inside the test), and a
reduced copy of a cell for the CPU."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (skips without them)")


#: the reduced cells' traffic: short requests, so that a window of a second
#: or two on a loaded CPU still finishes many of them, with outputs longer
#: than prompts, so that a decode step's fault reaches most of the context
SHORT_MIX = {"prompt": {"median": 12, "sigma": 0.3, "min": 8, "max": 24},
             "output": {"median": 24, "sigma": 0.3, "min": 16, "max": 48},
             "block": 64}


def reduced(name: str, clients: int = 4, requests: int = 4, **workload):
    """Cell ``name`` at its configuration's ``reduced()`` sizes and the
    short mix above, with ``clients`` clients and slots and ``requests``
    checked, its gap limit the configuration file's ``reduced_check``."""
    from bench_port import spec
    cell = spec.load_cell(name)
    cfg = spec.model_config(cell.config).reduced()
    limits = dict(cell.workload["check"]["limits"],
                  logit_gap=cell.config["reduced_check"]["logit_gap"])
    wl = dict(cell.workload, clients=clients, batch_slots=clients,
              max_len=128, check=dict(requests=requests, limits=limits))
    wl.update(workload)
    return dataclasses.replace(
        cell, workload=wl, traffic=dict(cell.traffic, **SHORT_MIX),
        config=dict(cell.config, model=dataclasses.asdict(cfg)))


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads a test: the suite runs in several workers."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def need_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
