"""Resolve a cell of the benchmark by name.

A cell is ``workloads/<cell>.json``; it names a model configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``).
Its metrics are the entries of the checkout's ``BENCHMARK.json`` whose
``workloads`` list names the cell, or that have no such list.  Nothing here
needs to change when a later change adds a configuration, a mix, a cell or
a metric: each is a new file found by its name.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    workload: Dict[str, Any]      # workloads/<cell>.json
    config: Dict[str, Any]        # configs/<config>.json
    traffic: Dict[str, Any]       # traffic/<mix>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def clients(self) -> int:
        return int(self.workload["clients"])

    @property
    def batch_slots(self) -> int:
        return int(self.workload["batch_slots"])

    @property
    def max_len(self) -> int:
        return int(self.workload["max_len"])

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        """The metrics a run reports: the end-to-end ones untraced, the
        per-layer ones traced."""
        return self.per_layer if trace else self.end_to_end


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = None) -> Cell:
    """The cell ``name`` and the metrics ``benchmark`` (default: the
    checkout's ``BENCHMARK.json``) gives it; ``FileNotFoundError`` for a
    cell with no workload file."""
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"not a cell name: {name!r}")
    wl = read_json(BENCH_DIR / "workloads" / f"{name}.json")
    cfg = read_json(BENCH_DIR / "configs" / f"{wl['config']}.json")
    mix = read_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json")
    bench = read_json(benchmark or ROOT / "BENCHMARK.json")
    return Cell(name, wl, cfg, mix,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` as the configuration file states it
    (its ``model`` object holds every field that differs from the
    dataclass's defaults)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**config["model"])
