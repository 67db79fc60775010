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


#: ``ModelConfig`` fields that the published models state and the port's
#: registry may leave at its defaults: the norm's epsilon, a tied head, the
#: vocabulary padded by under 16 rows
PUBLISHED = ("norm_eps", "tie_embeddings", "vocab_size")
#: the ``ModelConfig`` fields a cut to one chip's share may make smaller,
#: each with the source keys that state it in a configuration file: depth,
#: and the chip's rows of the vocabulary, never a width
CUTS = {"num_layers": ("num_hidden_layers", "n_layer"),
        "vocab_size": ("vocab_size",)}
#: the source keys of the expert count, which a cut leaves as published:
#: the port's ``num_experts`` is the router's width as well as the experts
#: held, so a chip's share of the experts waits for an expert layer that is
#: told which experts it holds and routes over all of them
EXPERT_KEYS = ("num_experts", "num_local_experts", "n_routed_experts")
#: the top-level keys under which a configuration file states the published
#: norm epsilon, by its source's naming
EPS_KEYS = ("rms_norm_eps", "norm_epsilon")


def config_problems(entry: Dict[str, Any],
                    cfg_file: Dict[str, Any]) -> List[str]:
    """What keeps ``cfg_file`` (a parsed ``configs/<name>.json``) and its
    ``BENCHMARK.json`` entry from the benchmark's rules for a
    configuration, each led by its rule's name; empty where they hold.

    The file's ``model`` is the port's registry entry of its ``name`` as
    published, or a cut of it to one chip's share.  A cut gives in
    ``published`` each ``ModelConfig`` field it makes smaller (one of
    :data:`CUTS`) with the registry's value, sets that field's source keys
    in the file to the cut value and lists them, and only them, in
    ``reduced`` (as the entry does), and gives in ``deployment`` the chips
    that share a layer and the pipeline's stages, which together hold the
    published model.  It keeps the floors: 4 layers and whole periods of
    ``block_pattern``, an eighth of the vocabulary.  The experts are never
    cut (:data:`EXPERT_KEYS`)."""
    from repro_torch.configs import get
    problems: List[str] = []

    def bad(rule: str, what: str) -> None:
        problems.append(f"{rule}: {what}")

    name = cfg_file.get("name")
    if entry["name"] != name or entry["source"] != cfg_file.get("source") \
            or entry["file"] != f"bench_port/configs/{name}.json":
        bad("file", f"entry {entry['name']!r} ({entry['file']}) and file "
            f"{name!r} differ in name, source or path")
    if not (BENCH_DIR / "reference"
            / f"{cfg_file.get('reference')}.py").is_file():
        bad("reference", f"no reference/{cfg_file.get('reference')}.py")
    check = cfg_file.get("reduced_check", {})
    if not (check.get("logit_gap", 0) > 0 and check.get("why")):
        bad("reduced_check", "needs a logit_gap above 0 and its why")
    reduced = cfg_file.get("reduced")
    if entry["reduced"] != reduced:
        bad("reduced", f"the entry's {entry['reduced']} is not the file's "
            f"{reduced}")
    try:
        ours = dataclasses.asdict(model_config(cfg_file))
        port = dataclasses.asdict(get(ours["name"]))
    except (KeyError, TypeError) as e:
        bad("model", f"not the port's ModelConfig of a registry name: {e}")
        return problems

    published = cfg_file.get("published", {})
    if bool(published) != bool(reduced):
        bad("published", f"states {sorted(published)} for the cut "
            f"{reduced}: both or neither")
    for key, value in published.items():
        if key == "num_experts":
            bad("experts", "the port's num_experts is the router's width "
                "too: a chip's share of the experts needs an expert layer "
                "that routes over all of them")
        elif key not in CUTS:
            bad("width", f"{key} may not be cut (only {', '.join(CUTS)})")
        elif value != port[key]:
            bad("published", f"{key} {value}, the port's registry has "
                f"{port[key]}")
        elif not ours[key] < value:
            bad("cut", f"{key} {ours[key]} is not under the published "
                f"{value}")
    for key in ours:
        if ours[key] != port[key] and key not in PUBLISHED \
                and key not in published:
            bad("unlisted", f"{key} is {ours[key]!r}, the registry's "
                f"{port[key]!r}: list the cut in published")
    if "vocab_size" not in published \
            and abs(ours["vocab_size"] - port["vocab_size"]) >= 16:
        bad("unlisted", f"vocab_size {ours['vocab_size']} is more than "
            f"padding of the registry's {port['vocab_size']}")

    # the source keys, which the catalog compares, state what runs
    cut_keys = []
    for field, keys in dict(CUTS, num_experts=EXPERT_KEYS).items():
        stated = [k for k in keys if k in cfg_file]
        if field in published:
            cut_keys += stated
            if not stated:
                bad("source", f"the cut {field} needs its source key, one "
                    f"of {', '.join(keys)}")
        for k in stated:
            slack = 16 if field == "vocab_size" and field not in published \
                else 1
            if abs(cfg_file[k] - ours[field]) >= slack:
                bad("source", f"{k} {cfg_file[k]} does not state the "
                    f"model's {field} {ours[field]}")
    if sorted(reduced or []) != sorted(cut_keys):
        bad("reduced", f"{reduced} is not the cut's source keys "
            f"{cut_keys}")

    if reduced:
        dep = cfg_file.get("deployment")
        if not (isinstance(dep, dict) and dep.get("layout")
                and all(isinstance(dep.get(k), int) and dep[k] >= 1
                        for k in ("chips_per_layer", "pipeline_stages"))):
            bad("deployment", "a cut needs chips_per_layer, "
                "pipeline_stages and layout")
        else:
            for key in set(published) & set(CUTS):
                share = dep["pipeline_stages" if key == "num_layers"
                            else "chips_per_layer"]
                if ours[key] * share < published[key]:
                    bad("deployment", f"{ours[key]} {key} x {share} hold "
                        f"less than the published {published[key]}")
    if "num_layers" in published:
        period = len(ours["block_pattern"]) or 1
        if ours["num_layers"] < 4 or ours["num_layers"] % period:
            bad("floor", f"num_layers {ours['num_layers']}: at least 4, "
                f"in whole periods of {period}")
    if "vocab_size" in published \
            and 8 * ours["vocab_size"] < published["vocab_size"]:
        bad("floor", f"vocab_size {ours['vocab_size']}: at least an "
            f"eighth of {published['vocab_size']}")

    eps = [cfg_file[k] for k in EPS_KEYS if k in cfg_file]
    if eps != [ours["norm_eps"]]:
        bad("norm_eps", f"{ours['norm_eps']} against the published {eps} "
            f"(one of {', '.join(EPS_KEYS)})")
    return problems


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` as the configuration file states it
    (its ``model`` object holds every field that differs from the
    dataclass's defaults)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**config["model"])
