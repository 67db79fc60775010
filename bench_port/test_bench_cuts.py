"""A configuration cut to one chip's share (``spec.config_problems``):
built in a temporary directory from olmoe-1b-7b, as a later change would
add it (a new configuration file, and a new part file beside the
benchmark's), it keeps the rules; each broken variant fails with its
rule named."""
import copy
import json
import shutil

import pytest

from bench_port import counts, spec

ENTRY = next(c for c in json.loads((spec.ROOT / "BENCHMARK.json")
                                   .read_text())["configs"]
             if c["name"] == "olmoe-1b-7b")
BASE = spec.read_json(spec.ROOT / ENTRY["file"])
NAME = "olmoe-1b-7b.stage1"


def _cut():
    """olmoe-1b-7b's first of 4 pipeline stages: 4 of its 16 layers, every
    one of its 64 experts and the whole vocabulary."""
    cfg_file = copy.deepcopy(BASE)
    cfg_file.update(
        name=NAME, num_hidden_layers=4, reduced=["num_hidden_layers"],
        published={"num_layers": 16},
        deployment={"chips_per_layer": 1, "pipeline_stages": 4,
                    "layout": "4 pipeline stages of 4 layers, each layer "
                              "whole on its chip; this chip is stage 1"})
    cfg_file["model"].update(num_layers=4)
    return cfg_file


def _vocab_slice(f):
    """A quarter of the vocabulary a chip, as 4 chips that share each layer
    would hold it."""
    f["model"]["vocab_size"] = f["vocab_size"] = 50304 // 4
    f["reduced"].append("vocab_size")
    f["published"]["vocab_size"] = 50304
    f["deployment"]["chips_per_layer"] = 4


def _written(tmp_path, cfg_file):
    """``cfg_file`` written as a configuration file and read back, with the
    ``BENCHMARK.json`` entry it would get."""
    path = tmp_path / f"{cfg_file['name']}.json"
    path.write_text(json.dumps(cfg_file, indent=1))
    entry = dict(ENTRY, name=cfg_file["name"],
                 file=f"bench_port/configs/{cfg_file['name']}.json",
                 reduced=list(cfg_file["reduced"]))
    return entry, spec.read_json(path)


@pytest.mark.parametrize("change", [lambda f: None, _vocab_slice],
                         ids=["depth", "depth_and_vocab"])
def test_a_cut_within_the_floors_keeps_the_rules(tmp_path, change):
    cfg_file = _cut()
    change(cfg_file)
    entry, cfg_file = _written(tmp_path, cfg_file)
    assert spec.config_problems(entry, cfg_file) == []
    cfg = spec.model_config(cfg_file)
    assert (cfg.num_layers, cfg.num_experts) == (4, 64)
    assert counts.token_flops(cfg, 1, cfg_file) > 0


def _model(**fields):
    def change(f):
        f["model"].update(fields)
    return change


def _set(**keys):
    def change(f):
        f.update(keys)
    return change


def _both(*changes):
    def change(f):
        for c in changes:
            c(f)
    return change


def _vocab(n):
    def change(f):
        _vocab_slice(f)
        f["model"]["vocab_size"] = f["vocab_size"] = n
        f["deployment"]["chips_per_layer"] = 16
    return change


def _experts(n):
    """A chip's share of the experts, which the port's router cannot take:
    its width is the experts it holds."""
    def change(f):
        f["model"]["num_experts"] = f["num_experts"] = n
        f["reduced"].append("num_experts")
        f["published"]["num_experts"] = 64
        f["deployment"]["chips_per_layer"] = 64 // n
    return change


#: (what is broken, the change, the rule it breaks)
BROKEN = [
    ("cut_without_published", _set(published={}), "published"),
    ("model_cut_not_published",
     _both(_set(published={"vocab_size": 50304}), _vocab_slice),
     "unlisted"),
    ("changed_key_not_in_reduced", _set(reduced=[]), "reduced"),
    ("model_cut_source_key_unchanged", _set(num_hidden_layers=16), "source"),
    ("source_key_cut_model_not",
     _both(_model(num_layers=16), _set(published={"num_layers": 16})),
     "source"),
    ("uncut_key_in_reduced",
     _set(reduced=["num_hidden_layers", "num_experts"]), "reduced"),
    ("uncut_source_key_changed", _set(num_experts=8), "source"),
    ("width_changed", _model(d_ff=512), "unlisted"),
    ("wrong_published_value", _set(published={"num_layers": 32}),
     "published"),
    ("value_above_published",
     _both(_model(num_layers=32), _set(num_hidden_layers=32)), "cut"),
    ("three_layers", _both(_model(num_layers=3), _set(num_hidden_layers=3)),
     "floor"),
    ("four_experts", _experts(4), "experts"),
    ("eight_of_64_experts", _experts(8), "experts"),
    ("vocab_under_an_eighth", _vocab(6000), "floor"),
    ("empty_deployment", _set(deployment={}), "deployment"),
    ("deployment_a_sentence", _set(deployment="one chip"), "deployment"),
    ("stages_hold_too_few_layers",
     _set(deployment={"chips_per_layer": 1, "pipeline_stages": 2,
                      "layout": "two stages"}), "deployment"),
    ("width_published", _set(published={"num_layers": 16, "d_ff": 1024}),
     "width"),
    ("eps_not_the_published", _model(norm_eps=1e-6), "norm_eps"),
    ("no_reduced_check", _set(reduced_check={}), "reduced_check"),
]


@pytest.mark.parametrize("change,rule", [b[1:] for b in BROKEN],
                         ids=[b[0] for b in BROKEN])
def test_a_broken_cut_fails_its_rule(tmp_path, change, rule):
    cfg_file = _cut()
    change(cfg_file)
    entry, cfg_file = _written(tmp_path, cfg_file)
    problems = spec.config_problems(entry, cfg_file)
    assert any(p.startswith(f"{rule}: ") for p in problems), problems


def test_the_entry_must_list_the_files_cut(tmp_path):
    entry, cfg_file = _written(tmp_path, _cut())
    entry["reduced"] = []
    assert any(p.startswith("reduced: ")
               for p in spec.config_problems(entry, cfg_file))


def test_the_published_models_pass_uncut_only(tmp_path):
    cfg_file = copy.deepcopy(BASE)
    cfg_file["model"]["num_layers"] = 8
    entry, cfg_file = _written(tmp_path, cfg_file)
    assert entry["name"] == "olmoe-1b-7b"
    assert [p.split(":")[0] for p in spec.config_problems(
        entry, cfg_file)] == ["unlisted", "source"]


@pytest.fixture
def parts_dir(tmp_path, monkeypatch):
    """The benchmark's part files copied to a directory of their own, which
    the count reads instead, for a part a later change would add."""
    parts = tmp_path / "parts"
    shutil.copytree(counts.PARTS_DIR, parts,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(counts, "PARTS_DIR", parts)
    counts.part.cache_clear()
    yield parts
    counts.part.cache_clear()


def test_a_new_part_needs_only_new_files(tmp_path, parts_dir):
    (parts_dir / "shared_expert.py").write_text(
        "def flops(cfg, context):\n"
        "    return 2.0 * 3 * cfg.d_model * 2 * cfg.d_ff\n")
    cfg_file = _cut()
    cfg_file["layer_parts"] = {"moe": ["attention", "moe", "shared_expert"]}
    entry, cfg_file = _written(tmp_path, cfg_file)
    assert spec.config_problems(entry, cfg_file) == []
    cfg = spec.model_config(cfg_file)
    shared = 2.0 * 3 * cfg.d_model * 2 * cfg.d_ff
    assert counts.token_flops(cfg, 5, cfg_file) == counts.token_flops(
        cfg, 5) + cfg.num_layers * shared
    assert counts.layers_with(cfg, "shared_expert", cfg_file) == 4
