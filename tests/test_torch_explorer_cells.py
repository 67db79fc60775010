"""The explorer's two modes that read dry-run cells, against the
reference's ``examples/memsys_explorer.py`` on the same artifacts.

A directory holds two cell artifacts written by the port's dry run
(``repro_torch.launch.dryrun.run_cell`` at two layers on the CPU), the
aggregate ``design_space.json`` and an axes-first export, which both
explorers skip (``is_cell_artifact``).  The reference's ``DRYRUN`` is
pointed at the same directory with ``monkeypatch``:

  * ``explore(d)`` prints the reference's lines for each cell, and the
    default mode prints them for the first three cells, or for one file;
  * ``--bridge`` stacks the cells (not the representative workloads) and
    prints the reference's workload lines: the cell count, and each
    workload's mix, winner, memory term, read-fraction frontier and
    shoreline budgets."""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest

from repro_torch import explorer
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("mamba2-2.7b", "decode_32k"), ("smollm-360m", "prefill_32k"))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "memsys_explorer", ROOT / "examples" / "memsys_explorer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cell_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    for arch, shape in CELLS:
        dryrun.run_cell(arch, shape, multi_pod=False, out_dir=str(d),
                        verbose=False, device="cpu",
                        cfg_overrides=dict(num_layers=2))
    (d / "design_space.json").write_text(json.dumps({"workloads": {}}))
    (d / "axes_export.json").write_text(json.dumps(
        {"arch": "x", "shape": "y", "mesh": "z", "roofline": {},
         "axes": ["phy", "mix"]}))
    return d


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue()


def test_cell_artifacts_skip_aggregates(cell_dir, monkeypatch):
    ref = _reference()
    monkeypatch.setattr(ref, "DRYRUN", str(cell_dir))
    got = [Path(p).name for p, _ in explorer.cell_artifacts(cell_dir)]
    assert got == [Path(p).name for p in ref._cell_files()]
    assert got == sorted(f"{a}__{s}__16x16.json" for a, s in CELLS)


def test_explore_lines_equal_reference(cell_dir):
    ref = _reference()
    for _, d in explorer.cell_artifacts(cell_dir):
        want = _printed(ref.explore, d)
        assert _printed(explorer.explore, d) == want
        assert want.count("GB/s") == len(d["memsys_bridge"]["systems"])


def test_default_mode_equals_reference(cell_dir, monkeypatch):
    ref = _reference()
    monkeypatch.setattr(ref, "DRYRUN", str(cell_dir))
    monkeypatch.setattr("sys.argv", ["memsys_explorer.py"])
    want = _printed(ref.main)
    assert _printed(explorer.main, ["--out", str(cell_dir)]) == want
    one = sorted(cell_dir.glob("smollm*.json"))[0]
    monkeypatch.setattr("sys.argv", ["memsys_explorer.py", str(one)])
    assert _printed(explorer.main, [str(one)]) == _printed(ref.main)


def _workload_lines(text):
    """From the cell count to the joint frontier's first line, less the
    timing line."""
    lines = text.splitlines()
    start = next(i for i, l in enumerate(lines)
                 if "workload cells from dry-run artifacts" in l)
    stop = next(i for i, l in enumerate(lines)
                if "analytic-vs-simulated frontier" in l
                or "worst simulated-vs-analytic" in l)
    return [l for l in lines[start:stop]
            if not l.startswith("design space:")]


def test_bridge_over_cells_equals_reference(cell_dir, tmp_path,
                                            monkeypatch):
    ref = _reference()
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for f in cell_dir.glob("*.json"):
        (ref_dir / f.name).write_text(f.read_text())
    monkeypatch.setattr(ref, "DRYRUN", str(ref_dir))
    want = _workload_lines(_printed(ref.bridge_mode))
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    for f in cell_dir.glob("*.json"):
        (port_dir / f.name).write_text(f.read_text())
    got = _workload_lines(_printed(explorer.bridge_mode, port_dir,
                                   device="cpu"))
    assert want[0] == f"{len(CELLS)} workload cells from dry-run artifacts"
    assert got == want
    ds = json.loads((port_dir / "design_space.json").read_text())
    assert sorted(ds["workloads"]) == sorted(
        f"{a}__{s}__16x16" for a, s in CELLS)
