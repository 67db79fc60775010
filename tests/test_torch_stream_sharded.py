"""The design-space stream sharded over ranks (``StreamConfig(devices=N)``,
``core/streaming.py``) on the CPU: four gloo ranks in a fresh interpreter
(``repro_torch.launch.mesh.spawn``, with a timeout, as
``tests/test_torch_distributed.py`` runs its ranks), every case in one
spawned body; results cross back as pickles in ``tmp_path``.

  (a) the simulated path on the reference's own sharded space
      (``tests/test_streaming.py``'s ``TestStreamingDistributed``: 3
      perturbations x 4 backlogs x 11 read fractions, ``n_flits =
      n_accesses = 96``, 132 cells) at ``chunk_cells`` 7 (5 dispatches, 8
      padded cells) and 4096 (chunk 33, one dispatch), and a 30-cell space
      at 7, where ranks 1-3 hold only padding in the last window.  Every
      field equals the port's one-card stream bit for bit (the plan fields
      are the reference's for 4 devices), and the winners and win counts
      equal the reference's MATERIALIZED fixed engine exactly, as
      ``tests/test_torch_streaming.py`` holds the one-card stream (the
      reference's sharded simulated stream fails under the installed JAX:
      ROADMAP R1);
  (b) the analytic path: the reference test's constrained
      ``bandwidth_gbs`` space at ``chunk_cells=4``, ``pj_per_bit``
      (``mode="min"``) on it, and a constraint that leaves ``(none)``
      cells, against the port's one-card stream bitwise and the
      reference's own sharded stream on 4 host devices (a subprocess whose
      first line sets ``XLA_FLAGS``) in every field: winners, win counts
      with ``(none)``, dispatches, chunk, peak cells and devices exactly,
      bests NaN where the reference's are and otherwise within rel 1e-6,
      the bound ``tests/test_torch_streaming.py`` holds the one-card
      stream's bests to (the port's one-card ``pj_per_bit`` closed form
      already ends one f32 ulp from the reference's XLA-compiled one);
  (c) refusals: ``devices=4`` with no world, and ``devices=3`` in a world
      of 4, raise ``ValueError``; ``devices=1`` in the world streams the
      whole space on each rank, as one card does.
"""
import inspect
import math
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.core import space as j_space
from repro_torch.core import space as t_space
from repro_torch.core.selector import SelectionConstraints
from repro_torch.core.space import DesignSpace, StreamConfig

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
FAST = dict(n_flits=96, n_accesses=96)
PERTS = [{}, {"g_slots": 2.0}, {}]

#: name -> (backlogs, read fractions, chunk_cells, dispatches, pad cells)
SIM_CASES = {
    "chunk7": ([2.0, 8.0, 64.0, 128.0], 11, 7, 5, 8),
    "chunk4096": ([2.0, 8.0, 64.0, 128.0], 11, 4096, 1, 0),
    "tail30": ([2.0, 64.0], 5, 7, 2, 26),
}
#: name -> (metric, constraints); all at chunk_cells 4 over 63 cells
CAT_CASES = {
    "bandwidth": ("bandwidth_gbs", dict(packaging="UCIe-A",
                                        max_relative_bit_cost=2.0)),
    "pj_min": ("pj_per_bit", dict(packaging="UCIe-A",
                                  max_relative_bit_cost=2.0)),
    "none_cells": ("bandwidth_gbs", dict(packaging="UCIe-S",
                                         max_power_w=1e-3)),
}
CAT_CHUNK = 4


def sim_axes(sp, backlogs, n_fracs):
    return [sp.axis("protocol_param", PERTS),
            sp.axis("backlog", backlogs),
            sp.axis("read_fraction", np.linspace(0.0, 1.0, n_fracs))]


def cat_axes(sp):
    return [sp.axis("read_fraction", np.linspace(0.0, 1.0, 21)),
            sp.axis("shoreline_mm", [4.0, 8.0, 16.0])]


def sim_stream(case, devices):
    backlogs, n_fracs, chunk = SIM_CASES[case][:3]
    return DesignSpace(sim_axes(t_space, backlogs, n_fracs), device="cpu",
                       **FAST).evaluate(
        metrics=("sim_efficiency",),
        stream=StreamConfig(chunk_cells=chunk, devices=devices))


def cat_stream(case, devices):
    metric, cons = CAT_CASES[case]
    return DesignSpace(cat_axes(t_space), device="cpu").evaluate(
        metrics=(metric,), stream=StreamConfig(
            chunk_cells=CAT_CHUNK, devices=devices,
            constraints=SelectionConstraints(**cons)))


#: the rank script: the case tables and the space functions above, then
#: ``body``
RANK_BODY = '''
def body(rank, world, d):
    from repro_torch.core import flitsim
    calls = []
    real = flitsim._run_cells_fixed

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    flitsim._run_cells_fixed = counted
    out = {}
    for case in SIM_CASES:
        calls.clear()
        sr = sim_stream(case, world)
        out["sim", case] = dict(result=sr, calls=len(calls), info=dict(
            flitsim.last_run_info()["stream.sim"]))
    for case in CAT_CASES:
        sr = cat_stream(case, world)
        out["cat", case] = dict(result=sr, info=dict(
            flitsim.last_run_info()["stream.catalog"]))
    out["alone"] = dict(result=sim_stream("chunk7", 1), info=dict(
        flitsim.last_run_info()["stream.sim"]))
    try:
        sim_stream("chunk7", world - 1)
    except ValueError as e:
        out["refused"] = str(e)
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    mesh_mod.spawn(body, WORLD, (sys.argv[1],))
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's records of every case, from one world of 4 ranks."""
    d = tmp_path_factory.mktemp("stream_sharded")
    head = textwrap.dedent(f"""
        import os, pickle, sys
        import numpy as np
        import torch
        from repro_torch.core import space as t_space
        from repro_torch.core.selector import SelectionConstraints
        from repro_torch.core.space import DesignSpace, StreamConfig
        from repro_torch.launch import mesh as mesh_mod
        torch.set_num_threads(1)
        WORLD, FAST, PERTS, CAT_CHUNK = {WORLD}, {FAST!r}, {PERTS!r}, \\
            {CAT_CHUNK}
        SIM_CASES = {SIM_CASES!r}
        CAT_CASES = {CAT_CASES!r}
    """)
    script = d / "ranks.py"
    script.write_text(head + "".join(
        "\n\n" + inspect.getsource(f) for f in (sim_axes, cat_axes,
                                                sim_stream, cat_stream))
        + "\n\n" + RANK_BODY)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(d)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, \
        f"STDOUT:\n{out.stdout[-4000:]}\nSTDERR:\n{out.stderr[-8000:]}"
    recs = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    return recs


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's sharded analytic streams on 4 host devices, each
    as a dict of its fields."""
    d = tmp_path_factory.mktemp("ref_stream_sharded")
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = \\
            "--xla_force_host_platform_device_count={WORLD}"
        import dataclasses, pickle, sys
        import numpy as np
        from repro.core import space as j_space
        from repro.core.selector import SelectionConstraints
        CAT_CASES = {CAT_CASES!r}
        out = {{}}
        for case, (metric, cons) in CAT_CASES.items():
            sr = j_space.DesignSpace([
                j_space.axis("read_fraction", np.linspace(0.0, 1.0, 21)),
                j_space.axis("shoreline_mm", [4.0, 8.0, 16.0])]).evaluate(
                metrics=(metric,), stream=j_space.StreamConfig(
                    chunk_cells={CAT_CHUNK}, devices={WORLD},
                    constraints=SelectionConstraints(**cons)))
            rec = {{f.name: getattr(sr, f.name)
                   for f in dataclasses.fields(sr) if f.name != "winners"}}
            rec["winners"] = (sr.winners.dims, sr.winners.coords,
                              np.asarray(sr.winners.values, dtype=object))
            out[case] = rec
        with open(sys.argv[1], "wb") as f:
            pickle.dump(out, f)
    """)
    path = d / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", prog, str(path)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, \
        f"STDOUT:\n{out.stdout[-4000:]}\nSTDERR:\n{out.stderr[-8000:]}"
    with open(path, "rb") as f:
        return pickle.load(f)


def same_bests(got, want, rel=0.0):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if math.isnan(v):
            assert math.isnan(got[k]), k
        elif rel:
            assert got[k] == pytest.approx(v, rel=rel), k
        else:
            assert got[k] == v, k


def same_result(got, want, plan=True):
    """Every field of two ``StreamResult`` equal (NaN bests equal NaN);
    ``plan=False`` leaves out the dispatch plan's fields."""
    assert got.winners.dims == want.winners.dims
    assert got.winners.coords == want.winners.coords
    np.testing.assert_array_equal(
        np.asarray(got.winners.values, dtype=object),
        np.asarray(want.winners.values, dtype=object))
    same_bests(got.best_by_label, want.best_by_label)
    skip = {"winners", "best_by_label"} | (set() if plan else {
        "n_dispatches", "chunk_cells", "peak_cells_per_chunk", "devices"})
    for f in got.__dataclass_fields__:
        if f not in skip:
            assert getattr(got, f) == getattr(want, f), f


def ref_plan(n_cells, chunk_cells, devices):
    """The reference's ``_dispatch_plan``: (chunk, dispatches, pad)."""
    chunk = max(1, min(chunk_cells, -(-n_cells // devices)))
    step = devices * chunk
    n = -(-n_cells // step)
    return chunk, n, n * step - n_cells


# -- (a) the simulated path ------------------------------------------------


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_sim_sharded_equals_one_card(ranks, case):
    one = sim_stream(case, 1)
    _, _, chunk_cells, n_disp, pad = SIM_CASES[case]
    chunk, want_disp, want_pad = ref_plan(one.n_stream_cells, chunk_cells,
                                          WORLD)
    assert (want_disp, want_pad) == (n_disp, pad)
    for r, rec in enumerate(ranks):
        sr, info = rec["sim", case]["result"], rec["sim", case]["info"]
        same_result(sr, one, plan=False)
        assert (sr.devices, sr.chunk_cells, sr.n_dispatches,
                sr.peak_cells_per_chunk, sr.compiles) == \
            (WORLD, chunk, n_disp, chunk, 0)
        # one trace-runner call (a launch of each trace kernel on a card)
        # per dispatch on every rank
        assert rec["sim", case]["calls"] == n_disp
        assert (info["dispatches"], info["pad_cells"], info["cells"]) == \
            (n_disp, pad, one.n_stream_cells)
        assert (info["devices"], info["rank"], info["transport"]) == \
            (WORLD, r, "host")
        # the counts (int64) and bests (f64) of every protocol, and every
        # rank's int16 codes of its slots
        n_prot = len(one.labels)
        assert info["reduce_bytes"] == 16 * n_prot + WORLD * 2 * n_disp \
            * chunk
        assert 0.0 <= info["reduce_s"] <= info["elapsed_s"]


def test_tail_windows_leave_ranks_only_padding(ranks):
    """30 cells at chunk 7 over 4 ranks: the second window's cells 28-55
    hold 2 live cells, all on rank 0; ranks 1-3 run padding alone."""
    chunk, n_disp, pad = ref_plan(30, 7, WORLD)
    assert (chunk, n_disp, pad) == (7, 2, 26)
    assert all(WORLD * chunk + r * chunk >= 30 for r in range(1, WORLD))
    ref = j_space.DesignSpace(sim_axes(j_space, *SIM_CASES["tail30"][:2]),
                              **FAST).evaluate(metrics=("sim_efficiency",))
    win = ref["sim_efficiency"].argbest("protocol")
    vals = np.asarray(win.values, dtype=object).ravel()
    for rec in ranks:
        sr = rec["sim", "tail30"]["result"]
        np.testing.assert_array_equal(
            np.asarray(sr.winners.values, dtype=object).ravel(), vals)
        assert sum(sr.win_counts.values()) == 30


@pytest.mark.parametrize("case", ["chunk7", "chunk4096"])
def test_sim_sharded_equals_reference_materialized(ranks, case):
    ref = j_space.DesignSpace(sim_axes(j_space, *SIM_CASES[case][:2]),
                              **FAST).evaluate(metrics=("sim_efficiency",))
    win = ref["sim_efficiency"].argbest("protocol")
    vals = np.asarray(win.values, dtype=object)
    sr = ranks[0]["sim", case]["result"]
    assert sr.winners.dims == win.dims and sr.winners.coords == win.coords
    np.testing.assert_array_equal(
        np.asarray(sr.winners.values, dtype=object), vals)
    assert sr.win_counts == {k: int(np.sum(vals == k)) for k in sr.labels}
    assert sum(sr.win_counts.values()) == sr.n_cells == 132


def test_every_rank_returns_the_same_result(ranks):
    for key in ranks[0]:
        if key in ("refused",):
            continue
        for rec in ranks[1:]:
            same_result(rec[key]["result"], ranks[0][key]["result"])


# -- (b) the analytic path -------------------------------------------------


@pytest.mark.parametrize("case", list(CAT_CASES))
def test_catalog_sharded_equals_one_card(ranks, case):
    one = cat_stream(case, 1)
    chunk, n_disp, pad = ref_plan(one.n_stream_cells, CAT_CHUNK, WORLD)
    for rec in ranks:
        sr, info = rec["cat", case]["result"], rec["cat", case]["info"]
        same_result(sr, one, plan=False)
        assert (sr.devices, sr.chunk_cells, sr.n_dispatches,
                sr.peak_cells_per_chunk) == (WORLD, chunk, n_disp, chunk)
        assert (info["dispatches"], info["pad_cells"]) == (n_disp, pad)
        assert "(none)" in sr.win_counts
        assert sum(sr.win_counts.values()) == sr.n_cells == 63


@pytest.mark.parametrize("case", list(CAT_CASES))
def test_catalog_sharded_equals_reference_sharded(ranks, ref_sharded, case):
    want = dict(ref_sharded[case])
    sr = ranks[0]["cat", case]["result"]
    dims, coords, vals = want.pop("winners")
    assert (sr.winners.dims, sr.winners.coords) == (dims, coords)
    np.testing.assert_array_equal(
        np.asarray(sr.winners.values, dtype=object), vals)
    same_bests(sr.best_by_label, want.pop("best_by_label"), rel=1e-6)
    want.pop("compiles")            # the reference counts its compiles
    for k, v in want.items():
        assert getattr(sr, k) == v, k
    assert sr.devices == WORLD
    if case == "none_cells":
        assert sr.win_counts["(none)"] > 0
        assert any(math.isnan(v) for v in sr.best_by_label.values())
    if case == "pj_min":
        assert sr.mode == "min"


# -- (c) refusals and devices=1 in a world ---------------------------------


def test_sharded_refusals(ranks):
    with pytest.raises(ValueError, match=r"devices=4\).*no torch.distributed"
                       r".*spawn.*torchrun"):
        sim_stream("chunk7", WORLD)
    for rec in ranks:
        assert "devices=3" in rec["refused"]
        assert "world of 4 ranks" in rec["refused"]
        assert "spawn" in rec["refused"]


def test_devices_one_in_a_world_streams_alone(ranks):
    one = sim_stream("chunk7", 1)
    for rec in ranks:
        same_result(rec["alone"]["result"], one)
        assert "devices" not in rec["alone"]["info"]
        assert rec["alone"]["info"]["dispatches"] == one.n_dispatches == 19
