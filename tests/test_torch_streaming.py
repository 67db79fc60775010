"""Streamed evaluation of the port (``evaluate(..., stream=StreamConfig)``,
``core/streaming.py``) on the CPU, on the reference's own grids
(``tests/test_streaming.py``: ``n_flits = n_accesses = 96``).

Equality contract: the streamed winners, win counts and bests equal the
port's materialized ``argbest`` bit for bit at every ``chunk_cells``,
``axis_order`` and ``prefetch``.  The simulated path is also held against
the reference's MATERIALIZED argbest (its streamed simulated path fails
under the installed JAX: ROADMAP R1); the analytic path against the
reference's streamed ``StreamResult`` directly (winners, win counts and
``(none)`` cells exactly, bests rel 1e-6).  Mirrors
``TestStreamingSimEquality``, ``TestStreamingCatalogEquality``,
``TestAsyncDispatch`` and ``TestUnifiedReportAPI::
test_frontier_section_materialized_vs_streaming``."""
import numpy as np
import pytest

from repro.core import space as j_space
from repro.core import ucie as j_ucie
from repro.core.selector import SelectionConstraints as JCons
from repro_torch.core import flitsim
from repro_torch.core import space as t_space
from repro_torch.core import ucie as t_ucie
from repro_torch.core.report import ReportSpec
from repro_torch.core.selector import SelectionConstraints
from repro_torch.core.space import (
    ADAPTIVE_SIM, DesignSpace, StreamConfig, axis,
)
from repro_torch.traces.trace import TrafficTrace

CPU = "cpu"
#: cheap fixed horizons, the reference's: equality holds at any horizon
FAST = dict(n_flits=96, n_accesses=96)


def assert_same_winners(stream_res, materialized):
    assert stream_res.winners.dims == materialized.dims
    assert stream_res.winners.coords == materialized.coords
    np.testing.assert_array_equal(
        np.asarray(stream_res.winners.values, dtype=object),
        np.asarray(materialized.values, dtype=object))


def _sim_axes(sp, uc, n_fracs=5):
    return [sp.axis("protocol_param", [{}, {"g_slots": 2.0}]),
            sp.axis("phy", [uc.UCIE_S_32G, uc.UCIE_A_32G_55U]),
            sp.axis("backlog", [2.0, 64.0]),
            sp.axis("read_fraction", np.linspace(0.0, 1.0, n_fracs))]


def _sim_space(**kw):
    base = dict(FAST)
    base.update(kw)
    return DesignSpace(_sim_axes(t_space, t_ucie), device=CPU, **base)


@pytest.fixture(scope="module")
def sim_materialized():
    """The port's and the reference's materialized simulated metrics on
    the reference's streaming grid."""
    metrics = ("sim_efficiency", "sim_bandwidth_gbs")
    port = _sim_space().evaluate(metrics=metrics)
    ref = j_space.DesignSpace(_sim_axes(j_space, j_ucie),
                              **FAST).evaluate(metrics=metrics)
    return port, ref


def _bests(arr):
    """Each protocol's largest value over every other dim."""
    ax = arr.dims.index("protocol")
    v = np.moveaxis(arr.values, ax, 0).reshape(arr.shape[ax], -1)
    return {k: float(v[i].max()) for i, k in enumerate(arr.coord("protocol"))}


def _counts(winners, labels):
    vals = np.asarray(winners.values, dtype=object).ravel()
    return {k: int(np.sum(vals == k)) for k in labels}


class TestStreamingSimEquality:
    def test_sim_bandwidth_bit_equal(self, sim_materialized):
        port, ref = sim_materialized
        sr = _sim_space().evaluate(metrics=("sim_bandwidth_gbs",),
                                   stream=StreamConfig(chunk_cells=3))
        mat = port["sim_bandwidth_gbs"]
        assert_same_winners(sr, mat.argbest("protocol"))
        assert_same_winners(sr, ref["sim_bandwidth_gbs"].argbest("protocol"))
        # dispatch accounting: 2 perts x 2 backlogs x 5 mixes = 20 streamed
        # cells, x 2 phys broadcast in the chunk
        assert sr.n_stream_cells == 20 and sr.n_cells == 40
        assert sr.chunk_cells == 3 and sr.peak_cells_per_chunk == 6
        assert sr.n_dispatches == 7
        assert sum(sr.win_counts.values()) == sr.n_cells
        assert sr.win_counts == _counts(mat.argbest("protocol"), sr.labels)
        assert sr.best_by_label == _bests(mat)

    def test_chunk_larger_than_space(self, sim_materialized):
        port, ref = sim_materialized
        sr = _sim_space().evaluate(metrics=("sim_efficiency",),
                                   stream=StreamConfig(chunk_cells=10 ** 6))
        assert_same_winners(sr, port["sim_efficiency"].argbest("protocol"))
        assert_same_winners(sr, ref["sim_efficiency"].argbest("protocol"))
        assert sr.n_dispatches == 1 and sr.chunk_cells == 20

    @pytest.mark.parametrize("chunk", [1, 3, 7, 19])
    def test_non_divisor_chunk(self, sim_materialized, chunk):
        port, ref = sim_materialized
        sr = _sim_space().evaluate(metrics=("sim_efficiency",),
                                   stream=StreamConfig(chunk_cells=chunk))
        assert_same_winners(sr, port["sim_efficiency"].argbest("protocol"))
        assert_same_winners(sr, ref["sim_efficiency"].argbest("protocol"))
        assert sr.best_by_label == _bests(port["sim_efficiency"])

    def test_axis_order_invariance(self):
        space = _sim_space()
        ref = space.evaluate(metrics=("sim_efficiency",),
                             stream=StreamConfig(chunk_cells=4))
        per = space.evaluate(metrics=("sim_efficiency",), stream=StreamConfig(
            chunk_cells=4,
            axis_order=("read_fraction", "backlog", "protocol_param")))
        assert_same_winners(per, ref.winners)
        assert per.win_counts == ref.win_counts
        assert per.best_by_label == ref.best_by_label

    def test_bad_axis_order_raises(self):
        with pytest.raises(ValueError, match="permutation"):
            _sim_space().evaluate(
                metrics=("sim_efficiency",),
                stream=StreamConfig(chunk_cells=4,
                                    axis_order=("backlog", "bogus")))

    def test_adaptive_sim_rejected(self):
        with pytest.raises(ValueError, match="fixed-horizon"):
            _sim_space(sim=ADAPTIVE_SIM).evaluate(
                metrics=("sim_efficiency",), stream=StreamConfig())

    def test_constraints_rejected_for_sim_metrics(self):
        with pytest.raises(ValueError, match="analytic metrics only"):
            _sim_space().evaluate(
                metrics=("sim_efficiency",),
                stream=StreamConfig(
                    constraints=SelectionConstraints(max_power_w=5.0)))

    def test_single_metric_contract(self):
        with pytest.raises(ValueError, match="ONE metric"):
            _sim_space().evaluate(metrics=None, stream=StreamConfig())
        with pytest.raises(ValueError, match="ONE metric"):
            _sim_space().evaluate(
                metrics=("sim_efficiency", "sim_bandwidth_gbs"),
                stream=StreamConfig())
        with pytest.raises(ValueError, match="not streamable"):
            _sim_space().evaluate(metrics=("latency_ns",),
                                  stream=StreamConfig())

    @pytest.mark.parametrize("name", ["k", "ucie_line_ui", "trace"])
    def test_uncovered_axis_raises(self, name):
        axes = {"k": [axis("k", [1, 2, 4])],
                "ucie_line_ui": [axis("ucie_line_ui", [8.0])],
                "trace": [axis("trace", [TrafficTrace.steady("s", 0.5,
                                                             8.0)])]}[name]
        metric = "trace_efficiency" if name == "trace" else "utilization"
        with pytest.raises(ValueError, match=f"'{name}' axis"):
            DesignSpace(axes, device=CPU).evaluate(
                metrics=(metric,), stream=StreamConfig())

    def test_sim_bandwidth_needs_a_phy(self):
        with pytest.raises(ValueError, match="raw link bandwidth"):
            DesignSpace([axis("backlog", [8.0]), axis("mix", [(1, 1)])],
                        device=CPU, **FAST).evaluate(
                metrics=("sim_bandwidth_gbs",), stream=StreamConfig())

    def test_inapplicable_perturbation_rejected(self):
        with pytest.raises(ValueError, match="applies to no parameter"):
            DesignSpace([axis("protocol_param", [{}, {"g_slots": 0.5}]),
                         axis("protocol", ["hbm_asym"]),
                         axis("mix", [(1, 1)])], device=CPU,
                        **FAST).evaluate(metrics=("sim_efficiency",),
                                         stream=StreamConfig())


@pytest.mark.parametrize("protocols", [
    ("hbm_asym", "chi"), ("cxl_opt",), ("lpddr6_asym", "hbm_asym")],
    ids=["mixed-order", "symmetric", "asymmetric"])
def test_workload_mix_space_and_protocol_subsets(protocols):
    """Two mix dims (workload_config x mix), a PHY given as
    ``DesignSpace(phy=...)``, no backlog axis and protocol subsets in
    either family order: winners and bests equal the materialized run."""
    axes = [axis("protocol", list(protocols)),
            axis("workload_config", [("a", (67.0, 33.0)),
                                     ("b", (95.0, 5.0))]),
            axis("mix", [t_space.OWN_MIX, (2, 1), (1, 3)])]
    space = DesignSpace(axes, phy=t_ucie.UCIE_A_32G_55U, device=CPU,
                        default_backlog=16.0, **FAST)
    mat = space.evaluate(metrics=("sim_bandwidth_gbs",))["sim_bandwidth_gbs"]
    sr = space.evaluate(metrics=("sim_bandwidth_gbs",),
                        stream=StreamConfig(chunk_cells=4, prefetch=3))
    assert_same_winners(sr, mat.argbest("protocol"))
    assert sr.best_by_label == _bests(mat)
    assert sr.win_counts == _counts(mat.argbest("protocol"), sr.labels)


def test_stream_runs_each_chunk_through_the_trace_runner(monkeypatch):
    """Every dispatch is one call of the per-cell trace runner (one launch
    of each trace kernel on a card), and the eager fixed-horizon loop
    never runs on the path."""
    calls = []
    real = flitsim._run_cells_fixed

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def forbidden(*a, **kw):
        raise AssertionError("the eager fixed loop ran on the stream")
    monkeypatch.setattr(flitsim, "_run_cells_fixed", counted)
    monkeypatch.setattr(flitsim, "_symmetric_efficiency", forbidden)
    monkeypatch.setattr(flitsim, "_asymmetric_efficiency", forbidden)
    sr = _sim_space().evaluate(metrics=("sim_efficiency",),
                               stream=StreamConfig(chunk_cells=3))
    assert len(calls) == sr.n_dispatches == 7


def test_devices_other_than_one_refused():
    """``StreamConfig(devices=4)`` is built (the world is checked when the
    stream runs), ``devices=0`` is not, and a stream over 4 ranks in a
    process with no ``torch.distributed`` world raises, naming both counts
    and how to start one; nothing falls back to one card.  The sharded
    stream itself: ``tests/test_torch_stream_sharded.py``."""
    assert StreamConfig(devices=4).key()[2] == 4
    with pytest.raises(ValueError, match=">= 1"):
        StreamConfig(devices=0)
    assert StreamConfig(devices=1).key()[2] == 1
    with pytest.raises(ValueError, match=r"devices=4\).*1 rank.*spawn"):
        _sim_space().evaluate(metrics=("sim_efficiency",),
                              stream=StreamConfig(devices=4))


def test_compiles_reads_zero_and_frontier_alias():
    sr = _sim_space().evaluate(metrics=("sim_efficiency",),
                               stream=StreamConfig(chunk_cells=8))
    assert sr.compiles == 0 and sr.devices == 1
    assert sr.frontier() is sr.winners


# -- analytic metrics --------------------------------------------------------


def _cat_axes(sp, n_fracs=7):
    return [sp.axis("read_fraction", np.linspace(0.0, 1.0, n_fracs)),
            sp.axis("shoreline_mm", [4.0, 8.0, 16.0])]


def _cat_space(n_fracs=7):
    return DesignSpace(_cat_axes(t_space, n_fracs), device=CPU)


def _ref_stream(metric, n_fracs=7, **kw):
    return j_space.DesignSpace(_cat_axes(j_space, n_fracs)).evaluate(
        metrics=(metric,), stream=j_space.StreamConfig(devices=1, **kw))


def assert_matches_reference_stream(sr, ref):
    assert_same_winners(sr, ref.winners)
    assert sr.win_counts == ref.win_counts
    assert (sr.metric, sr.reduce_dim, sr.mode, sr.labels) == \
        (ref.metric, ref.reduce_dim, ref.mode, ref.labels)
    assert (sr.n_cells, sr.n_dispatches, sr.chunk_cells,
            sr.peak_cells_per_chunk) == (ref.n_cells, ref.n_dispatches,
                                         ref.chunk_cells,
                                         ref.peak_cells_per_chunk)
    for k, v in ref.best_by_label.items():
        if np.isnan(v):
            assert np.isnan(sr.best_by_label[k]), k
        else:
            assert sr.best_by_label[k] == pytest.approx(v, rel=1e-6), k


class TestStreamingCatalogEquality:
    def test_bandwidth_bit_equal(self):
        space = _cat_space()
        res = space.evaluate(metrics=("bandwidth_gbs",))
        sr = space.evaluate(metrics=("bandwidth_gbs",),
                            stream=StreamConfig(chunk_cells=5))
        assert_same_winners(sr, res.frontier("bandwidth_gbs"))
        assert sr.mode == "max" and sr.reduce_dim == "system"
        assert_matches_reference_stream(
            sr, _ref_stream("bandwidth_gbs", chunk_cells=5))

    @pytest.mark.parametrize("metric", ["power_w", "pj_per_bit",
                                        "gbs_per_watt"])
    def test_other_metrics(self, metric):
        space = _cat_space()
        mode = "min" if metric in ("power_w", "pj_per_bit") else "max"
        res = space.evaluate(metrics=(metric,))
        sr = space.evaluate(metrics=(metric,),
                            stream=StreamConfig(chunk_cells=4))
        assert sr.mode == mode
        assert_same_winners(sr, res.frontier(metric, mode=mode))
        assert_matches_reference_stream(sr, _ref_stream(metric,
                                                        chunk_cells=4))

    @pytest.mark.parametrize("cons", [
        dict(packaging="UCIe-A", max_backlog_knee=32.0, max_power_w=40.0),
        dict(max_relative_bit_cost=1.5, required_bandwidth_gbs=200.0),
    ])
    def test_constrained_bit_equal(self, cons):
        space = _cat_space()
        res = space.evaluate(metrics=("bandwidth_gbs", "power_w"))
        ref = res.frontier("bandwidth_gbs",
                           where=res.feasible(SelectionConstraints(**cons)))
        sr = space.evaluate(metrics=("bandwidth_gbs",),
                            stream=StreamConfig(
                                chunk_cells=4,
                                constraints=SelectionConstraints(**cons)))
        assert_same_winners(sr, ref)
        assert_matches_reference_stream(
            sr, _ref_stream("bandwidth_gbs", chunk_cells=4,
                            constraints=JCons(**cons)))

    def test_none_cells_counted(self):
        cons = dict(packaging="UCIe-S", max_power_w=1e-3)
        space = _cat_space()
        res = space.evaluate(metrics=("bandwidth_gbs", "power_w"))
        ref = res.frontier("bandwidth_gbs",
                           where=res.feasible(SelectionConstraints(**cons)))
        sr = space.evaluate(metrics=("bandwidth_gbs",),
                            stream=StreamConfig(
                                chunk_cells=6,
                                constraints=SelectionConstraints(**cons)))
        assert_same_winners(sr, ref)
        n_none = int(np.sum(np.asarray(ref.values, dtype=object)
                            == "(none)"))
        assert n_none > 0 and sr.win_counts["(none)"] == n_none
        assert sum(sr.win_counts.values()) == sr.n_cells
        # labels the constraints never admit report NaN bests
        assert any(np.isnan(v) for v in sr.best_by_label.values())
        assert_matches_reference_stream(
            sr, _ref_stream("bandwidth_gbs", chunk_cells=6,
                            constraints=JCons(**cons)))

    def test_knee_budget_per_workload_config(self):
        """The backlog-knee budget follows each workload config's own mix
        (two mix dims, a custom axis order)."""
        axes = [axis("workload_config", [("a", (67.0, 33.0)),
                                         ("b", (95.0, 5.0))]),
                axis("mix", [t_space.OWN_MIX, (2, 1), (1, 3)]),
                axis("shoreline_mm", [2.0, 8.0])]
        cons = SelectionConstraints(max_backlog_knee=4.0)
        space = DesignSpace(axes, device=CPU, n_flits=256)
        res = space.evaluate(metrics=("bandwidth_gbs",))
        ref = res.frontier("bandwidth_gbs", where=res.feasible(cons))
        sr = space.evaluate(metrics=("bandwidth_gbs",), stream=StreamConfig(
            chunk_cells=5, constraints=cons,
            axis_order=("shoreline_mm", "mix", "workload_config")))
        assert_same_winners(sr, ref)

    def test_threshold_just_below_a_cell_value(self):
        """A power cap whose f32 rounding is a cell's own power: the host's
        mask (f32 array <= cap, compared in f32) admits that cell, and so
        does the stream (ROADMAP R8: the reference's streamed threshold
        assumes an f64 host comparison and rejects it)."""
        space = _cat_space()
        res = space.evaluate(metrics=("bandwidth_gbs", "power_w"))
        pw = np.sort(res["power_w"].values.ravel())
        v = pw[pw.size // 2]
        cap = float(v) - float(np.spacing(v)) / 4
        assert np.float32(cap) == v and cap < float(v)
        cons = SelectionConstraints(max_power_w=cap)
        ref = res.frontier("bandwidth_gbs", where=res.feasible(cons))
        sr = space.evaluate(metrics=("bandwidth_gbs",),
                            stream=StreamConfig(chunk_cells=4,
                                                constraints=cons))
        assert_same_winners(sr, ref)

    def test_phy_axis_routed_to_materialized(self):
        for extra in ([axis("phy", [t_ucie.UCIE_S_32G])],
                      [axis("catalog_param", [{}])]):
            with pytest.raises(ValueError, match="materialized"):
                DesignSpace(extra + [axis("read_fraction", [0.5])],
                            device=CPU).evaluate(
                    metrics=("bandwidth_gbs",), stream=StreamConfig())


class TestAsyncDispatch:
    """Winners, win counts and running bests identical at EVERY in-flight
    depth, and the ``stream.*`` telemetry."""

    def _eval(self, space, **kw):
        return space.evaluate(metrics=("sim_efficiency",),
                              stream=StreamConfig(**kw))

    def test_prefetch_depths_bit_identical(self):
        space = _sim_space()
        seq = self._eval(space, chunk_cells=3, prefetch=1)
        for prefetch in (2, 3, 8):
            sr = self._eval(space, chunk_cells=3, prefetch=prefetch)
            assert_same_winners(sr, seq.winners)
            assert sr.win_counts == seq.win_counts
            assert sr.best_by_label == seq.best_by_label

    def test_prefetch_one_is_sequential(self):
        self._eval(_sim_space(), chunk_cells=3, prefetch=1)
        info = flitsim.last_run_info()["stream.sim"]
        assert info["mode"] == "stream" and info["prefetch"] == 1
        assert info["overlap_frac"] == 0.0

    def test_stream_telemetry_contents(self):
        sr = self._eval(_sim_space(), chunk_cells=3, prefetch=2)
        info = flitsim.last_run_info()["stream.sim"]
        assert info["dispatches"] == sr.n_dispatches == 7
        assert info["prefetch"] == 2
        assert info["pad_cells"] == 7 * 3 - 20 and info["cells"] == 20
        assert 0.0 <= info["overlap_frac"] <= 1.0
        assert info["elapsed_s"] > 0.0
        assert 0.0 <= info["marshal_s"] <= info["elapsed_s"]

    def test_single_chunk_smaller_than_space(self, sim_materialized):
        port, ref = sim_materialized
        sr = self._eval(_sim_space(), chunk_cells=10 ** 6, prefetch=4)
        assert sr.n_dispatches == 1
        assert_same_winners(sr, port["sim_efficiency"].argbest("protocol"))
        assert_same_winners(sr, ref["sim_efficiency"].argbest("protocol"))

    @pytest.mark.parametrize("chunk", [1, 3, 7, 19])
    def test_non_divisor_tails_under_prefetch(self, sim_materialized,
                                              chunk):
        port, ref = sim_materialized
        sr = self._eval(_sim_space(), chunk_cells=chunk, prefetch=3)
        assert_same_winners(sr, port["sim_efficiency"].argbest("protocol"))
        assert_same_winners(sr, ref["sim_efficiency"].argbest("protocol"))

    def test_catalog_engine_prefetch_bit_identical(self):
        space = _cat_space(9)
        seq = space.evaluate(metrics=("bandwidth_gbs",),
                             stream=StreamConfig(chunk_cells=4, prefetch=1))
        for prefetch in (2, 5):
            sr = space.evaluate(metrics=("bandwidth_gbs",),
                                stream=StreamConfig(chunk_cells=4,
                                                    prefetch=prefetch))
            assert_same_winners(sr, seq.winners)
            assert sr.win_counts == seq.win_counts
            assert sr.best_by_label == seq.best_by_label
        info = flitsim.last_run_info()["stream.catalog"]
        assert info["mode"] == "stream" and info["prefetch"] == 5

    def test_prefetch_validated(self):
        with pytest.raises(ValueError, match="prefetch"):
            StreamConfig(prefetch=0)

    def test_prefetch_participates_in_stream_key(self):
        assert StreamConfig(prefetch=1).key() != \
            StreamConfig(prefetch=2).key()
        # the constraints slot stays LAST (the reference's catalog engine
        # keys on it)
        assert StreamConfig(prefetch=2).key()[-1] == \
            StreamConfig(chunk_cells=4, prefetch=3).key()[-1]
        assert StreamConfig(prefetch=2).key() == \
            j_space.StreamConfig(prefetch=2).key()


def test_frontier_section_materialized_vs_streaming():
    space = DesignSpace(_cat_axes(t_space)[:1]
                        + [axis("shoreline_mm", [4.0, 8.0])], device=CPU)
    rep = space.report(ReportSpec(sections=("frontier",)))
    pay = rep["frontier"].payload
    assert pay["engine"] == "materialized"
    ref = space.evaluate(metrics=("bandwidth_gbs",)).frontier("bandwidth_gbs")
    assert pay["winners"] == np.asarray(ref.values, dtype=object).tolist()
    srep = space.report(ReportSpec(sections=("frontier",), options={
        "frontier": {"stream": StreamConfig(chunk_cells=4)}}))
    spay = srep["frontier"].payload
    assert spay["engine"] == "streaming"
    assert spay["winners"] == pay["winners"]
    assert spay["peak_cells_per_chunk"] == 4
    # the reference's streamed payload, key for key (compiles and devices
    # apart: the port compiles nothing per chunk shape)
    from repro.core.report import ReportSpec as JSpec
    jspace = j_space.DesignSpace(_cat_axes(j_space)[:1]
                                 + [j_space.axis("shoreline_mm", [4.0, 8.0])])
    jpay = jspace.report(JSpec(sections=("frontier",), options={
        "frontier": {"stream": j_space.StreamConfig(chunk_cells=4,
                                                    devices=1)}}))[
        "frontier"].payload
    assert set(spay) == set(jpay)
    assert {k: v for k, v in spay.items() if k != "compiles"} == \
        {k: v for k, v in jpay.items() if k != "compiles"}
