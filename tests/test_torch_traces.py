"""The port's serving-trace subsystem (``repro_torch.traces``, the ``trace``
and ``protocol`` axes, the trace-scan cores and the serving frontier)
against the JAX reference on the CPU, case for case as
``tests/test_traces.py`` holds the reference: trace compilation, arrival
processes, traffic pricing, the synthetic serving replay, the recorder,
the axes, trace-scan numerics (state carry, bit-identity with the static
cell, duration weighting, PHY threading, perturbations), telemetry and
the frontier.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: traces, arrivals and byte prices exactly equal (both are the
same numpy arithmetic); per-phase and aggregate efficiencies atol 1e-6,
the fixed engine's tolerance (``tests/test_flitsim_sweep.py``); winner
labels exactly equal.  A single-phase trace is held bitwise against the
port's own static cell."""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import re

import numpy as np
import pytest
import torch

from repro import traces as jt
from repro.core import flitsim as j_flitsim
from repro.core import space as j_space
from repro_torch import traces as tt
from repro_torch.core import flitsim
from repro_torch.core.space import (AXIS_ORDER, FIXED_SIM, AxisSet,
                                    DesignSpace, SimConfig, axis)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
ATOL = 1e-6
#: small horizons keep every trace-scan test short
FAST = dict(n_flits=128, n_accesses=128)
FAST_TRACE = SimConfig(trace_cycles=128)
J_FAST_TRACE = j_space.SimConfig(trace_cycles=128)


def _space(axes, **kw):
    return DesignSpace(axes, device=CPU, **kw)


def _random_traces(mod, seed, n=5, max_phases=4):
    """``n`` traces of 1..max_phases phases from one seed, in ``mod``'s
    TrafficTrace type."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, max_phases + 1))
        out.append(mod.TrafficTrace(
            f"t{i}", tuple(rng.uniform(0.1, 3.0, k)),
            tuple(rng.uniform(0.0, 1.0, k)),
            tuple(rng.uniform(1.0, 64.0, k))))
    return out


def _fields(t):
    return (t.name, t.durations, t.read_fractions, t.backlogs)


class TestTrafficTrace:
    def test_phase_validation(self):
        for mod in (tt, jt):
            with pytest.raises(ValueError, match="length"):
                mod.TrafficTrace("t", (1.0, 1.0), (0.5,), (4.0, 4.0))
            with pytest.raises(ValueError, match="positive sum"):
                mod.TrafficTrace("t", (0.0,), (0.5,), (4.0,))
            with pytest.raises(ValueError, match=r"outside \[0, 1\]"):
                mod.TrafficTrace("t", (1.0,), (1.5,), (4.0,))
            with pytest.raises(ValueError, match="backlog"):
                mod.TrafficTrace("t", (1.0,), (0.5,), (0.0,))

    def test_padded_preserves_aggregate_weighting(self):
        t = tt.TrafficTrace("t", (3.0, 1.0), (0.8, 0.2), (4.0, 32.0))
        p = t.padded(5)
        assert p.n_phases == 5
        assert p.durations == (3.0, 1.0, 0.0, 0.0, 0.0)
        assert p.read_fractions[2:] == (0.2,) * 3
        assert t.padded(2) is t
        with pytest.raises(ValueError, match="cannot pad"):
            t.padded(1)
        j = jt.TrafficTrace("t", (3.0, 1.0), (0.8, 0.2), (4.0, 32.0))
        assert _fields(p) == _fields(j.padded(5))

    def test_from_ticks_compiles_byte_weighted_phases(self):
        kw = dict(read_bytes=[10, 10, 0, 0], write_bytes=[0, 0, 10, 10],
                  backlogs=[2, 4, 6, 8], n_phases=2)
        tr = tt.TrafficTrace.from_ticks("t", **kw)
        assert tr.durations == (2.0, 2.0)
        assert tr.read_fractions == (1.0, 0.0)
        assert tr.backlogs == (3.0, 7.0)
        assert _fields(tr) == _fields(jt.TrafficTrace.from_ticks("t", **kw))

    @pytest.mark.parametrize("n_phases", [1, 3, 8, 50])
    def test_from_ticks_equals_reference(self, n_phases):
        rng = np.random.default_rng(n_phases)
        r, w = rng.uniform(0, 1e9, 40), rng.uniform(0, 1e8, 40)
        r[5:9] = w[5:9] = 0.0                    # an idle stretch
        b = rng.uniform(0, 20, 40)
        got = tt.TrafficTrace.from_ticks("x", r, w, b, n_phases=n_phases)
        want = jt.TrafficTrace.from_ticks("x", r, w, b, n_phases=n_phases)
        assert _fields(got) == _fields(want)

    def test_from_ticks_idle_segment_inherits_global_share(self):
        tr = tt.TrafficTrace.from_ticks(
            "t", read_bytes=[30, 0], write_bytes=[10, 0],
            backlogs=[4, 0], n_phases=2)
        assert tr.read_fractions[1] == pytest.approx(0.75)
        assert tr.backlogs[1] == tt.MIN_BACKLOG == jt.MIN_BACKLOG
        with pytest.raises(ValueError, match="no bytes"):
            tt.TrafficTrace.from_ticks("t", [0.0], [0.0], [1.0])

    def test_pad_traces_to_common_phase_count(self):
        a = tt.TrafficTrace.steady("a", 0.5, 4.0)
        b = tt.TrafficTrace("b", (1.0, 1.0, 1.0), (0.9, 0.5, 0.1),
                            (2.0, 8.0, 32.0))
        pa, pb = tt.pad_traces([a, b])
        assert pa.n_phases == pb.n_phases == 3
        assert pb is b
        with pytest.raises(ValueError, match="at least one"):
            tt.pad_traces([])

    def test_trace_is_a_plain_frozen_dataclass(self):
        """The reference registers a JAX pytree; the port keeps a plain
        frozen dataclass of the same fields."""
        t = tt.TrafficTrace("t", (1.0, 2.0), (0.5, 0.25), (4.0, 8.0))
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(jt.TrafficTrace)]
        with pytest.raises(dataclasses.FrozenInstanceError):
            t.name = "u"
        assert t == tt.TrafficTrace("t", [1, 2], [0.5, 0.25], [4, 8])


class TestArrivals:
    @pytest.mark.parametrize("name", ["poisson_arrivals",
                                      "diurnal_arrivals",
                                      "bursty_arrivals"])
    def test_processes_equal_reference_and_deterministic(self, name):
        fn, ref = getattr(tt, name), getattr(jt, name)
        for seed in (0, 3, 4):
            a = fn(2.0, 64, seed=seed)
            assert a.shape == (64,) and a.dtype == np.int64
            assert np.array_equal(a, ref(2.0, 64, seed=seed))
            assert np.array_equal(a, fn(2.0, 64, seed=seed))
        assert not np.array_equal(fn(2.0, 64, seed=3), fn(2.0, 64, seed=4))

    def test_rates_track_the_mean(self):
        n = 20_000
        for fn in (tt.poisson_arrivals, tt.diurnal_arrivals):
            assert fn(3.0, n, seed=0).mean() == pytest.approx(3.0,
                                                              rel=0.1)

    def test_bursty_is_overdispersed(self):
        a = tt.bursty_arrivals(2.0, 20_000, seed=0)
        p = tt.poisson_arrivals(a.mean(), 20_000, seed=0)
        assert a.var() > 2.0 * p.var()

    def test_rate_profile_and_users_equal_reference(self):
        assert np.array_equal(tt.diurnal_rate(1.5, 100, 3.0, 40),
                              jt.diurnal_rate(1.5, 100, 3.0, 40))
        assert tt.rate_from_users(2e6, 1e-6) == jt.rate_from_users(2e6,
                                                                   1e-6)
        for mod in (tt, jt):
            with pytest.raises(ValueError):
                mod.rate_from_users(-1, 1.0)
            with pytest.raises(ValueError, match="peak_ratio"):
                mod.diurnal_rate(1.0, 10, peak_ratio=0.5)
            with pytest.raises(ValueError, match="burst_factor"):
                mod.bursty_arrivals(1.0, 10, burst_factor=0.5)


ARCHS = ("smollm-360m", "olmoe-1b-7b", "mamba2-2.7b", "recurrentgemma-2b",
         "starcoder2-15b", "qwen1.5-110b", "mistral-large-123b",
         "llama4-scout-17b-a16e", "internvl2-1b", "seamless-m4t-large-v2")


class TestModelTraffic:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_spec_and_bytes_equal_reference(self, arch):
        got = tt.ModelTrafficSpec.from_name(arch)
        want = jt.ModelTrafficSpec.from_name(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for n in (0, 1, 128, 4096):
            assert got.decode_bytes(n) == want.decode_bytes(n)
            assert got.prefill_bytes(n) == want.prefill_bytes(n)

    def test_decode_is_read_heavy_and_context_dependent(self):
        spec = tt.ModelTrafficSpec.from_name("smollm-360m")
        r1, w1 = spec.decode_bytes(128)
        r2, w2 = spec.decode_bytes(1024)
        assert r2 > r1 and w2 == w1 and r1 > w1

    def test_prefill_is_write_balanced(self):
        r, w = tt.ModelTrafficSpec.from_name("smollm-360m").prefill_bytes(
            256)
        assert r == w > 0

    def test_moe_and_ssm_specs_diverge(self):
        moe = tt.ModelTrafficSpec.from_name("olmoe-1b-7b")
        ssm = tt.ModelTrafficSpec.from_name("mamba2-2.7b")
        assert moe.moe_shuffle_bytes_per_token > 0
        assert ssm.moe_shuffle_bytes_per_token == 0
        assert ssm.state_bytes_per_token > 0
        assert ssm.decode_bytes(64)[0] == ssm.decode_bytes(4096)[0]


class TestSyntheticTrace:
    @pytest.mark.parametrize("model,qps,arrival", [
        ("smollm-360m", 0.05, "diurnal"), ("olmoe-1b-7b", 1.0, "poisson"),
        ("mamba2-2.7b", 4.0, "bursty"), ("smollm-360m", 8.0, "diurnal")])
    def test_equal_reference_phase_for_phase(self, model, qps, arrival):
        kw = dict(qps=qps, n_ticks=128, n_phases=5, batch_slots=8,
                  arrival=arrival, seed=7)
        got = tt.synthetic_serving_trace(tt.ModelTrafficSpec.from_name(
            model), **kw)
        want = jt.synthetic_serving_trace(jt.ModelTrafficSpec.from_name(
            model), **kw)
        assert _fields(got) == _fields(want)

    def test_backlog_grows_with_qps(self):
        spec = tt.ModelTrafficSpec.from_name("smollm-360m")
        lo = tt.synthetic_serving_trace(spec, qps=0.1, n_ticks=128,
                                        batch_slots=4)
        hi = tt.synthetic_serving_trace(spec, qps=8.0, n_ticks=128,
                                        batch_slots=4)
        assert max(hi.backlogs) > 4.0 * max(lo.backlogs)

    def test_arrival_and_qps_validation(self):
        spec = tt.ModelTrafficSpec.from_name("smollm-360m")
        with pytest.raises(ValueError, match="arrival"):
            tt.synthetic_serving_trace(spec, qps=1.0, arrival="nope")
        with pytest.raises(ValueError, match="qps"):
            tt.synthetic_serving_trace(spec, qps=-1.0)

    def test_deterministic_and_named(self):
        spec = tt.ModelTrafficSpec.from_name("smollm-360m")
        a = tt.synthetic_serving_trace(spec, qps=1.0, n_ticks=64, seed=5)
        b = tt.synthetic_serving_trace(spec, qps=1.0, n_ticks=64, seed=5)
        assert a == b
        assert a.name == "smollm-360m@qps1-diurnal"


class TestTraceAxis:
    def test_axis_order_and_normalization(self):
        assert "trace" in AXIS_ORDER and "protocol" in AXIS_ORDER
        assert axis("protocol", ["chi"]).values == ("chi",)   # it builds
        assert AXIS_ORDER == j_space.AXIS_ORDER
        ax = axis("trace", [tt.TrafficTrace.steady("a", 0.5, 4.0),
                            tt.TrafficTrace("b", (1.0, 1.0), (0.9, 0.1),
                                            (2.0, 32.0))])
        assert ax.labels == ("a", "b")
        assert all(t.n_phases == 2 for t in ax.values)
        assert ax.labels.index("b") == 1
        p = axis("protocol", ["chi", "hbm_asym"])
        assert p.values == p.labels == ("chi", "hbm_asym")

    def test_axis_rejects_non_traces_and_duplicates(self):
        with pytest.raises(ValueError, match="TrafficTrace"):
            axis("trace", [0.5])
        with pytest.raises(ValueError, match="TrafficTrace"):
            axis("trace", [jt.TrafficTrace.steady("a", 0.5, 4.0)])
        t = tt.TrafficTrace.steady("a", 0.5, 4.0)
        with pytest.raises(ValueError, match="duplicate"):
            axis("trace", [t, tt.TrafficTrace.steady("a", 0.9, 8.0)])

    def test_trace_excludes_mix_backlog_and_workload_axes(self):
        t = axis("trace", [tt.TrafficTrace.steady("a", 0.5, 4.0)])
        for other in (axis("backlog", [4.0]),
                      axis("read_fraction", [0.5]),
                      axis("mix", [(2, 1)]),
                      axis("workload_config", [("w", (2, 1))])):
            with pytest.raises(ValueError, match="exclusive"):
                AxisSet([t, other])
        names = AxisSet([axis("protocol", ["chi"]), t]).names
        assert names == ("protocol", "trace")

    def test_unknown_protocol_refused(self):
        with pytest.raises(ValueError, match="unknown protocol"):
            _space([axis("protocol", ["nope"]),
                    axis("trace", [tt.TrafficTrace.steady("a", 0.5,
                                                          4.0)])],
                   **FAST).evaluate()

    def test_sim_config_trace_cycles_key(self):
        assert FIXED_SIM.key() == ("fixed",) == j_space.FIXED_SIM.key()
        assert SimConfig(trace_cycles=128).key() == ("fixed", 128)
        adaptive = SimConfig(mode="adaptive", trace_cycles=128).key()
        assert adaptive[0] == "adaptive" and adaptive[-1] == 128
        assert SimConfig(mode="adaptive").key()[-1] is None
        with pytest.raises(ValueError, match="trace_cycles"):
            SimConfig(trace_cycles=4)


class TestTraceScanNumerics:
    @pytest.mark.parametrize("rf,backlog", [(0.7, 16.0), (0.0, 2.0),
                                            (1.0, 64.0), (0.35, 1.0)])
    def test_single_phase_bitwise_equal_to_static_cell(self, rf, backlog):
        """A steady trace IS the static cell: same step, same cycle count,
        same warm-up — bitwise, for every protocol family; and within
        1e-6 of the reference's."""
        got = _space([axis("trace", [tt.TrafficTrace.steady(
            "s", rf, backlog)])], **FAST).evaluate(
            metrics=("trace_efficiency",))["trace_efficiency"].values[:, 0]
        static = _space([axis("read_fraction", [rf]),
                         axis("backlog", [backlog])], **FAST).evaluate(
            metrics=("sim_efficiency",))["sim_efficiency"].values[:, 0, 0]
        assert np.array_equal(got, static)
        want = j_space.DesignSpace(
            [j_space.axis("trace", [jt.TrafficTrace.steady(
                "s", rf, backlog)])], **FAST).evaluate(
            metrics=("trace_efficiency",))["trace_efficiency"].values[:, 0]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=ATOL)

    def test_state_carries_across_phase_boundaries(self):
        burst = tt.TrafficTrace("burst", (1.0, 1.0), (0.1, 0.9),
                                (64.0, 2.0))
        cold = tt.TrafficTrace.steady("cold", 0.9, 2.0)
        res = _space([axis("trace", [burst, cold])], sim=FAST_TRACE,
                     **FAST).evaluate(metrics=("trace_phase_efficiency",))
        phase = res["trace_phase_efficiency"]
        assert phase.dims == ("protocol", "trace", "phase")
        carried = phase.values[:, 0, 1]     # burst trace, phase 2
        fresh = phase.values[:, 1, 0]       # cold steady state
        sym = [i for i, k in enumerate(phase.coord("protocol"))
               if k in flitsim.SYMMETRIC_PARAMS]
        assert not np.allclose(carried[sym], fresh[sym])

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_phase_efficiencies_equal_reference(self, seed):
        got = _space([axis("trace", _random_traces(tt, seed))],
                     sim=FAST_TRACE, n_flits=2048, n_accesses=4096).evaluate(
            metrics=("trace_efficiency", "trace_phase_efficiency"))
        want = j_space.DesignSpace(
            [j_space.axis("trace", _random_traces(jt, seed))],
            sim=J_FAST_TRACE, n_flits=2048, n_accesses=4096).evaluate(
            metrics=("trace_efficiency", "trace_phase_efficiency"))
        for m in ("trace_efficiency", "trace_phase_efficiency"):
            assert got[m].dims == want[m].dims
            assert got[m].coords == want[m].coords
            np.testing.assert_allclose(got[m].values,
                                       np.asarray(want[m].values), rtol=0,
                                       atol=ATOL, err_msg=m)

    def test_duration_weighting(self):
        t = tt.TrafficTrace("t", (3.0, 1.0), (0.9, 0.2), (4.0, 32.0))
        res = _space([axis("trace", [t])], sim=FAST_TRACE,
                     **FAST).evaluate(
            metrics=("trace_efficiency", "trace_phase_efficiency"))
        per = res["trace_phase_efficiency"].values[:, 0].astype(np.float64)
        agg = res["trace_efficiency"].values[:, 0]
        np.testing.assert_allclose(agg, (0.75 * per[:, 0]
                                         + 0.25 * per[:, 1]).astype(
                                             np.float32), rtol=1e-6)

    def test_trace_bandwidth_threads_the_phy(self):
        from repro.core import UCIE_A_32G_55U as J_PHY
        from repro_torch.core.ucie import UCIE_A_32G_55U, UCIE_S_32G
        t = tt.TrafficTrace.steady("s", 0.7, 16.0)
        res = _space([axis("trace", [t])], phy=UCIE_A_32G_55U,
                     sim=FAST_TRACE, **FAST).evaluate()
        assert set(res.metrics) == {"trace_efficiency",
                                    "trace_phase_efficiency",
                                    "trace_bandwidth_gbs"}
        bw, eff = res["trace_bandwidth_gbs"], res["trace_efficiency"]
        np.testing.assert_allclose(
            bw.values, eff.values * UCIE_A_32G_55U.raw_bandwidth_gbs,
            rtol=1e-6)
        want = j_space.DesignSpace(
            [j_space.axis("trace", [jt.TrafficTrace.steady("s", 0.7,
                                                           16.0)])],
            phy=J_PHY, sim=J_FAST_TRACE, **FAST).evaluate()
        np.testing.assert_allclose(
            bw.values, np.asarray(want["trace_bandwidth_gbs"].values),
            rtol=1e-6)
        with pytest.raises(ValueError, match="phy"):
            _space([axis("trace", [t])], **FAST).evaluate(
                metrics=("trace_bandwidth_gbs",))
        stacked = _space([axis("phy", [UCIE_S_32G, UCIE_A_32G_55U]),
                          axis("trace", [t])], sim=FAST_TRACE,
                         **FAST).evaluate(metrics=("trace_bandwidth_gbs",))
        sb = stacked["trace_bandwidth_gbs"]
        assert sb.dims == ("protocol", "phy", "trace")
        np.testing.assert_array_equal(sb.values[:, 1], bw.values)

    def test_protocol_axis_selects_and_orders(self):
        t = tt.TrafficTrace.steady("s", 0.6, 8.0)
        sub = _space([axis("protocol", ["hbm_asym", "chi"]),
                      axis("trace", [t])], sim=FAST_TRACE, **FAST).evaluate(
            metrics=("trace_efficiency",))["trace_efficiency"]
        full = _space([axis("trace", [t])], sim=FAST_TRACE,
                      **FAST).evaluate(
            metrics=("trace_efficiency",))["trace_efficiency"]
        assert sub.coord("protocol") == ("hbm_asym", "chi")
        keys = list(full.coord("protocol"))
        np.testing.assert_array_equal(
            sub.values, full.values[[keys.index("hbm_asym"),
                                     keys.index("chi")]])

    def test_perturbations_through_simulate_trace_grid(self):
        rng = np.random.default_rng(5)
        xs = rng.uniform(0, 100, (3, 2)).astype(np.float32)
        bls = rng.uniform(1, 32, (3, 2)).astype(np.float32)
        perts = [{}, {"flit_bits": 2.0}, {"read_lanes": 0.5}]
        kw = dict(perturbations=perts, n_flits=256, n_accesses=256)
        keys = ("cxl_opt", "chi", "lpddr6_asym")
        got = flitsim.simulate_trace_grid(keys, xs, 100.0 - xs, bls,
                                          device=CPU, **kw).numpy()
        want = np.asarray(j_flitsim.simulate_trace_grid(
            keys, xs, 100.0 - xs, bls, **kw))
        assert got.shape == (3, 3, 3, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert not np.allclose(got[0], got[1])
        with pytest.raises(ValueError, match="applies to no parameter"):
            flitsim.simulate_trace_grid(["chi"], xs, xs, bls, device=CPU,
                                        perturbations=[{"read_lanes": 2}])
        with pytest.raises(ValueError, match=r"\[T, N\]"):
            flitsim.simulate_trace_grid(["chi"], xs, xs, bls[:, :1],
                                        device=CPU)


class TestTelemetry:
    def test_telemetry_reports_trace_mode(self):
        t = tt.TrafficTrace("t", (1.0, 1.0, 1.0), (0.9, 0.5, 0.1),
                            (2.0, 8.0, 32.0))
        _space([axis("trace", [t])], sim=FAST_TRACE, **FAST).evaluate(
            metrics=("trace_efficiency",))
        info = flitsim.last_run_info()
        j_space.DesignSpace([j_space.axis("trace", [jt.TrafficTrace(
            "t", (1.0, 1.0, 1.0), (0.9, 0.5, 0.1), (2.0, 8.0, 32.0))])],
            sim=J_FAST_TRACE, **FAST).evaluate(
            metrics=("trace_efficiency",))
        j_info = j_flitsim.last_run_info()
        for fam in ("flitsim.symmetric.trace", "flitsim.asymmetric.trace"):
            d = info[fam]
            assert d["mode"] == "trace" and d["engine"] == "plain"
            assert d["phases"] == 3
            assert d["cycles_per_phase"] == 128
            assert d["cycles_run"] == 384
            assert d["state_carry_depth"] == 256
            assert d["trace_cells"] > 0 and d["elapsed_s"] > 0
            same = {k for k in j_info[fam] if k != "engine"}
            assert {k: d[k] for k in same} == \
                {k: j_info[fam][k] for k in same}


class TestServingFrontier:
    def test_frontier_report_shape_and_vocabulary(self):
        from repro_torch.core.selector import SIM_APPROACH_KEYS
        kw = dict(models=("smollm-360m", "mamba2-2.7b"),
                  qps_points=(0.25, 4.0), n_ticks=96, n_phases=4)
        rep = tt.serving_frontier(sim=SimConfig(trace_cycles=256),
                                  device=CPU, **kw)
        assert rep["models"] == ["smollm-360m", "mamba2-2.7b"]
        labels = set(SIM_APPROACH_KEYS.values())
        for m in rep["models"]:
            assert set(rep["winner_by_model_qps"][m]) == {"0.25", "4"}
            assert set(rep["winner_by_model_qps"][m].values()) <= labels
            for v in rep["winner_gbs_by_model_qps"][m].values():
                assert v > 0.0
        assert set(rep["telemetry"]) == {"flitsim.symmetric.trace",
                                         "flitsim.asymmetric.trace"}
        assert rep["launches"] == {"symmetric_trace": 0,
                                   "asymmetric_trace": 0}
        want = jt.serving_frontier(sim=j_space.SimConfig(trace_cycles=256),
                                   **kw)
        for key in ("winner_by_model_qps", "protocol_by_model_qps",
                    "qps_sensitive", "traces", "trace_names", "protocols",
                    "n_phases", "phy"):
            assert rep[key] == want[key], key

    def test_design_space_entry_point(self):
        rep = DesignSpace.serving_frontier(
            models=("smollm-360m",), qps_points=(1.0,), n_ticks=48,
            n_phases=3, sim=SimConfig(trace_cycles=128), device=CPU)
        assert rep["trace_names"] == ["smollm-360m@q1"]
        assert rep["n_phases"] == 3

    def test_protocol_subset(self):
        rep = tt.serving_frontier(
            models=("olmoe-1b-7b",), qps_points=(0.05, 4.0), n_ticks=64,
            protocols=("cxl_opt", "hbm_asym"),
            sim=SimConfig(trace_cycles=128), device=CPU)
        assert rep["protocols"] == ["cxl_opt", "hbm_asym"]
        assert set(rep["protocol_by_model_qps"]["olmoe-1b-7b"].values()) \
            <= {"cxl_opt", "hbm_asym"}

    def test_default_frontier_equals_reference(self):
        """The golden's section at full size: winners exactly equal, the
        winners' delivered GB/s within 1e-6 relative."""
        got = tt.serving_frontier(device=CPU)
        want = jt.serving_frontier()
        for key in ("winner_by_model_qps", "protocol_by_model_qps",
                    "qps_sensitive", "traces", "models", "qps_points"):
            assert got[key] == want[key], key
        for m in got["models"]:
            for q, v in got["winner_gbs_by_model_qps"][m].items():
                assert v == pytest.approx(
                    want["winner_gbs_by_model_qps"][m][q], rel=1e-6)


def _frontier_lines(text):
    """The winner lines and trace lines ``--serving`` prints."""
    return [ln for ln in text.splitlines()
            if re.match(r"    \S+ +qps=", ln)
            or re.match(r"    \S+@q\S+ +read fraction ", ln)]


def test_serving_mode_prints_the_reference_lines(capsys):
    """``python -m repro_torch.explorer --serving --device cpu`` prints the
    winner and trace lines of the reference's
    ``examples/memsys_explorer.py --serving``."""
    spec = importlib.util.spec_from_file_location(
        "memsys_explorer", ROOT / "examples" / "memsys_explorer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        mod.serving_mode()
    from repro_torch import explorer
    explorer.main(["--serving", "--device", CPU])
    got = capsys.readouterr().out
    lines = _frontier_lines(got)
    assert lines == _frontier_lines(want.getvalue())
    assert len(lines) == 3 + 9
    assert "kernel launches" in got


class TestTraceRecorder:
    def _feed(self, rec):
        rng = np.random.default_rng(9)
        for _ in range(30):
            for n in rng.integers(0, 3) * [int(rng.integers(3, 300))]:
                rec.on_prefill(n)
            ctx = [int(c) for c in rng.integers(1, 2000,
                                                int(rng.integers(0, 5)))]
            rec.on_decode(ctx)
            rec.on_tick(int(rng.integers(0, 9)), len(ctx))
        return rec

    def test_recorder_prices_ticks(self):
        spec = tt.ModelTrafficSpec.from_name("smollm-360m")
        rec = tt.TraceRecorder(spec)
        rec.on_prefill(8)
        rec.on_decode([8, 4])
        rec.on_tick(queue_depth=3, active=2)
        rec.on_decode([9, 5])
        rec.on_tick(queue_depth=0, active=2)
        assert rec.n_ticks == 2
        assert rec.prefill_tokens_per_tick == [8, 0]
        assert rec.decode_tokens_per_tick == [2, 2]
        tr = rec.trace(n_phases=2, name="r")
        assert tr.n_phases == 2
        assert tr.backlogs == (5.0, 2.0)
        with pytest.raises(ValueError, match="no ticks"):
            tt.TraceRecorder(spec).trace()

    @pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b",
                                      "mamba2-2.7b"])
    def test_same_hook_calls_give_reference_trace(self, arch):
        from repro.configs import get as j_get
        from repro_torch.configs import get
        got = self._feed(tt.TraceRecorder.for_model(get(arch)))
        want = self._feed(jt.TraceRecorder.for_model(j_get(arch)))
        assert got.prefill_tokens_per_tick == want.prefill_tokens_per_tick
        assert got.decode_tokens_per_tick == want.decode_tokens_per_tick
        assert _fields(got.trace(n_phases=6)) == \
            _fields(want.trace(n_phases=6))

    def test_recorded_olmoe_engine_run_equals_reference(self):
        """A port engine run of reduced olmoe-1b-7b (moe, 2 slots: R5) and
        the reference's engine on the same requests, each feeding its
        package's ``TraceRecorder``: the same per-tick token counts and
        the same compiled trace (the hooks see token counts and contexts,
        so the engines' logits do not enter)."""
        import jax
        from repro.configs import get as j_get
        from repro.models import ShardingCtx
        from repro.models import build as j_build
        from repro.serve import Request as JRequest
        from repro.serve import ServingEngine as JEngine
        from repro_torch import convert
        from repro_torch.configs import get
        from repro_torch.models import build
        from repro_torch.serve import Request, ServingEngine
        cfg = get("olmoe-1b-7b").reduced()
        j_model = j_build(j_get("olmoe-1b-7b").reduced())
        j_params = j_model.init(jax.random.PRNGKey(0))
        params = convert.model_params(cfg, jax.tree.map(np.asarray, j_params),
                                      device=CPU)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (4, 9, 20, 6, 13)]
        recs = []
        for rec, eng, req in (
                (tt.TraceRecorder.for_model(cfg),
                 lambda r: ServingEngine(build(cfg), params, batch_slots=2,
                                         max_len=48, recorder=r, device=CPU),
                 Request),
                (jt.TraceRecorder.for_model(j_get("olmoe-1b-7b").reduced()),
                 lambda r: JEngine(j_model, j_params, ShardingCtx(),
                                   batch_slots=2, max_len=48, recorder=r),
                 JRequest)):
            e = eng(rec)
            for i, p in enumerate(prompts):
                e.submit(req(rid=i, prompt=p, max_new_tokens=5))
            e.run_until_drained()
            recs.append(rec)
        got, want = recs
        assert got.n_ticks == want.n_ticks > 0
        assert got.prefill_tokens_per_tick == want.prefill_tokens_per_tick
        assert got.decode_tokens_per_tick == want.decode_tokens_per_tick
        assert sum(got.prefill_tokens_per_tick) == 4 + 9 + 20 + 6 + 13
        assert _fields(got.trace(n_phases=4)) == \
            _fields(want.trace(n_phases=4))

    def test_recorded_engine_run_compiles_to_a_trace(self):
        """End to end: a port ServingEngine run (reduced smollm-360m, two
        slots: the reference's engine needs two, R5) through the recorder
        yields a trace the design space evaluates."""
        from repro_torch.configs import get
        from repro_torch.models import build
        from repro_torch.serve import Request, ServingEngine
        cfg = get("smollm-360m").reduced()
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        rec = tt.TraceRecorder.for_model(cfg)
        eng = ServingEngine(model, params, batch_slots=2, max_len=32,
                            recorder=rec, device=CPU)
        for i in range(4):
            eng.submit(Request(rid=i, prompt=np.arange(3 + i) % 50,
                               max_new_tokens=4))
        eng.run_until_drained()
        assert rec.n_ticks > 0
        assert sum(rec.prefill_tokens_per_tick) == 3 + 4 + 5 + 6
        assert sum(rec.decode_tokens_per_tick) > 0
        tr = rec.trace(n_phases=4)
        res = _space([axis("trace", [tr])], sim=FAST_TRACE,
                     **FAST).evaluate(metrics=("trace_efficiency",))
        assert np.all(res["trace_efficiency"].values > 0.0)
