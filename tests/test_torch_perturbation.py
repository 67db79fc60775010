"""The perturbation axes of the port (``catalog_param``, ``protocol_param``)
and ``flitsim.sweep_perturbed`` against the JAX reference on the CPU, at
the reference's tolerances: closed forms rel 1e-6, fixed-engine
efficiencies atol 1e-6, adaptive within 1e-3 of fixed, labels, dims and
coords exactly equal.  Mirrors ``tests/test_phy_axis.py::TestCatalogParam``,
``tests/test_design_space.py::TestPerturbations`` and
``tests/test_adaptive_sim.py::test_perturbations_adaptive``."""
import numpy as np
import pytest

from repro.core import flitsim as j_flitsim
from repro.core import space as j_space
from repro.core import ucie as j_ucie
from repro_torch.core import flitsim
from repro_torch.core import space as t_space
from repro_torch.core import ucie as t_ucie
from repro_torch.core.space import ADAPTIVE_SIM, DesignSpace, axis

CPU = "cpu"
RTOL = 1e-6
ATOL = 1e-6
#: a short fixed horizon where the reference runs many shapes
FAST = dict(n_flits=96, n_accesses=96)


def _both(axes_fn, **kw):
    j = j_space.DesignSpace(axes_fn(j_space, j_ucie), **kw)
    t = t_space.DesignSpace(axes_fn(t_space, t_ucie), device=CPU, **kw)
    return j, t


def _same_layout(got, want):
    assert got.dims == want.dims
    assert got.coords == want.coords


# -- catalog_param (tests/test_phy_axis.py::TestCatalogParam) ----------------


class TestCatalogParam:
    def test_baseline_row_identical_to_unperturbed(self):
        res = DesignSpace([
            axis("catalog_param", [{}, {"power_pj_per_bit": 2.0}]),
            axis("read_fraction", [0.25, 0.75]),
        ], device=CPU).evaluate(metrics=("bandwidth_gbs", "pj_per_bit"))
        plain = DesignSpace([axis("read_fraction", [0.25, 0.75])],
                            device=CPU).evaluate(metrics=("bandwidth_gbs",))
        assert res["bandwidth_gbs"].dims == (
            "catalog_param", "system", "read_fraction")
        assert res["bandwidth_gbs"].coord("catalog_param")[0] == "baseline"
        np.testing.assert_array_equal(
            res["bandwidth_gbs"].sel(catalog_param="baseline").values,
            plain["bandwidth_gbs"].values)

    def test_perturbations_bind_ucie_only(self):
        """Scaling PHY pJ/b or shoreline density perturbs every UCIe system
        and leaves the (phy-less) bus baselines untouched."""
        res = DesignSpace([
            axis("catalog_param", [{}, {"power_pj_per_bit": 2.0},
                                   {"linear_density_gbs_mm": 0.5}]),
            axis("read_fraction", [0.5]),
        ], device=CPU).evaluate(metrics=("bandwidth_gbs", "pj_per_bit"))
        keys = res["bandwidth_gbs"].coord("system")
        pj = res["pj_per_bit"].values
        bw = res["bandwidth_gbs"].values
        for s, key in enumerate(keys):
            if "/" in key:          # UCIe-attached
                assert pj[1, s, 0] == pytest.approx(2.0 * pj[0, s, 0]), key
                assert bw[2, s, 0] == pytest.approx(0.5 * bw[0, s, 0]), key
            else:                   # bus baseline: no PHY to perturb
                assert pj[1, s, 0] == pj[0, s, 0], key
                assert bw[2, s, 0] == bw[0, s, 0], key

    def test_composes_with_phy_axis(self):
        res = DesignSpace([
            axis("catalog_param", [{}, ("half_density",
                                        {"linear_density_gbs_mm": 0.5})]),
            axis("phy", [t_ucie.UCIE_S_32G, t_ucie.UCIE_A_32G_55U]),
            axis("read_fraction", [0.5]),
        ], device=CPU).evaluate(metrics=("bandwidth_gbs",))
        bw = res["bandwidth_gbs"]
        assert bw.dims == ("catalog_param", "system", "phy",
                           "read_fraction")
        assert bw.coord("catalog_param") == ("baseline", "half_density")
        np.testing.assert_allclose(
            bw.sel(catalog_param="half_density").values,
            0.5 * bw.sel(catalog_param="baseline").values, rtol=RTOL)

    def test_unknown_field_rejected_at_axis_build(self):
        with pytest.raises(ValueError, match="unknown catalog perturbation"):
            axis("catalog_param", [{"g_slots": 0.5}])


def _catalog_axes(sp, uc):
    return [sp.axis("catalog_param", [{}, {"power_pj_per_bit": 1.5},
                                      ("dense", {"linear_density_gbs_mm":
                                                 1.25})]),
            sp.axis("read_fraction", [0.0, 0.3, 1.0]),
            sp.axis("shoreline_mm", [4.0, 8.0])]


def _catalog_phy_axes(sp, uc):
    return [sp.axis("catalog_param", [{}, {"areal_density_gbs_mm2": 0.5,
                                           "power_pj_per_bit": 0.8}]),
            sp.axis("phy", [uc.UCIE_S_32G, uc.UCIE_A_48G_45U]),
            sp.axis("read_fraction", [0.2, 0.9]),
            sp.axis("shoreline_mm", [8.0])]


@pytest.mark.parametrize("axes_fn", [_catalog_axes, _catalog_phy_axes],
                         ids=["catalog", "phy-stacked"])
def test_catalog_param_arrays_match_reference(axes_fn):
    """Dims, coords and values of every analytic and approach metric equal
    the reference's (rel 1e-6), frontiers and feasibility exactly."""
    from repro.core.selector import SelectionConstraints as JCons
    from repro_torch.core.selector import SelectionConstraints
    j, t = _both(axes_fn)
    metrics = ("bandwidth_gbs", "pj_per_bit", "power_w", "gbs_per_watt")
    if axes_fn is _catalog_phy_axes:
        metrics += ("linear_density_gbs_mm", "areal_density_gbs_mm2",
                    "approach_pj_per_bit")
    rj, rt = j.evaluate(metrics=metrics), t.evaluate(metrics=metrics)
    for m in metrics:
        _same_layout(rt[m], rj[m])
        np.testing.assert_allclose(rt[m].values, np.asarray(rj[m].values),
                                   rtol=RTOL, err_msg=m)
    assert rt.frontier("bandwidth_gbs").values.tolist() == \
        rj.frontier("bandwidth_gbs").values.tolist()
    cons = dict(packaging="UCIe-S", max_power_w=40.0)
    mt = rt.feasible(SelectionConstraints(**cons))
    mj = rj.feasible(JCons(**cons))
    _same_layout(mt, mj)
    np.testing.assert_array_equal(mt.values, mj.values)
    assert rt.frontier("bandwidth_gbs", where=mt).values.tolist() == \
        rj.frontier("bandwidth_gbs", where=mj).values.tolist()


def test_catalog_param_knee_mask_matches_reference():
    """The backlog-knee budget broadcasts over the catalog_param dim as
    the reference's does."""
    from repro.core.selector import SelectionConstraints as JCons
    from repro_torch.core.selector import SelectionConstraints
    j, t = _both(lambda sp, uc: [
        sp.axis("catalog_param", [{}, {"power_pj_per_bit": 3.0}]),
        sp.axis("mix", [(2, 1), (1, 1)])], n_flits=256)
    rj = j.evaluate(metrics=("bandwidth_gbs",))
    rt = t.evaluate(metrics=("bandwidth_gbs",))
    mt = rt.feasible(SelectionConstraints(max_backlog_knee=8.0))
    mj = rj.feasible(JCons(max_backlog_knee=8.0))
    _same_layout(mt, mj)
    np.testing.assert_array_equal(mt.values, mj.values)


# -- protocol_param (tests/test_design_space.py::TestPerturbations) ----------


class TestPerturbations:
    def test_baseline_row_bit_identical_to_sweep(self):
        res = flitsim.sweep_perturbed(
            [{}, {"g_slots": 0.8}], protocols=("cxl_opt", "hbm_asym"),
            mixes=[(2, 1)], device=CPU)
        legacy = flitsim._sweep_impl(protocols=("cxl_opt", "hbm_asym"),
                                     mixes=[(2, 1)], device=CPU)
        np.testing.assert_array_equal(
            res["sim_efficiency"].sel(protocol_param="baseline").values,
            legacy.efficiency.numpy())

    def test_unknown_field_rejected(self):
        with pytest.raises(ValueError, match="unknown perturbation"):
            flitsim.sweep_perturbed([{"warp_drive": 2.0}], device=CPU)

    def test_inapplicable_perturbation_rejected(self):
        # total_lanes exists only on the asymmetric family: applying it to
        # a symmetric-only sweep would yield a baseline row labeled as
        # perturbed
        with pytest.raises(ValueError, match="applies to no parameter"):
            flitsim.sweep_perturbed([{}, {"total_lanes": 0.5}],
                                    protocols=("cxl_opt",), mixes=[(2, 1)],
                                    device=CPU)

    def test_slot_count_perturbation_binds_symmetric_only(self):
        res = flitsim.sweep_perturbed(
            [{}, {"g_slots": 0.8}], protocols=("cxl_opt", "lpddr6_asym"),
            mixes=[(2, 1)], device=CPU)
        eff = res["sim_efficiency"].values       # [2 pert, 2 proto, 1 mix]
        assert eff[1, 0, 0] < eff[0, 0, 0]       # fewer slots hurt cxl_opt
        assert eff[1, 1, 0] == eff[0, 1, 0]      # asym has no g_slots

    def test_credit_limit_perturbation_binds(self):
        res = flitsim.sweep_perturbed(
            [{}, {"credit_lines": 0.1}], protocols=("cxl_opt",),
            mixes=[(2, 1)], device=CPU)
        eff = res["sim_efficiency"].values
        assert eff[1, 0, 0] < eff[0, 0, 0] - 0.01

    def test_labels(self):
        res = flitsim.sweep_perturbed(
            [{}, ("tight_credit", {"credit_lines": 0.1})],
            protocols=("chi",), mixes=[(1, 1)], device=CPU)
        assert res["sim_efficiency"].coord("protocol_param") == (
            "baseline", "tight_credit")


PERTS = [{}, {"credit_lines": 0.5}, ("slots", {"g_slots": 0.8}),
         {"read_lanes": 0.8, "total_lanes": 1.2}]


@pytest.mark.parametrize("backlogs", [None, 16.0, [2.0, 64.0]],
                         ids=["default", "scalar", "axis"])
def test_sweep_perturbed_matches_reference_fixed(backlogs):
    """``sweep_perturbed`` under the fixed engine: dims and coords equal,
    efficiencies atol 1e-6 (every protocol, every perturbation)."""
    kw = dict(mixes=[(2, 1), (1, 1), (0, 1)], backlogs=backlogs)
    want = j_flitsim.sweep_perturbed(PERTS, **kw)["sim_efficiency"]
    got = flitsim.sweep_perturbed(PERTS, device=CPU, **kw)["sim_efficiency"]
    _same_layout(got, want)
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               rtol=0, atol=ATOL)
    assert got.argbest("protocol").values.tolist() == \
        want.argbest("protocol").values.tolist()


def test_perturbations_adaptive():
    """tests/test_adaptive_sim.py::test_perturbations_adaptive: adaptive
    within 1e-3 of fixed on the perturbation-major stacks."""
    perts = [{}, {"credit_lines": 0.5}, {"g_slots": 0.8}]
    kw = dict(protocols=("cxl_opt", "chi"), mixes=[(2, 1), (1, 1)],
              device=CPU)
    f = flitsim.sweep_perturbed(perts, **kw)
    a = flitsim.sweep_perturbed(perts, sim=ADAPTIVE_SIM, **kw)
    dev = np.max(np.abs(f["sim_efficiency"].values
                        - a["sim_efficiency"].values))
    assert float(dev) <= 1e-3


def test_perturbations_adaptive_all_families_match_reference():
    """Every protocol under ADAPTIVE_SIM (the periodic detectors and the
    fused run on perturbed stacks, shallow and deep queues): within 1e-3
    of the port's fixed engine, and within 1e-6 of the reference's
    adaptive engine."""
    kw = dict(mixes=[(2, 1), (1, 3)], backlogs=[2.0, 64.0])
    f = flitsim.sweep_perturbed(PERTS, device=CPU, **kw)["sim_efficiency"]
    a = flitsim.sweep_perturbed(PERTS, sim=ADAPTIVE_SIM, device=CPU,
                                **kw)["sim_efficiency"]
    ja = j_flitsim.sweep_perturbed(PERTS, sim=j_space.ADAPTIVE_SIM,
                                   **kw)["sim_efficiency"]
    _same_layout(a, ja)
    assert float(np.max(np.abs(a.values - f.values))) <= 1e-3
    np.testing.assert_allclose(a.values, np.asarray(ja.values), rtol=0,
                               atol=ATOL)


def _sim_axes(sp, uc):
    return [sp.axis("protocol_param", [{}, {"g_slots": 2.0},
                                       {"write_lanes": 0.5}]),
            sp.axis("phy", [uc.UCIE_S_32G, uc.UCIE_A_32G_55U]),
            sp.axis("backlog", [2.0, 64.0]),
            sp.axis("read_fraction", np.linspace(0.0, 1.0, 5))]


def test_protocol_param_space_matches_reference():
    """A [protocol_param x phy x backlog x read_fraction] space: every
    simulated metric's dims and coords equal the reference's, values atol
    1e-6, the protocol frontier exactly."""
    j, t = _both(_sim_axes, **FAST)
    metrics = ("sim_efficiency", "sim_bandwidth_gbs", "analytic_efficiency")
    rj, rt = j.evaluate(metrics=metrics), t.evaluate(metrics=metrics)
    for m in metrics:
        _same_layout(rt[m], rj[m])
        np.testing.assert_allclose(rt[m].values, np.asarray(rj[m].values),
                                   rtol=0 if m != "sim_bandwidth_gbs"
                                   else RTOL, atol=ATOL, err_msg=m)
    assert rt["sim_bandwidth_gbs"].argbest("protocol").values.tolist() == \
        rj["sim_bandwidth_gbs"].argbest("protocol").values.tolist()


def test_protocol_param_default_metrics():
    """A protocol_param axis alone with a traffic axis selects the
    simulated metrics, as in the reference."""
    j, t = _both(lambda sp, uc: [sp.axis("protocol_param", [{}]),
                                 sp.axis("mix", [(1, 1)])])
    assert t._default_metrics() == j._default_metrics()


def test_protocol_param_trace_axis_matches_reference():
    """``protocol_param`` leads the trace metrics' dims, as in the
    reference; per-phase efficiency atol 1e-6."""
    from repro.traces.trace import TrafficTrace as JTrace
    from repro_torch.traces.trace import TrafficTrace as TTrace

    def axes(trace_cls):
        def fn(sp, uc):
            traces = [trace_cls("a", (1.0, 3.0), (0.9, 0.2), (64.0, 4.0)),
                      trace_cls("b", (2.0, 2.0), (0.5, 0.5), (8.0, 8.0))]
            return [sp.axis("protocol_param", [{}, {"credit_lines": 0.5}]),
                    sp.axis("trace", traces)]
        return fn
    kw = dict(n_flits=128, n_accesses=128)
    j = j_space.DesignSpace(axes(JTrace)(j_space, j_ucie),
                            phy=j_ucie.UCIE_A_32G_55U, **kw)
    t = t_space.DesignSpace(axes(TTrace)(t_space, t_ucie),
                            phy=t_ucie.UCIE_A_32G_55U, device=CPU, **kw)
    metrics = ("trace_efficiency", "trace_phase_efficiency",
               "trace_bandwidth_gbs")
    rj, rt = j.evaluate(metrics=metrics), t.evaluate(metrics=metrics)
    for m in metrics:
        _same_layout(rt[m], rj[m])
        np.testing.assert_allclose(rt[m].values, np.asarray(rj[m].values),
                                   rtol=RTOL, atol=ATOL, err_msg=m)


def test_perturbation_touching_no_selected_field_rejected_in_space():
    """The design space refuses a protocol_param entry that touches no
    field of the selected protocols (tests/test_design_space.py)."""
    with pytest.raises(ValueError, match="applies to no parameter"):
        DesignSpace([axis("protocol_param", [{}, {"g_slots": 0.5}]),
                     axis("protocol", ["lpddr6_asym"]),
                     axis("mix", [(1, 1)])], device=CPU).evaluate(
            metrics=("sim_efficiency",))


def test_axis_index():
    """``Axis.index`` finds labels and raw values as the reference's."""
    for sp, uc in ((t_space, t_ucie), (j_space, j_ucie)):
        assert sp.axis("mix", [(1, 1), (2, 1)]).index((2, 1)) == 1
        assert sp.axis("backlog", [2, 64]).index(64) == 1
        assert sp.axis("k", [1, 4]).index(4.0) == 1
        assert sp.axis("phy", [uc.UCIE_S_32G]).index(uc.UCIE_S_32G) == 0
        assert sp.axis("protocol_param",
                       [{}, {"g_slots": 2.0}]).index("g_slotsx2") == 1
        with pytest.raises(KeyError):
            sp.axis("protocol", ["chi"]).index("cxl_opt")
