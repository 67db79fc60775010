"""The port's design space, reports and bridge against the JAX reference
on the CPU: named-axis arrays (closed forms rel 1e-6), the joint frontier
at ``n_fracs=5`` (labels equal, ``protocol_rel_err`` atol 1e-6), and the
full-width ``--bridge`` run, whose summary must equal the checked-in
golden on every section."""
import json
import pathlib
import sys

import numpy as np
import pytest

from repro.core import space as j_space
from repro.core import ucie as j_ucie
from repro.core.space import ADAPTIVE_SIM as J_ADAPTIVE
from repro_torch.core import space as t_space
from repro_torch.core import ucie as t_ucie
from repro_torch.core.selector import SelectionConstraints

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from design_space_summary import summarize  # noqa: E402

CPU = "cpu"
RTOL = 1e-6


def _both(axes_fn, **kw):
    j = j_space.DesignSpace(axes_fn(j_space, j_ucie), **kw)
    t = t_space.DesignSpace(axes_fn(t_space, t_ucie), device=CPU, **kw)
    return j, t


def _workload_axes(sp, uc):
    return [sp.axis("workload_config", [("a", (67.0, 33.0)),
                                        ("b", (95.0, 5.0))]),
            sp.axis("mix", [sp.OWN_MIX, (2, 1), (1, 3)]),
            sp.axis("shoreline_mm", [2.0, 8.0])]


def _phy_axes(sp, uc):
    return [sp.axis("phy", [uc.UCIE_S_32G, uc.UCIE_A_48G_45U]),
            sp.axis("read_fraction", [0.0, 0.3, 0.7, 1.0]),
            sp.axis("shoreline_mm", [4.0, 8.0])]


@pytest.mark.parametrize("axes_fn", [_workload_axes, _phy_axes],
                         ids=["workload_config", "phy"])
def test_design_space_arrays_match(axes_fn):
    j, t = _both(axes_fn)
    metrics = ("bandwidth_gbs", "pj_per_bit", "power_w", "gbs_per_watt",
               "latency_ns", "relative_bit_cost")
    rj, rt = j.evaluate(metrics=metrics), t.evaluate(metrics=metrics)
    for m in metrics:
        assert rt[m].dims == rj[m].dims and rt[m].coords == rj[m].coords
        np.testing.assert_allclose(rt[m].values, np.asarray(rj[m].values),
                                   rtol=RTOL, err_msg=m)
    assert rt.frontier("bandwidth_gbs").values.tolist() == \
        rj.frontier("bandwidth_gbs").values.tolist()


def test_approach_metrics_match():
    j, t = _both(lambda sp, uc: [
        sp.axis("phy", [uc.UCIE_A_32G_55U, uc.UCIE_S_48G_110U]),
        sp.axis("read_fraction", [0.1, 0.5, 0.9])])
    names = ("linear_density_gbs_mm", "areal_density_gbs_mm2",
             "approach_pj_per_bit")
    rj, rt = j.evaluate(metrics=names), t.evaluate(metrics=names)
    for m in names:
        assert rt[m].dims == rj[m].dims
        np.testing.assert_allclose(rt[m].values, np.asarray(rj[m].values),
                                   rtol=RTOL)


@pytest.mark.parametrize("constraints", [
    dict(packaging="UCIe-A"), dict(max_relative_bit_cost=2.0),
    dict(max_power_w=30.0), dict(required_bandwidth_gbs=2000.0)])
def test_feasible_masks_match(constraints):
    from repro.core.selector import SelectionConstraints as JCons
    for axes_fn in (_workload_axes, _phy_axes):
        j, t = _both(axes_fn)
        metrics = ("bandwidth_gbs", "power_w")
        rj, rt = j.evaluate(metrics=metrics), t.evaluate(metrics=metrics)
        mj = rj.feasible(JCons(**constraints))
        mt = rt.feasible(SelectionConstraints(**constraints))
        np.testing.assert_array_equal(mt.values, mj.values)
        assert rt.frontier("bandwidth_gbs", where=mt).values.tolist() == \
            rj.frontier("bandwidth_gbs", where=mj).values.tolist()


def test_knee_budget_mask_matches():
    from repro.core.selector import SelectionConstraints as JCons
    j, t = _both(lambda sp, uc: [sp.axis("mix", [(2, 1), (1, 1)])])
    rj = j.evaluate(metrics=("bandwidth_gbs",))
    rt = t.evaluate(metrics=("bandwidth_gbs",))
    np.testing.assert_array_equal(
        rt.feasible(SelectionConstraints(max_backlog_knee=8.0)).values,
        rj.feasible(JCons(max_backlog_knee=8.0)).values)


def test_axis_validation():
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_space.AxisSet(t_space.axis("mix", [(1, 1)]),
                        t_space.axis("read_fraction", [0.5]))
    with pytest.raises(ValueError, match="unknown perturbation"):
        t_space.DesignSpace([t_space.axis("protocol_param",
                                          [{"warp_drive": 2.0}]),
                             t_space.axis("mix", [(1, 1)])],
                            device=CPU).evaluate(metrics=("sim_efficiency",))
    with pytest.raises(ValueError, match="TrafficTrace"):
        t_space.axis("trace", [1, 2])
    with pytest.raises(ValueError, match="OWN_MIX"):
        t_space.DesignSpace([t_space.axis("mix", [t_space.OWN_MIX])],
                            device=CPU)
    assert t_space.regimes(["a", "a", "b"], [0.0, 0.5, 1.0]) == \
        j_space.regimes(["a", "a", "b"], [0.0, 0.5, 1.0])


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed",
                                                         "adaptive"])
def test_joint_frontier_matches(adaptive):
    want = j_space.joint_frontier(n_fracs=5,
                                  sim=J_ADAPTIVE if adaptive else None)
    got = t_space.joint_frontier(
        n_fracs=5, sim=t_space.ADAPTIVE_SIM if adaptive else None,
        device=CPU)
    for key in ("keys", "analytic_best", "simulated_best",
                "disagreement_regions", "disagreement_fraction"):
        assert got[key] == want[key], key
    sb_g, sb_w = got["sim_bandwidth_gbs"], want["sim_bandwidth_gbs"]
    assert sb_g["best_protocol_by_phy"] == sb_w["best_protocol_by_phy"]
    assert sb_g["regimes_by_phy_backlog"] == sb_w["regimes_by_phy_backlog"]
    for k, v in want["protocol_rel_err"].items():
        assert abs(got["protocol_rel_err"][k] - v) <= 1e-6, k


def test_joint_frontier_with_constraints_matches():
    from repro.core.selector import SelectionConstraints as JCons
    want = j_space.joint_frontier(n_fracs=5, backlogs=(2.0, 64.0),
                                  constraints=JCons(packaging="UCIe-S"))
    got = t_space.joint_frontier(
        n_fracs=5, backlogs=(2.0, 64.0),
        constraints=SelectionConstraints(packaging="UCIe-S"), device=CPU)
    assert got["simulated_best"] == want["simulated_best"]
    assert got["analytic_best"] == want["analytic_best"]


def test_frontier_report_section():
    from repro.core.report import ReportSpec as JSpec
    from repro_torch.core.report import ReportSpec
    j, t = _both(_phy_axes)
    spec_j = JSpec(sections=("frontier",))
    spec_t = ReportSpec(sections=("frontier",))
    want = j.report(spec_j)["frontier"].payload
    got = t.report(spec_t)["frontier"].payload
    assert got == want


def test_bridge_full_width_matches_golden(tmp_path):
    """The design-space main path as a whole: the port's explorer
    ``--bridge`` at full width on the CPU; its summary equals the golden
    in every section, ``serving_frontier`` included."""
    from repro_torch import explorer
    ds = explorer.bridge_mode(tmp_path, device=CPU, verbose=False)
    on_disk = json.loads((tmp_path / "design_space.json").read_text())
    golden = json.loads(
        (ROOT / "experiments/golden/design_space_summary.json").read_text())
    got = summarize(on_disk)
    assert got == golden
    assert summarize(ds) == got
    cycles = ds["sim_phy_frontier"]["adaptive_cycles"]
    assert cycles["asymmetric"] == 128
