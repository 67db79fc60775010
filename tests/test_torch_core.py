"""The port's closed forms and catalog programs against the JAX
reference, on the CPU: the same numpy inputs through both packages, held
at the reference's own closed-form tolerance (rel 1e-6)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as j_cost
from repro.core import latency as j_latency
from repro.core import memsys as j_memsys
from repro.core import selector as j_selector
from repro.core import traffic as j_traffic
from repro.core import ucie as j_ucie
from repro.core.protocols import ALL_APPROACHES as J_APPROACHES
from repro.core.protocols import BASELINES as J_BASELINES
from repro_torch.core import cost as t_cost
from repro_torch.core import latency as t_latency
from repro_torch.core import memsys as t_memsys
from repro_torch.core import selector as t_selector
from repro_torch.core import traffic as t_traffic
from repro_torch.core import ucie as t_ucie
from repro_torch.core.protocols import ALL_APPROACHES as T_APPROACHES
from repro_torch.core.protocols import BASELINES as T_BASELINES

RTOL = 1e-6
CPU = "cpu"


def _mixes(seed=0, n=64):
    """Mix grid: the read-fraction sweep plus random (x, y) pairs."""
    rng = np.random.default_rng(seed)
    r = np.linspace(0.0, 1.0, 41)
    x = np.concatenate([100.0 * r, rng.uniform(0, 50, n)]).astype(np.float32)
    y = np.concatenate([100.0 - 100.0 * r,
                        rng.uniform(0.5, 50, n)]).astype(np.float32)
    return x, y


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


PHYS = ("UCIE_S_32G", "UCIE_A_32G_55U", "UCIE_A_32G_45U", "UCIE_S_48G_110U",
        "UCIE_A_48G_45U")


@pytest.mark.parametrize("name", PHYS)
def test_catalog_phys_equal(name):
    j, t = getattr(j_ucie, name), getattr(t_ucie, name)
    assert dataclasses.asdict(j)["name"] == t.name
    for f in dataclasses.fields(t):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        assert (jv.value if hasattr(jv, "value") else jv) == \
            (tv.value if hasattr(tv, "value") else tv)
    assert j.raw_bandwidth_gbs == t.raw_bandwidth_gbs


def test_table1_latency_cost_equal():
    assert j_ucie.table1() == t_ucie.table1()
    assert j_latency.MEASURED_FRONTEND_LATENCY_NS == \
        t_latency.MEASURED_FRONTEND_LATENCY_NS
    assert j_latency.latency_speedup() == t_latency.latency_speedup()
    for js, ts in zip(j_cost.reference_systems(),
                      t_cost.reference_systems()):
        assert js.relative_cost() == ts.relative_cost()


def test_traffic_mix_and_grid():
    for n in (1, 5, 21, 41, 101):
        jx, jy = j_traffic.mix_grid(n)
        tx, ty = t_traffic.mix_grid(n, device=CPU)
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    m = t_traffic.TrafficMix.from_bytes(6.7e9, 3.3e9)
    assert m.name == j_traffic.TrafficMix.from_bytes(6.7e9, 3.3e9).name
    with pytest.raises(ValueError):
        t_traffic.TrafficMix(0, 0)


@pytest.mark.parametrize("key", sorted(T_APPROACHES) + sorted(T_BASELINES))
@pytest.mark.parametrize("fn", ["bw_eff", "p_data", "power_pj_per_bit",
                                "bw_density_linear", "bw_density_areal"])
def test_protocol_closed_forms(key, fn):
    jp = {**J_APPROACHES, **J_BASELINES}[key]
    tp = {**T_APPROACHES, **T_BASELINES}[key]
    x, y = _mixes()
    for jphy, tphy in ((j_ucie.UCIE_A_32G_55U, t_ucie.UCIE_A_32G_55U),
                       (j_ucie.UCIE_S_48G_110U, t_ucie.UCIE_S_48G_110U)):
        args_j = (jnp.asarray(x), jnp.asarray(y))
        args_t = (_t(x), _t(y))
        if fn not in ("bw_eff", "p_data"):
            args_j, args_t = args_j + (jphy,), args_t + (tphy,)
        want = np.asarray(getattr(jp, fn)(*args_j))
        got = getattr(tp, fn)(*args_t).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=key)


def test_catalog_program_matches():
    x, y = _mixes(1)
    sl = np.asarray([2.0, 8.0, 16.0], np.float32)
    items_j = j_memsys.default_catalog_items()
    items_t = t_memsys.default_catalog_items()
    assert [k for k, _ in items_j] == [k for k, _ in items_t]
    want = j_memsys.run_catalog_program(items_j, x[:, None], y[:, None], sl)
    got = t_memsys.run_catalog_program(items_t, _t(x[:, None]),
                                       _t(y[:, None]), _t(sl))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_phy_stacked_programs_match():
    x, y = _mixes(2)
    phys_j = [getattr(j_ucie, n) for n in PHYS]
    phys_t = [getattr(t_ucie, n) for n in PHYS]
    sl = np.asarray([4.0, 8.0], np.float32)
    want = j_memsys.run_catalog_phys_program(
        j_memsys.approach_catalog_items(), phys_j, x[:, None], y[:, None],
        sl)
    got = t_memsys.run_catalog_phys_program(
        t_memsys.approach_catalog_items(), phys_t, _t(x[:, None]),
        _t(y[:, None]), _t(sl))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    want = j_memsys.run_approach_phys_program(phys_j, x, y)
    got = t_memsys.run_approach_phys_program(phys_t, _t(x), _t(y))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("constraints", [
    dict(), dict(packaging="UCIe-S"), dict(max_relative_bit_cost=2.0),
    dict(max_power_w=20.0, shoreline_mm=4.0),
])
def test_rank_and_rank_grid_match(constraints):
    mix = j_traffic.TrafficMix(2, 1)
    want = j_selector.rank(mix, j_selector.SelectionConstraints(
        **constraints))
    got = t_selector.rank(t_traffic.TrafficMix(2, 1),
                          t_selector.SelectionConstraints(**constraints),
                          device=CPU)
    assert [r.key for r in got] == [r.key for r in want]
    np.testing.assert_allclose([r.bandwidth_gbs for r in got],
                               [r.bandwidth_gbs for r in want], rtol=RTOL)
    gx, gy = j_traffic.mix_grid(41)
    want = j_selector._rank_grid_impl(
        gx, gy, j_selector.SelectionConstraints(**constraints)).best_keys()
    got = t_selector._rank_grid_impl(
        np.asarray(gx), np.asarray(gy),
        t_selector.SelectionConstraints(**constraints), device=CPU)
    assert got.tolist() == want.tolist()


def test_key_maps_equal():
    assert t_selector.CATALOG_SIM_KEYS == j_selector.CATALOG_SIM_KEYS
    assert t_selector.SIM_APPROACH_KEYS == j_selector.SIM_APPROACH_KEYS
