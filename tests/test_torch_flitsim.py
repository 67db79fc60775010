"""The port's flit simulators (``repro_torch.core.flitsim``) against the
JAX reference on the CPU, where the wrappers run the kernels' plain
versions.

Tolerances are the reference's own: the fixed engine at atol 1e-6
(``SEED_GOLDEN``, ``tests/test_flitsim_sweep.py``); the port's adaptive
run within 1e-6 of the reference's fused (``PALLAS_SIM``) and XLA
(``ADAPTIVE_SIM``) adaptive engines, with identical winners; cells the
symmetric periodic detector certifies bitwise equal to the fixed engine.
"""
import numpy as np
import pytest
import torch

from repro.core import flitsim as jf
from repro.core.space import ADAPTIVE_SIM as J_ADAPTIVE
from repro.core.space import FIXED_SIM as J_FIXED
from repro.core.space import PALLAS_SIM as J_PALLAS
from repro_torch.core import flitsim as tf
from repro_torch.core.space import ADAPTIVE_SIM, FIXED_SIM, SimConfig
from test_flitsim_sweep import SEED_GOLDEN

CPU = "cpu"
KEYS = tf.SIMULATED_PROTOCOLS
FR21 = np.linspace(0.0, 1.0, 21)


def _grid(sim, backlogs, fracs=FR21, keys=KEYS, device=CPU):
    x = 100.0 * fracs
    return tf.simulate_grid(keys, x, 100.0 - x, backlogs, sim=sim,
                            device=device)[0].numpy()


def _jgrid(sim, backlogs, fracs=FR21, keys=KEYS):
    x = 100.0 * fracs
    return np.asarray(jf.simulate_grid(keys, x, 100.0 - x, backlogs,
                                       sim=sim))[0]


def test_protocol_tables_equal():
    assert tf.SIMULATED_PROTOCOLS == tuple(jf.SIMULATORS)
    assert tf.CANONICAL_MIXES == jf.CANONICAL_MIXES
    assert tf.PERTURBABLE_FIELDS == jf.PERTURBABLE_FIELDS
    for k, p in tf.SYMMETRIC_PARAMS.items():
        assert vars(p) == vars(jf.SYMMETRIC_PARAMS[k])
    for k, p in tf.ASYMMETRIC_PARAMS.items():
        assert vars(p) == vars(jf.ASYMMETRIC_PARAMS[k])


def test_fixed_engine_matches_seed_golden():
    res = tf._sweep_impl(device=CPU)
    assert res.mixes == tf.CANONICAL_MIXES
    for i, key in enumerate(res.protocols):
        np.testing.assert_allclose(res.efficiency[i].numpy(),
                                   SEED_GOLDEN[key], atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("backlogs", [[2.0, 16.0, 64.0], [1.0, 4.0]])
def test_fixed_engine_matches_reference(backlogs):
    fr = np.linspace(0.0, 1.0, 9)
    np.testing.assert_allclose(_grid(FIXED_SIM, backlogs, fr),
                               _jgrid(J_FIXED, backlogs, fr), atol=1e-6)


def test_perturbed_fixed_engine_matches_reference():
    perts = [{}, {"credit_lines": 0.5}, {"read_lanes": 1.5}]
    x, y = [2.0, 1.0, 1.0], [1.0, 1.0, 3.0]
    want = np.asarray(jf.simulate_grid(KEYS, x, y, [8.0],
                                       perturbations=perts))
    got = tf.simulate_grid(KEYS, x, y, [8.0], perturbations=perts,
                           device=CPU).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError, match="unknown perturbation"):
        tf.simulate_grid(KEYS, x, y, [8.0], perturbations=[{"bogus": 2}],
                         device=CPU)


# the bridge's two simulated grids: joint (2, 8, 64) and sim_phy (2, 64)
BRIDGE_BACKLOGS = [[2.0, 8.0, 64.0], [2.0, 64.0]]


@pytest.mark.parametrize("backlogs", BRIDGE_BACKLOGS)
def test_adaptive_matches_reference_fused_engine(backlogs):
    got = _grid(ADAPTIVE_SIM, backlogs)
    info = tf.last_run_info()
    assert info["flitsim.symmetric"]["engine"] == "fused"
    assert info["flitsim.asymmetric"]["engine"] == "periodic"
    assert info["flitsim.asymmetric"]["cycles_run"] == 128
    np.testing.assert_allclose(got, _jgrid(J_PALLAS, backlogs), atol=1e-6)


@pytest.mark.parametrize("backlogs", BRIDGE_BACKLOGS)
def test_adaptive_matches_reference_xla_engine(backlogs):
    got = _grid(ADAPTIVE_SIM, backlogs)
    want = _jgrid(J_ADAPTIVE, backlogs)
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-6)   # symmetric
    np.testing.assert_allclose(got[3:], want[3:], atol=1e-6)
    assert np.array_equal(np.argmax(got, axis=0), np.argmax(want, axis=0))


def test_adaptive_within_tolerance_of_fixed():
    got = _grid(ADAPTIVE_SIM, [2.0, 64.0])
    np.testing.assert_allclose(got, _grid(FIXED_SIM, [2.0, 64.0]),
                               atol=1e-3)


def _periodic_case():
    """A shallow-queue grid the symmetric detector certifies (at most a
    quarter of its cells undetected, so the runner keeps its result)."""
    return np.linspace(0.0, 1.0, 5), [1.0]


def test_low_backlog_periodic_bitwise_to_fixed():
    fracs, backlogs = _periodic_case()
    got = _grid(ADAPTIVE_SIM, backlogs, fracs)
    info = tf.last_run_info()["flitsim.symmetric"]
    assert info["engine"] == "periodic", info
    assert info["periods"]
    fixed = _grid(FIXED_SIM, backlogs, fracs)
    np.testing.assert_array_equal(got, fixed)
    np.testing.assert_allclose(got, _jgrid(J_ADAPTIVE, backlogs, fracs),
                               atol=1e-6)


def test_saturated_grid_skips_symmetric_probe():
    from repro_torch.kernels.flit_sim import ref
    assert ref.SYM_PERIODIC_MAX_BACKLOG == 4.0
    _grid(ADAPTIVE_SIM, [2.0, 8.0], np.linspace(0, 1, 3), keys=("chi",))
    assert tf.last_run_info()["flitsim.symmetric"]["engine"] == "fused"


def test_asymmetric_escalates_undetected_cells_exactly():
    # read fractions whose credit period exceeds PERIOD_MAX go undetected
    # and are re-simulated at the full horizon
    fracs = np.asarray([0.0, 0.5, 1.0 / 3.0, 0.25, 0.2, 0.75, 0.6, 0.123])
    keys = ("lpddr6_asym", "hbm_asym")
    got = _grid(ADAPTIVE_SIM, [64.0], fracs, keys)
    info = tf.last_run_info()["flitsim.asymmetric"]
    assert info["engine"] == "periodic" and info["stragglers"] > 0
    np.testing.assert_allclose(got, _grid(FIXED_SIM, [64.0], fracs, keys),
                               atol=1e-6)
    np.testing.assert_allclose(got, _jgrid(J_ADAPTIVE, [64.0], fracs, keys),
                               atol=1e-6)


def test_asymmetric_chunked_fallback_matches_reference():
    # mostly aperiodic mixes: the detector gives up and the chunked plain
    # PyTorch core (the reference's XLA core) runs
    rng = np.random.default_rng(7)
    fracs = rng.uniform(0.01, 0.99, 40)
    keys = ("lpddr6_asym", "hbm_asym")
    got = _grid(ADAPTIVE_SIM, [64.0], fracs, keys)
    assert tf.last_run_info()["flitsim.asymmetric"]["engine"] == "torch"
    np.testing.assert_allclose(got, _jgrid(J_ADAPTIVE, [64.0], fracs, keys),
                               atol=1e-6)


def test_symmetric_straggler_escalation_matches_reference():
    # >= 256 cells: the loop may exit with stragglers, re-simulated at
    # the full horizon
    sim = SimConfig(mode="adaptive", tol=1e-5)
    fracs = np.linspace(0.0, 1.0, 43)
    keys = ("cxl_unopt", "cxl_opt", "chi")
    got = _grid(sim, [8.0, 64.0], fracs, keys)
    info = tf.last_run_info()["flitsim.symmetric"]
    assert info["cells"] == 258
    from repro.core.space import SimConfig as JSim
    want = _jgrid(JSim(mode="adaptive", tol=1e-5, engine="pallas"),
                  [8.0, 64.0], fracs, keys)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_divisor_chunk_and_budget_match_reference():
    for horizon in (2048, 4096, 1000, 997, 512, 3000):
        for chunk in (8, 64, 128, 500):
            assert tf._divisor_chunk(horizon, chunk) == \
                jf._divisor_chunk(horizon, chunk)
    for cells in (10, 256, 1000, 1 << 20):
        assert tf._escalation_budget(cells, 128, 2048) == \
            jf._escalation_budget(cells, 128, 2048)


def test_divisor_poor_horizon_falls_back_to_fixed():
    sim = SimConfig(mode="adaptive", max_cycles=997)      # prime horizon
    got = tf.simulate_grid(("chi",), [2.0], [1.0], [8.0], sim=sim,
                           device=CPU)
    want = tf.simulate_grid(("chi",), [2.0], [1.0], [8.0], n_flits=997,
                            device=CPU)
    assert torch.equal(got, want)


def test_backlog_knees_match_reference():
    mixes = [(2.0, 1.0), (1.0, 1.0)]
    want = jf.backlog_knees(mixes=mixes, per_mix=True)
    got = tf.backlog_knees(mixes=mixes, per_mix=True, device=CPU)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
