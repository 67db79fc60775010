"""The port's Fig-13 pipelining path against the JAX reference on the CPU:
the plain ``pipelining_chunk`` against the reference's compute body and
its Pallas kernel (interpret mode), the fixed, fused-adaptive and
chunked-adaptive engines, the scalar form and the ``k`` /
``ucie_line_ui`` / ``device_line_ui`` design-space axes.  Inputs are made
with numpy and fed to both packages.

Tolerances: state rows 0-9 and the convergence row exactly equal; the
report row (10) at atol 1e-6 — XLA's CPU backend may contract
``link_free + ahat * ...`` into a fused multiply-add while the port
rounds every operation; utilizations atol 1e-6; adaptive against the
port's own fixed engine within 1e-3 (the adaptive contract)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flitsim as jf
from repro.core import space as j_space
from repro.core.space import ADAPTIVE_SIM as J_ADAPTIVE
from repro.core.space import FIXED_SIM as J_FIXED
from repro.core.space import PALLAS_SIM as J_PALLAS
from repro.kernels.flit_sim import kernel as jkernel
from repro.kernels.flit_sim import ref as jref
from repro_torch import convert
from repro_torch.core import flitsim as tf
from repro_torch.core import space as t_space
from repro_torch.kernels.flit_sim import ops
from repro_torch.kernels.flit_sim import ref as tref

CPU = "cpu"
ATOL = 1e-6
KS = (1, 2, 3, 4, 6)
US = (8.0, 16.0)
DS = (16.0, 32.0, 64.0)
T_ADAPTIVE = t_space.ADAPTIVE_SIM


def _np(t):
    return np.asarray(t)


def test_layout_constants_equal():
    for name in ("PIPE_ROWS", "PIPE_MAX_K", "ASYM_ROWS", "SCAL_COLS"):
        assert getattr(tref, name) == getattr(jref, name), name
    assert tf._PIPELINING_PAD_K == jf._PIPELINING_PAD_K


def test_param_rows_match_reference():
    ks, us, ds = (1, 3, 8), (8.0, 12.0), (16.0, 40.0, 64.0)
    want = _np(jf._pipe_param_rows(jnp.asarray(ks, jnp.int32),
                                   jnp.asarray(us, jnp.float32),
                                   jnp.asarray(ds, jnp.float32)))
    got = tf._pipe_param_rows(torch.tensor(ks), torch.tensor(us),
                              torch.tensor(ds)).numpy()
    assert got.shape == (tref.PIPE_ROWS, len(ks) * len(us) * len(ds))
    np.testing.assert_array_equal(got[:3], want[:3])
    assert not got[3:].any()


def _ragged_rows():
    """45 cells (not a multiple of the TPU's 128-cell tile)."""
    rng = np.random.default_rng(5)
    ks = (1, 2, 3, 5, 8)
    us = tuple(float(v) for v in rng.integers(4, 24, 3))
    ds = tuple(float(v) for v in rng.integers(12, 96, 3))
    return tf._pipe_param_rows(torch.tensor(ks), torch.tensor(us),
                               torch.tensor(ds))


def test_plain_chunk_matches_reference_over_a_run():
    """A whole adaptive schedule from zero state (horizon 512, chunk 64):
    at every chunk the port's plain version, the reference's compute body
    and its Pallas kernel (interpret mode) take identical inputs."""
    params = _ragged_rows()
    cells = params.shape[1]
    tile, cpad = jkernel.tile_for(cells)
    horizon, chunk = 512, 64
    K = horizon // chunk
    state = torch.zeros((tref.PIPE_ROWS, cells))
    hist = torch.zeros((tref.ASYM_ROWS, cells))
    rep_bitwise = []
    for k in range(1, K + 1):
        scal = tf._scal_row([k, K, chunk, 1e-3, 1.0 if k >= 4 else 0.0,
                             1.0 if k >= K else 0.0, horizon], CPU)
        got = ops.pipelining_chunk(params, state, hist, scal,
                                   chunk=chunk).numpy()
        args = [jnp.asarray(t.numpy()) for t in (params, state, hist, scal)]
        want_ref = _np(jref.pipelining_chunk_ref(*args, chunk=chunk))
        padded = [jkernel.pad_cells(a, cpad) for a in args[:3]] + [args[3]]
        want_kernel = _np(jkernel.pipelining_chunk(
            *padded, chunk=chunk, tile=tile, interpret=True))[:, :cells]
        for want in (want_ref, want_kernel):
            exact = [r for r in range(tref.PIPE_ROWS) if r != 10]
            np.testing.assert_array_equal(got[exact], want[exact],
                                          err_msg=f"chunk {k}")
            np.testing.assert_allclose(got[10], want[10], atol=ATOL,
                                       rtol=0, err_msg=f"chunk {k}")
            rep_bitwise.append(np.array_equal(got[10], want[10]))
        state = torch.from_numpy(got)
        if k == 1:
            hist = torch.cat([state[8:9], torch.zeros((7, cells))])
    assert state[11].all()          # the horizon chunk converges every cell
    print(f"report row bitwise equal in {sum(rep_bitwise)} of "
          f"{len(rep_bitwise)} comparisons")


def _jax_grid(ks, sim, us=US, ds=DS, n_lines=512):
    return _np(jf._sweep_pipelining_impl(ks, n_lines=n_lines,
                                         ucie_line_ui=us, device_line_ui=ds,
                                         sim=sim))


def _port_grid(ks, sim, us=US, ds=DS, n_lines=512):
    return tf._sweep_pipelining_impl(ks, n_lines=n_lines, ucie_line_ui=us,
                                     device_line_ui=ds, sim=sim,
                                     device=CPU).numpy()


def test_fixed_grid_matches_reference():
    got = _port_grid(KS, None)
    assert got.shape == (len(KS), len(US), len(DS))
    np.testing.assert_allclose(got, _jax_grid(KS, J_FIXED), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("jsim", [J_PALLAS, J_ADAPTIVE],
                         ids=["pallas", "xla"])
def test_adaptive_matches_reference(jsim):
    got = _port_grid(KS, T_ADAPTIVE)
    info = tf.last_run_info()["flitsim.pipelining"]
    np.testing.assert_allclose(got, _jax_grid(KS, jsim), atol=ATOL, rtol=0)
    want = jf.last_run_info()["flitsim.pipelining"]
    assert info["engine"] == "fused" and info["chunk"] == 64
    assert info["launches"] == 1        # one run launch, no escalation
    assert info["cells"] == len(KS) * len(US) * len(DS)
    for key in ("cycles_run", "converged_cycles", "horizon", "chunk"):
        assert info[key] == want[key], key
    assert np.max(np.abs(got - _port_grid(KS, None))) <= 1e-3


def test_wide_ready_table_runs_chunked_core():
    """k > PIPE_MAX_K: the plain chunked core (the reference's XLA
    ``while_loop`` core)."""
    got = _port_grid((4, 12), T_ADAPTIVE)
    assert tf.last_run_info()["flitsim.pipelining"]["engine"] == "torch"
    np.testing.assert_allclose(got, _jax_grid((4, 12), J_ADAPTIVE),
                               atol=ATOL, rtol=0)
    assert np.max(np.abs(got - _port_grid((4, 12), None))) <= 1e-3


def test_short_horizon_falls_back_to_fixed():
    sim = t_space.SimConfig(mode="adaptive", max_cycles=509)   # prime
    got = _port_grid((2, 4), sim, us=(16.0,), ds=(64.0,))
    np.testing.assert_array_equal(
        got, _port_grid((2, 4), None, us=(16.0,), ds=(64.0,), n_lines=509))
    np.testing.assert_allclose(
        got, _jax_grid((2, 4), j_space.SimConfig(mode="adaptive",
                                                 max_cycles=509),
                       us=(16.0,), ds=(64.0,)), atol=ATOL, rtol=0)


def test_scalar_form_matches_reference():
    got = [tf.simulate_lpddr6_pipelining(k, device=CPU) for k in range(1, 9)]
    want = [jf.simulate_lpddr6_pipelining(k) for k in range(1, 9)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert abs(got[3] - 1.0) <= 1e-3
    assert tf._sweep_pipelining_impl((2, 4), device=CPU).shape == (2,)


def _pipe_axes(sp, with_ui):
    axes = [sp.axis("k", list(range(1, 9)))]
    if with_ui:
        axes += [sp.axis("ucie_line_ui", US),
                 sp.axis("device_line_ui", DS)]
    return axes


@pytest.mark.parametrize("with_ui", [True, False], ids=["k_u_d", "k"])
@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed", "adaptive"])
def test_design_space_axes_match(with_ui, adaptive):
    j = j_space.DesignSpace(_pipe_axes(j_space, with_ui),
                            sim=J_ADAPTIVE if adaptive else None)
    t = t_space.DesignSpace(_pipe_axes(t_space, with_ui),
                            sim=T_ADAPTIVE if adaptive else None,
                            device=CPU)
    rj, rt = j.evaluate(), t.evaluate()
    assert rt.metrics == rj.metrics == ("utilization",)
    uj, ut = rj["utilization"], rt["utilization"]
    assert ut.dims == uj.dims and ut.coords == uj.coords
    np.testing.assert_allclose(ut.values, np.asarray(uj.values), atol=ATOL,
                               rtol=0)
    sj, st = uj.sel(k=4), ut.sel(k=4)
    assert st.dims == sj.dims and st.coords == sj.coords
    np.testing.assert_allclose(st.values, np.asarray(sj.values), atol=ATOL,
                               rtol=0)


def test_axis_labels_and_lookup():
    axes = {}
    for name, vals in (("k", [1, 2, 8]), ("ucie_line_ui", [8, 16.5]),
                       ("device_line_ui", [64, 128])):
        a, b = t_space.axis(name, vals), j_space.axis(name, vals)
        assert a.values == b.values and a.labels == b.labels
        axes[name] = a
    # label lookup through sel(): ints and floats resolve on every axis
    values = np.arange(3 * 2 * 2, dtype=np.float64).reshape(3, 2, 2)
    coords = tuple(axes[n].labels for n in axes)
    ta = t_space.SpaceArray(tuple(axes), coords, values)
    ja = j_space.SpaceArray(tuple(axes), coords, values)
    for lookup in ({"k": 8}, {"k": 2.0}, {"ucie_line_ui": 8},
                   {"ucie_line_ui": 16.5, "device_line_ui": 128},
                   {"k": 1, "ucie_line_ui": 8.0, "device_line_ui": 64}):
        st, sj = ta.sel(**lookup), ja.sel(**lookup)
        assert st.dims == sj.dims and st.coords == sj.coords
        np.testing.assert_array_equal(st.values, np.asarray(sj.values))
    with pytest.raises(KeyError):
        ta.sel(k=3)
    for name in ("k", "ucie_line_ui", "device_line_ui"):
        assert t_space.axis(name, [1]).name == name    # ported: it builds
    assert t_space.PIPELINE_METRICS == j_space.PIPELINE_METRICS
    assert t_space.DesignSpace([t_space.axis("k", [1])],
                               device=CPU).n_lines == 512


def test_utilization_needs_a_k_axis():
    space = t_space.DesignSpace([t_space.axis("read_fraction", [0.5])],
                                device=CPU)
    with pytest.raises(ValueError, match="needs a 'k' axis"):
        space.evaluate(metrics=("utilization",))


def test_wrapper_validates_pipelining_operands():
    params = _ragged_rows()
    cells = params.shape[1]
    state = torch.zeros((tref.PIPE_ROWS, cells))
    hist = torch.zeros((tref.ASYM_ROWS, cells))
    scal = tf._scal_row([1, 8, 64, 1e-3, 0, 0, 512], CPU)
    with pytest.raises(ValueError, match="several devices"):
        ops.pipelining_chunk(params, state.to("meta"), hist, scal, chunk=8)
    with pytest.raises(ValueError, match="no kernel"):
        ops.pipelining_chunk(*(t.to("meta") for t in (params, state, hist,
                                                      scal)), chunk=8)
    ops.reset_launches()
    out = ops.pipelining_chunk(convert.rows(params.numpy(), CPU), state,
                               hist, scal, chunk=8)
    assert out.shape == (tref.PIPE_ROWS, cells)
    assert ops.launches["pipelining_chunk"] == 0
