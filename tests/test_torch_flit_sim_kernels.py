"""Plain versions of the port's flit-simulator kernels
(``repro_torch.kernels.flit_sim.ref``) against the JAX reference's compute
bodies (``repro.kernels.flit_sim.ref``, what its Pallas kernels run), on
the same row-stacked operands made with numpy from a seed.

Tolerances: report rows atol 1e-6; detected and period rows exactly equal;
the convergence flag row exactly equal.  One exception, stated with its
reason: a chunk continued from a mid-run state holds the report row at
atol 2e-6 and the accumulator rows at rtol 2e-6, because the reference's
CPU compiler contracts ``TD + t * nd`` and ``cr + deficit * xr`` into
fused multiply-adds while the port rounds every operation (its kernel and
plain version must agree bit for bit); the observed gap is 1.3e-6 on the
report row.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flitsim as jf
from repro.core.traffic import mix_grid
from repro.kernels.flit_sim import ref as jref
from repro_torch import convert
from repro_torch.kernels.flit_sim import ops
from repro_torch.kernels.flit_sim import ref as tref


def _asym_rows(fracs):
    x = jnp.asarray(100.0 * np.asarray(fracs), jnp.float32)
    pstack = jf.AsymmetricLaneParams.stack(list(jf.ASYMMETRIC_PARAMS.values()))
    return np.asarray(jf._asym_param_rows(pstack, x, 100.0 - x))


def _sym_rows(fracs, backlogs, keys=("cxl_unopt", "cxl_opt", "chi")):
    x = jnp.asarray(100.0 * np.asarray(fracs), jnp.float32)
    pstack = jf.SymmetricFlitParams.stack([jf.SYMMETRIC_PARAMS[k]
                                           for k in keys])
    return np.asarray(jf._sym_param_rows(
        pstack, x, 100.0 - x, jnp.asarray(backlogs, jnp.float32)))


def _fracs(case):
    rng = np.random.default_rng(11)
    return {"grid21": np.linspace(0.0, 1.0, 21),
            "grid25": np.asarray(mix_grid(25)[0]) / 100.0,
            "random": rng.uniform(0.0, 1.0, 48),
            "rational": rng.integers(0, 40, 48) / 40.0}[case]


def test_layout_constants_equal():
    for name in ("SYM_ROWS", "ASYM_ROWS", "SCAL_COLS", "PERIOD_MAX",
                 "PERIOD_WINDOW", "PERIOD_WARM", "PERIOD_OBS", "PERIOD_EPS",
                 "SYM_PERIOD_OBS", "SYM_PERIODIC_ROWS",
                 "SYM_PERIODIC_MAX_BACKLOG", "DRIFT_SPAN"):
        assert getattr(tref, name) == getattr(jref, name), name


@pytest.mark.parametrize("case", ["grid21", "grid25", "random", "rational"])
@pytest.mark.parametrize("n_accesses", [4096, 1000])
def test_asymmetric_periodic_plain_matches_reference(case, n_accesses):
    rows = _asym_rows(_fracs(case))
    want = np.asarray(jref.asymmetric_periodic_compute(
        jnp.asarray(rows), n_accesses=n_accesses))
    got = ops.asymmetric_periodic(convert.rows(rows, "cpu"),
                                  n_accesses=n_accesses).numpy()
    np.testing.assert_array_equal(got[1:], want[1:])      # detected, period
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)


@pytest.mark.parametrize("case", ["grid21", "random", "rational"])
@pytest.mark.parametrize("backlogs", [[1.0, 1.5, 2.0], [1.0, 2.0, 4.0],
                                      [0.5, 3.0, 64.0]])
def test_symmetric_periodic_plain_matches_reference(case, backlogs):
    rows = _sym_rows(_fracs(case), backlogs)
    want = np.asarray(jref.symmetric_periodic_compute(jnp.asarray(rows),
                                                      n_flits=2048))
    got = ops.symmetric_periodic(convert.rows(rows, "cpu"),
                                 n_flits=2048).numpy()
    np.testing.assert_array_equal(got[1:], want[1:])      # detected, period
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)


@functools.lru_cache(maxsize=1)
def _bridge_chunks():
    """The reference's chunk-by-chunk run over the bridge's joint grid."""
    rows = _sym_rows(_fracs("grid21"), [2.0, 8.0, 64.0])
    return rows, list(_reference_chunks(rows))


def _reference_chunks(rows, horizon=2048, chunk=128):
    """The reference's fused adaptive loop, chunk by chunk (its
    ``_run_symmetric_pallas`` host logic): yields ``(k, state, hist,
    scal, out)`` with the JAX compute body's output."""
    body = jax.jit(functools.partial(jref.symmetric_chunk_compute,
                                     chunk=chunk))
    K = horizon // chunk
    K0 = max(K // 4, 1)
    min_k = max(4, K0 + 1)
    cells = rows.shape[1]
    z = lambda r: jnp.zeros((r, cells), jnp.float32)
    params = jnp.asarray(rows)
    state = z(16)
    Dh, TDh, Ph = [z(1)], [z(1)], [z(5)]
    for k in range(1, K + 1):
        m = max(k - 4, (k + 1) // 2)
        mid = (m + k + 1) // 2
        hist = jnp.concatenate([
            Ph[max(k - 3, 0)], Dh[m] if m < k else z(1),
            TDh[m] if m < k else z(1), Dh[mid] if mid < k else z(1),
            TDh[mid] if mid < k else z(1), Dh[K0] if k > K0 else z(1),
            z(6)])
        scal = np.zeros((1, 128), np.float32)
        scal[0, :10] = [k, m, mid, K0, K, chunk, 1e-3,
                        1.0 if (k >= min_k and k > 3) else 0.0,
                        1.0 if k >= K else 0.0, 2.0]
        out = body(params, state, hist, jnp.asarray(scal))
        yield k, np.asarray(state), np.asarray(hist), scal, np.asarray(out)
        state = out
        Dh.append(state[7:8])
        TDh.append(state[8:9])
        Ph.append(state[0:5])


def test_symmetric_chunk_plain_matches_reference_first_chunk():
    rows, chunks = _bridge_chunks()
    k, state, hist, scal, want = chunks[0]
    got = ops.symmetric_chunk(*(convert.rows(a, "cpu")
                                for a in (rows, state, hist, scal)),
                              chunk=128).numpy()
    np.testing.assert_allclose(got[10], want[10], atol=1e-6)    # report
    np.testing.assert_array_equal(got[11], want[11])            # conv
    np.testing.assert_array_equal(got[:5], want[:5])            # pools


@pytest.mark.parametrize("after", [2, 4, 8, 12, 15])
def test_symmetric_chunk_continues_reference_state(after):
    """Take the reference's state after chunk ``after``, carry it across
    (``repro_torch.convert``) and continue one chunk in both packages."""
    rows, chunks = _bridge_chunks()
    k, state, hist, scal, want = chunks[after]
    assert k == after + 1
    got = ops.symmetric_chunk(
        convert.rows(rows, "cpu"), convert.rows(state, "cpu"),
        convert.rows(hist, "cpu"), convert.rows(scal, "cpu"), chunk=128)
    got = got.numpy()
    np.testing.assert_allclose(got[10], want[10], atol=2e-6)    # report
    np.testing.assert_array_equal(got[11], want[11])            # conv
    np.testing.assert_array_equal(got[:5], want[:5])            # pools
    np.testing.assert_allclose(got[5:10], want[5:10], rtol=2e-6,
                               atol=2e-5)                       # cr..t


def test_convert_params_round_trip():
    ps = jf.SymmetricFlitParams.stack(list(jf.SYMMETRIC_PARAMS.values()))
    tp = convert.symmetric_params(ps, "cpu")
    for name in vars(tp):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(ps, name)))
    qs = jf.AsymmetricLaneParams.stack(list(jf.ASYMMETRIC_PARAMS.values()))
    tq = convert.asymmetric_params(
        {n: np.asarray(getattr(qs, n)) for n in vars(qs)}, "cpu")
    assert tq.total_lanes.tolist() == [74.0, 138.0]
    with pytest.raises(ValueError, match="2-D"):
        convert.rows(np.zeros(3), "cpu")


def test_wrappers_validate_operands():
    rows = torch.zeros((tref.SYM_ROWS, 4))
    with pytest.raises(ValueError, match="several devices"):
        ops.symmetric_chunk(rows, rows.to("meta"), rows, rows[:1],
                            chunk=8)
