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
import dataclasses
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


# -- planted cells: every branch of the CUDA detectors' replay --------------
# Found by searching read fractions (rational with denominators up to 128,
# multiples of sqrt(2) mod 1), backlogs 0.25-32 and scaled fields with the
# port's plain detectors; pinned by their parameters, each with the period
# the plain version reports (0: not detected).

#: name -> ((protocol, scaled fields, read fraction, backlog), period)
SYM_PLANTED = {
    "d = 1": (("cxl_unopt", {}, 0.5, 2.0), 1),
    "mid lag": (("cxl_unopt", {}, 0.44, 1.0), 25),
    "d = 64": (("cxl_unopt", {}, 0.0625, 0.25), 64),
    # the state matches at lag 8, but no delivery of the window's last
    # step is an integer: not detected through the gate
    "match beyond int_run": (("cxl_unopt", {}, 0.78125, 4.0), 0),
    # the state enters its cycle after the window opens
    "transient, d = 1": (("chi", {"credit_lines": 2.0}, 0.5, 32.0), 1),
    "transient, d = 12": (("cxl_opt", {"reqs_per_g": 0.5}, 1.0, 4.0), 12),
    "period 128": (("cxl_unopt", {}, 0.03125, 0.25), 0),
}
#: name -> (read fraction, period at 4096 accesses); (4096 - PERIOD_OBS)
#: mod d is the r of the extrapolation
ASYM_PLANTED = {
    "d = 1": (0.0, 1),
    "d = 7, r = 6": (2.0 / 7.0, 7),
    "d = 32, r = 0": (3.0 / 32.0, 32),
    "d = 64, r = 0": (5.0 / 64.0, 64),
    "irrational, within eps at d = 63": ((220.0 * np.sqrt(2.0)) % 1.0, 63),
    "irrational, no match": (1.0 / np.sqrt(2.0), 0),
    "period 65": (1.0 / 65.0, 0),
}


def _planted_sym_rows(cells):
    """Symmetric ``[SYM_ROWS, C]`` rows of (protocol, scaled fields, read
    fraction, backlog) cells, built as ``_sym_param_rows`` builds them."""
    rows = np.zeros((tref.SYM_ROWS, len(cells)), np.float32)
    for c, (key, pert, frac, backlog) in enumerate(cells):
        p = jf.SYMMETRIC_PARAMS[key].perturbed(pert)
        x = np.float32(100.0 * frac)
        rows[:11, c] = [getattr(p, f.name) for f in dataclasses.fields(p)]
        rows[11:14, c] = [x, np.float32(100.0) - x, backlog]
    return rows


def _sym_window(rows):
    """The plain symmetric observation of a ``[SYM_ROWS, C]`` CPU tensor:
    the core after each window step ``[7, W, C]``, each step's delivery
    ``[W, C]``, and a step function of the core."""
    from repro_torch.core import flitsim as tf
    p = tf.SymmetricFlitParams(*[rows[i] for i in range(11)])
    step = tf._symmetric_stepfn(p, rows[11], rows[12], rows[13])
    core = tuple(torch.zeros(rows.shape[1]) for _ in range(7))
    for _ in range(tref.PERIOD_WARM):
        core, _ = step(core)
    win, nds = [], []
    for _ in range(tref.PERIOD_WINDOW):
        core, nd = step(core)
        win.append(torch.stack(core))
        nds.append(nd)
    return torch.stack(win, dim=1), torch.stack(nds), step


@pytest.mark.parametrize("name", sorted(SYM_PLANTED))
def test_symmetric_periodic_planted_cells(name):
    """Each planted cell on the reference and the port's plain detector
    alike, and on the branch it was planted for: the smallest lag at which
    the window's last core recurs exactly, the run of integer deliveries
    that ends the window, a transient inside the window, a longer period."""
    cell, period = SYM_PLANTED[name]
    rows = _planted_sym_rows([cell])
    want = np.asarray(jref.symmetric_periodic_compute(jnp.asarray(rows),
                                                      n_flits=2048))
    got = ops.symmetric_periodic(convert.rows(rows, "cpu"),
                                 n_flits=2048).numpy()
    np.testing.assert_array_equal(got[1:], want[1:])      # detected, period
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    assert got[2, 0] == period
    W = tref.PERIOD_WINDOW
    win, nds, step = _sym_window(convert.rows(rows, "cpu"))
    win, nds = win[:, :, 0], nds[:, 0]
    lags = [d for d in range(1, tref.PERIOD_MAX + 1)
            if torch.equal(win[:, W - 1], win[:, W - 1 - d])]
    is_int = (torch.floor(nds) == nds).flip(0).tolist()
    int_run = is_int.index(False) if False in is_int else W
    if name == "match beyond int_run":
        assert lags and lags[0] > int_run
    elif name == "period 128":
        assert not lags
        core = tuple(win[:, W - 1][:, None])
        seen = []
        for _ in range(256):
            core, _ = step(core)
            seen.append(torch.stack(core)[:, 0])
        assert [d for d in range(1, 129)
                if torch.equal(seen[-1], seen[-1 - d])][0] == 128
    else:
        assert lags[0] == period <= int_run
        transient = any(not torch.equal(win[:, s], win[:, s + period])
                        for s in range(W - period))
        assert transient == name.startswith("transient")


@pytest.mark.parametrize("name", sorted(ASYM_PLANTED))
@pytest.mark.parametrize("n_accesses", [4096, 1000])
def test_asymmetric_periodic_planted_cells(name, n_accesses):
    """Each planted mix on both lane protocols: the reference and the
    port's plain detector alike, at the period pinned (the credit period
    depends on the mix alone)."""
    frac, period = ASYM_PLANTED[name]
    rows = _asym_rows([frac])
    want = np.asarray(jref.asymmetric_periodic_compute(
        jnp.asarray(rows), n_accesses=n_accesses))
    got = ops.asymmetric_periodic(convert.rows(rows, "cpu"),
                                  n_accesses=n_accesses).numpy()
    np.testing.assert_array_equal(got[1:], want[1:])      # detected, period
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    assert got[2].tolist() == [period] * rows.shape[1]


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


# -- whole adaptive runs: the plain run against the per-chunk host loop -----

def _loop_symmetric(params, *, K, chunk, tol, budget):
    """The port's adaptive symmetric host loop as it stood before the run
    kernel (one ``ops.symmetric_chunk`` a chunk, the host gathering the
    history and scalar rows and reading the flags back): the oracle of
    ``ref.symmetric_run_compute``."""
    from repro_torch.core import flitsim as tf
    cells = params.shape[1]
    K0 = max(K // 4, 1)
    min_k = max(4, K0 + 1)
    state = torch.zeros((tref.SYM_ROWS, cells))
    zrow, z5, z6 = (torch.zeros((r, cells)) for r in (1, 5, 6))
    Dh, TDh, Ph = [zrow], [zrow], [z5]
    conv_at = np.full(cells, -1, np.int32)
    k = 0
    while k < K:
        k += 1
        m = max(k - 4, (k + 1) // 2)
        mid = (m + k + 1) // 2
        hist = torch.cat([
            Ph[max(k - 3, 0)], Dh[m] if m < k else zrow,
            TDh[m] if m < k else zrow, Dh[mid] if mid < k else zrow,
            TDh[mid] if mid < k else zrow, Dh[K0] if k > K0 else zrow, z6])
        scal = tf._scal_row([k, m, mid, K0, K, chunk, tol,
                             1.0 if (k >= min_k and k > 3) else 0.0,
                             1.0 if k >= K else 0.0, 2.0], "cpu")
        state = ops.symmetric_chunk(params, state, hist, scal, chunk=chunk)
        Dh.append(state[7:8])
        TDh.append(state[8:9])
        Ph.append(state[0:5])
        conv_np = (state[11] > 0.5).numpy()
        conv_at[(conv_at < 0) & conv_np] = k
        if int((~conv_np).sum()) <= budget:
            break
    return state, conv_at, k


def _loop_pipelining(params, *, K, chunk, tol, n_lines):
    """The port's adaptive pipelining host loop as it stood before the run
    kernel: the oracle of ``ref.pipelining_run_compute``."""
    from repro_torch.core import flitsim as tf
    cells = params.shape[1]
    state = torch.zeros((tref.PIPE_ROWS, cells))
    hist = torch.zeros((tref.ASYM_ROWS, cells))
    conv_at = np.full(cells, -1, np.int32)
    k = 0
    while k < K:
        k += 1
        scal = tf._scal_row([k, K, chunk, tol,
                             1.0 if k >= min(4, K) else 0.0,
                             1.0 if k >= K else 0.0, n_lines], "cpu")
        state = ops.pipelining_chunk(params, state, hist, scal, chunk=chunk)
        if k == 1:
            hist = torch.cat([state[8:9], torch.zeros((7, cells))])
        conv_np = (state[11] > 0.5).numpy()
        conv_at[(conv_at < 0) & conv_np] = k
        if int((~conv_np).sum()) == 0:
            break
    return state, conv_at, k


def _assert_run_equal(got, want):
    state, conv_at, k_exit = got
    assert conv_at.dtype == torch.int32 and k_exit.dtype == torch.int32
    assert torch.equal(state, want[0])
    np.testing.assert_array_equal(conv_at.numpy(), want[1])
    assert k_exit.tolist() == [want[2]]


# name -> (fractions, backlogs, keys, horizon, tol): the bridge's two
# grids, a saturated one, one of 387 cells that leaves stragglers, and
# horizons whose chunk schedule gives K = 8 (chunk 125) and chunk 8
SYM_RUNS = {
    "bridge joint": (np.linspace(0, 1, 21), [2.0, 8.0, 64.0], None, 2048,
                     1e-3),
    "bridge sim_phy": (np.linspace(0, 1, 21), [2.0, 64.0], None, 2048,
                       1e-3),
    "saturated": (np.linspace(0, 1, 7), [64.0, 128.0, 256.0], None, 2048,
                  1e-3),
    "stragglers": (np.linspace(0, 1, 43), [16.0, 32.0, 64.0], None, 2048,
                   1e-3),
    "K 8": (np.linspace(0, 1, 9), [2.0, 64.0], ("chi", "cxl_opt"), 1000,
            1e-3),
    "chunk 8": (np.linspace(0, 1, 5), [8.0], ("cxl_unopt",), 64, 1e-3),
}


@pytest.mark.parametrize("case", sorted(SYM_RUNS))
def test_symmetric_run_plain_equals_host_loop(case):
    from repro_torch.core import flitsim as tf
    fracs, backlogs, keys, horizon, tol = SYM_RUNS[case]
    rows = convert.rows(_sym_rows(fracs, backlogs, keys or
                                  ("cxl_unopt", "cxl_opt", "chi")), "cpu")
    cells = rows.shape[1]
    chunk = tf._divisor_chunk(horizon, 128)
    K = horizon // chunk
    budget = tf._escalation_budget(cells, chunk, horizon)
    assert (K, chunk) == {"K 8": (8, 125), "chunk 8": (8, 8)}.get(
        case, (16, 128))
    assert (budget > 0) == (cells >= 256)
    want = _loop_symmetric(rows, K=K, chunk=chunk, tol=tol, budget=budget)
    ops.reset_launches()
    got = ops.symmetric_run(rows, K=K, chunk=chunk, tol=tol, budget=budget)
    assert ops.launches["symmetric_run"] == 0        # CPU: the plain run
    _assert_run_equal(got, want)
    if case == "stragglers":       # the exit leaves unconverged cells
        assert 0 < int((want[0][11] < 0.5).sum()) <= budget
    if case == "saturated":
        assert want[2] < K


@pytest.mark.parametrize("n_lines,chunk", [(512, 64), (128, 8)])
def test_pipelining_run_plain_equals_host_loop(n_lines, chunk):
    from repro_torch.core import flitsim as tf
    rows = tf._pipe_param_rows(torch.arange(1, 9),
                               torch.tensor([8.0, 16.0]),
                               torch.tensor([16.0, 32.0, 64.0]))
    K = n_lines // chunk
    want = _loop_pipelining(rows, K=K, chunk=chunk, tol=1e-3,
                            n_lines=n_lines)
    got = ops.pipelining_run(rows, K=K, chunk=chunk, tol=1e-3,
                             n_lines=n_lines)
    _assert_run_equal(got, want)


def test_run_wrappers_validate_operands():
    rows = torch.zeros((tref.SYM_ROWS, 4))
    with pytest.raises(ValueError, match="no kernel"):
        ops.symmetric_run(rows.to("meta"), K=4, chunk=8, tol=1e-3, budget=0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.pipelining_run(rows.to("meta"), K=4, chunk=8, tol=1e-3,
                           n_lines=32)
