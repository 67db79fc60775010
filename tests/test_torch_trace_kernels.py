"""Plain versions of the port's trace-scan kernels
(``repro_torch.kernels.flit_sim.ref.symmetric_trace_compute`` and
``asymmetric_trace_compute``, what ``symmetric_trace`` and
``asymmetric_trace`` in ``csrc/flit_sim.cu`` repeat operation for
operation) against the JAX reference's trace-scan cores
(``repro.core.flitsim._symmetric_trace_grid`` / ``_asymmetric_trace_grid``,
XLA scans: the reference has no kernel for them), on the same row-stacked
operands made with numpy from a seed; and the launch wrappers' routing,
checks and counters on the CPU.

Tolerances: per-phase efficiency atol 1e-6 against the reference (the
fixed engine's tolerance); bitwise where the port is held against itself
(a one-phase trace against the fixed static grid, padded phases against
the unpadded trace, the runner's layout against cell-by-cell runs)."""
import numpy as np
import pytest
import torch

from repro.core import flitsim as jf
from repro_torch.core import flitsim
from repro_torch.kernels.flit_sim import ops
from repro_torch.kernels.flit_sim import ref as tref
from repro_torch.traces import TrafficTrace, pad_traces

ATOL = 1e-6
SYM_KEYS = ("cxl_unopt", "cxl_opt", "chi")
ASYM_KEYS = ("lpddr6_asym", "hbm_asym")


def _phases(seed, T, N):
    """``[T, N]`` read/write percentages and backlogs from one seed, with
    the corner mixes (all reads, all writes) and shallow backlogs in."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0.0, 100.0, (T, N)).astype(np.float32)
    xs.flat[::7] = 100.0
    xs.flat[3::11] = 0.0
    bls = rng.choice(np.float32([1, 2, 4, 16, 64, 128]), (T, N))
    bls = (bls * rng.uniform(0.5, 1.0, (T, N))).astype(np.float32)
    return xs, (100.0 - xs).astype(np.float32), np.maximum(bls, 1.0)


def _sym_stack(keys=SYM_KEYS):
    return flitsim.SymmetricFlitParams.stack(
        [flitsim.SYMMETRIC_PARAMS[k] for k in keys], "cpu")


def _asym_stack(keys=ASYM_KEYS):
    return flitsim.AsymmetricLaneParams.stack(
        [flitsim.ASYMMETRIC_PARAMS[k] for k in keys], "cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("T,N,cycles", [(4, 1, 64), (3, 5, 96),
                                        (9, 6, 128)])
def test_symmetric_trace_plain_equals_reference(T, N, cycles):
    xs, ys, bls = _phases(T * N, T, N)
    rows = flitsim._trace_rows(_sym_stack(), tref.SYM_ROWS, _t(xs), _t(ys),
                               _t(bls))
    got = tref.symmetric_trace_compute(*rows, cycles=cycles).numpy()
    jp = jf.SymmetricFlitParams.stack([jf.SYMMETRIC_PARAMS[k]
                                       for k in SYM_KEYS])
    want = np.asarray(jf._symmetric_trace_grid(jp, xs, ys, bls,
                                               n_phases=N, cycles=cycles))
    assert got.shape == (N, len(SYM_KEYS) * T)
    np.testing.assert_allclose(got.reshape(N, len(SYM_KEYS), T),
                               np.moveaxis(want, -1, 0), rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,N,cycles", [(4, 1, 64), (3, 5, 96),
                                        (9, 6, 256)])
def test_asymmetric_trace_plain_equals_reference(T, N, cycles):
    xs, ys, _ = _phases(T + N, T, N)
    rows = flitsim._trace_rows(_asym_stack(), tref.ASYM_ROWS, _t(xs),
                               _t(ys))
    got = tref.asymmetric_trace_compute(*rows, cycles=cycles).numpy()
    jp = jf.AsymmetricLaneParams.stack([jf.ASYMMETRIC_PARAMS[k]
                                        for k in ASYM_KEYS])
    want = np.asarray(jf._asymmetric_trace_grid(jp, xs, ys, n_phases=N,
                                                cycles=cycles))
    np.testing.assert_allclose(got.reshape(N, len(ASYM_KEYS), T),
                               np.moveaxis(want, -1, 0), rtol=0, atol=ATOL)


def test_trace_rows_layout():
    """Cell ``p*T + t`` carries protocol ``p``'s parameter rows and trace
    ``t``'s phase rows; pad rows are zero."""
    xs, ys, bls = _phases(1, 4, 3)
    ps = _sym_stack()
    params, rx, ry, rb = flitsim._trace_rows(ps, tref.SYM_ROWS, _t(xs),
                                             _t(ys), _t(bls))
    assert params.shape == (tref.SYM_ROWS, 12) and rx.shape == (3, 12)
    for p in range(3):
        for t in range(4):
            c = p * 4 + t
            assert params[0, c] == ps.g_slots[p]
            assert params[10, c] == ps.write_buffer_lines[p]
            assert torch.equal(rx[:, c], _t(xs[t]))
            assert torch.equal(rb[:, c], _t(bls[t]))
    assert not params[11:].any()
    aparams, _, _ = flitsim._trace_rows(_asym_stack(), tref.ASYM_ROWS,
                                        _t(xs), _t(ys))
    assert aparams.shape == (tref.ASYM_ROWS, 8) and not aparams[6:].any()


@pytest.mark.parametrize("family", ["symmetric", "asymmetric"])
def test_runner_equals_cell_by_cell(family):
    """The runner's row layout and reshape: each (protocol, trace) cell of
    the grid run is bitwise the same cell run alone."""
    xs, ys, bls = _phases(3, 3, 4)
    if family == "symmetric":
        ps = _sym_stack()
        got = flitsim._run_symmetric_trace(ps, _t(xs), _t(ys), _t(bls), 64)
        one = lambda p, t: flitsim._run_symmetric_trace(
            flitsim._gather_cells(ps, np.array([p])), _t(xs[t:t + 1]),
            _t(ys[t:t + 1]), _t(bls[t:t + 1]), 64)
    else:
        ps = _asym_stack()
        got = flitsim._run_asymmetric_trace(ps, _t(xs), _t(ys), 64)
        one = lambda p, t: flitsim._run_asymmetric_trace(
            flitsim._gather_cells(ps, np.array([p])), _t(xs[t:t + 1]),
            _t(ys[t:t + 1]), 64)
    assert got.shape == (len(SYM_KEYS if family == "symmetric"
                             else ASYM_KEYS), 3, 4)
    for p in range(got.shape[0]):
        for t in range(3):
            assert torch.equal(got[p, t], one(p, t)[0, 0])
    assert flitsim.last_run_info()[f"flitsim.{family}.trace"]["engine"] \
        == "plain"


def test_one_phase_equals_fixed_grid():
    """A one-phase trace at the full horizon is the fixed engine's static
    cell, bit for bit, for both families."""
    x = _t(100.0 * np.linspace(0.0, 1.0, 11))
    b = _t([1.0, 3.0, 64.0])
    ps = _sym_stack()
    fixed = flitsim._symmetric_grid(ps, x, 100.0 - x, b, n_flits=512)
    xs = x.repeat(b.shape[0])[:, None]
    bs = b.repeat_interleave(x.shape[0])[:, None]
    got = flitsim._run_symmetric_trace(ps, xs, 100.0 - xs, bs, 512)
    assert torch.equal(got[..., 0].reshape(fixed.shape), fixed)
    pa = _asym_stack()
    fixed = flitsim._asymmetric_grid(pa, x, 100.0 - x, n_accesses=512)
    got = flitsim._run_asymmetric_trace(pa, x[:, None], 100.0 - x[:, None],
                                        512)
    assert torch.equal(got[..., 0], fixed)


def test_ragged_padding_keeps_each_trace():
    """Traces of 1-4 phases padded to one count: every trace's own phases
    are bitwise those of the trace run alone (padding only appends
    zero-duration phases after them)."""
    rng = np.random.default_rng(4)
    traces = [TrafficTrace(f"t{k}", (1.0,) * k,
                           tuple(rng.uniform(0, 1, k)),
                           tuple(rng.uniform(1, 32, k))) for k in (1, 4, 2)]
    padded = pad_traces(traces)
    grid = lambda ts, f: _t([[f(t)[n] for n in range(t.n_phases)]
                             for t in ts])
    rf = lambda t: [100.0 * r for r in t.read_fractions]
    wf = lambda t: [100.0 - 100.0 * r for r in t.read_fractions]
    bf = lambda t: list(t.backlogs)
    ps, pa = _sym_stack(), _asym_stack()
    sym = flitsim._run_symmetric_trace(ps, grid(padded, rf),
                                       grid(padded, wf), grid(padded, bf),
                                       64)
    asym = flitsim._run_asymmetric_trace(pa, grid(padded, rf),
                                         grid(padded, wf), 64)
    for i, t in enumerate(traces):
        n = t.n_phases
        alone = flitsim._run_symmetric_trace(ps, grid([t], rf),
                                             grid([t], wf), grid([t], bf),
                                             64)
        assert torch.equal(sym[:, i, :n], alone[:, 0])
        alone = flitsim._run_asymmetric_trace(pa, grid([t], rf),
                                              grid([t], wf), 64)
        assert torch.equal(asym[:, i, :n], alone[:, 0])


def test_ops_route_cpu_to_plain_and_count_nothing():
    xs, ys, bls = _phases(2, 2, 3)
    rows = flitsim._trace_rows(_sym_stack(), tref.SYM_ROWS, _t(xs), _t(ys),
                               _t(bls))
    arows = flitsim._trace_rows(_asym_stack(), tref.ASYM_ROWS, _t(xs),
                                _t(ys))
    ops.reset_launches()
    got = ops.symmetric_trace(*rows, cycles=32)
    assert torch.equal(got, tref.symmetric_trace_compute(*rows, cycles=32))
    got = ops.asymmetric_trace(*arows, cycles=32)
    assert torch.equal(got, tref.asymmetric_trace_compute(*arows,
                                                          cycles=32))
    assert ops.launches == {k: 0 for k in ops.launches}
    assert set(ops.TRACE_KERNELS) <= set(ops.launches)
    with pytest.raises(ValueError, match="no kernel"):
        ops.symmetric_trace(*[r.to("meta") for r in rows], cycles=32)
    with pytest.raises(ValueError, match="several devices"):
        ops.asymmetric_trace(arows[0].to("meta"), *arows[1:], cycles=32)


def test_trace_checks_refuse_bad_shapes():
    """The checks the CUDA path runs before it launches."""
    p = torch.zeros((tref.SYM_ROWS, 6))
    ph = torch.zeros((3, 6))
    ops._check_trace("t", p, tref.SYM_ROWS, 64, ph, ph, ph)
    with pytest.raises(ValueError, match="expected shape"):
        ops._check_trace("t", p, tref.SYM_ROWS, 64, ph, ph[:2], ph)
    with pytest.raises(ValueError, match="expected shape"):
        ops._check_trace("t", p[:8], tref.SYM_ROWS, 64, ph, ph, ph)
    with pytest.raises(ValueError, match="cycles"):
        ops._check_trace("t", p, tref.SYM_ROWS, 0, ph, ph, ph)
    with pytest.raises(ValueError, match="phase"):
        ops._check_trace("t", p, tref.SYM_ROWS, 8, ph[:0], ph[:0], ph[:0])
