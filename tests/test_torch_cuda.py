"""The port's CUDA kernels on the card: each flit kernel bitwise equal to
its plain version (the run kernels, whole adaptive runs in one launch, to
the plain run's state rows, first converged chunks and exit chunk), the
flash-attention kernels within tolerance of their
plain version (the f32 CUDA-core kernel: atol 3e-5, rtol 1e-4; the bf16
tensor-core kernel: one output ulp, atol 4e-3, rtol 2^-7, at head dims 16
to 256, ragged Sq and Skv, Sq = 1, windows, offsets, MQA and GQA, one and
two warpgroups a block, and the element-load path for hd % 8 != 0),
the decode-attention kernels within tolerance of their plain version
(bf16: one ulp of each output element and one of the largest, rtol and
atol 2^-7; f32: 2^-16 of each; only the f32 sums' order differs) at the
serving cells' and the other families' shapes, each call repeated bit
for bit, its refusals, and a decode step through it (its launches and
counters, no f32 cache copy, one sync a layer in attention), the
trace-scan kernels bitwise to their plain versions (at the serving
frontier's shape, one phase against the fixed engine, ragged phase
counts, cells that take the IEEE rerun and 1026 cells),
the RG-LRU scan bitwise and the SSD scan within the reference's
tolerance (atol 5e-5, rtol 1e-4; at the edges of its chunk at full width,
1e-4 of the largest value), the launch counters, the bridge, the
Fig-13 design space and reduced LM serving on the card; the kernels'
``torch.autograd.Function``s against autograd of their plain versions (f32
gradients within 1e-5 of the largest, the CPU tests' atol scaled to the
gradient's size) and a reduced training step of every family on the card
(every gradient leaf finite and non-zero, the loss within 8 bf16
epsilons of the CPU's, the launches of a rematerialized step).  Marked
``cuda``: they skip where there is no card (as on a CPU-only machine) and
run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none."""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.core import flitsim
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.core.space import ADAPTIVE_SIM, DesignSpace, axis
from repro_torch.kernels.flit_pack import ops as pack_ops
from repro_torch.kernels.flit_pack import ref as pack_ref
from repro_torch.kernels.flit_sim import ops, ref
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan import ref as lru_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models import build
from repro_torch.runtime import spans
from repro_torch.serve import Request, ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sym_rows(dev, backlogs, n=21):
    ps = flitsim.SymmetricFlitParams.stack(
        list(flitsim.SYMMETRIC_PARAMS.values()), dev)
    x = 100.0 * torch.linspace(0, 1, n, device=dev)
    return flitsim._sym_param_rows(
        ps, x, 100.0 - x, torch.tensor(backlogs, device=dev))


def test_periodic_kernels_equal_plain(dev):
    ps = flitsim.AsymmetricLaneParams.stack(
        list(flitsim.ASYMMETRIC_PARAMS.values()), dev)
    x = 100.0 * torch.rand(301, device=dev, generator=None)
    rows = flitsim._asym_param_rows(ps, x, 100.0 - x)
    ops.reset_launches()
    got = ops.asymmetric_periodic(rows, n_accesses=4096)
    assert ops.launches["asymmetric_periodic"] == 1
    assert torch.equal(got, ref.asymmetric_periodic_compute(
        rows, n_accesses=4096))
    rows = _sym_rows(dev, [0.5, 1.0, 2.0, 4.0])
    got = ops.symmetric_periodic(rows, n_flits=2048)
    assert torch.equal(got, ref.symmetric_periodic_compute(rows,
                                                           n_flits=2048))
    assert ops.launches["symmetric_periodic"] == 1


#: the planted cells of tests/test_torch_flit_sim_kernels.py (which says
#: how they were found and holds each on its branch of the detectors'
#: replay on the CPU): symmetric (protocol, scaled fields, read fraction,
#: backlog) and asymmetric read fractions
SYM_PLANTED = (("cxl_unopt", {}, 0.5, 2.0), ("cxl_unopt", {}, 0.44, 1.0),
               ("cxl_unopt", {}, 0.0625, 0.25),
               ("cxl_unopt", {}, 0.78125, 4.0),
               ("chi", {"credit_lines": 2.0}, 0.5, 32.0),
               ("cxl_opt", {"reqs_per_g": 0.5}, 1.0, 4.0),
               ("cxl_unopt", {}, 0.03125, 0.25))
ASYM_PLANTED = (0.0, 2.0 / 7.0, 3.0 / 32.0, 5.0 / 64.0,
                (220.0 * np.sqrt(2.0)) % 1.0, 1.0 / np.sqrt(2.0), 1.0 / 65.0)


def _asym_rows(dev, fracs):
    ps = flitsim.AsymmetricLaneParams.stack(
        list(flitsim.ASYMMETRIC_PARAMS.values()), dev)
    x = torch.as_tensor(100.0 * np.asarray(fracs), dtype=torch.float32,
                        device=dev)
    return flitsim._asym_param_rows(ps, x, 100.0 - x)


def _periodic_case(dev, case):
    """(symmetric rows, asymmetric rows or None) of a periodic case."""
    if case == "planted":
        rows = np.zeros((ref.SYM_ROWS, len(SYM_PLANTED)), np.float32)
        for c, (key, pert, frac, backlog) in enumerate(SYM_PLANTED):
            p = flitsim.SYMMETRIC_PARAMS[key].perturbed(pert)
            x = np.float32(100.0 * frac)
            rows[:11, c] = [float(getattr(p, f.name))
                            for f in dataclasses.fields(p)]
            rows[11:14, c] = [x, np.float32(100.0) - x, backlog]
        return torch.as_tensor(rows, device=dev), _asym_rows(dev,
                                                             ASYM_PLANTED)
    if case == "out of range":
        return _out_of_range_sym(_sym_rows(dev, [1.0, 2.0, 4.0])), None
    n = int(case.split()[0])
    sym = _sym_rows(dev, [0.25, 0.5, 1.0, 2.0, 4.0], n=69)[:, :n]
    asym = _asym_rows(dev, np.linspace(0.0, 1.0, 513))[:, :n]
    return sym.contiguous(), asym.contiguous()


@pytest.mark.parametrize("case", ["planted", "out of range", "1 cell",
                                  "31 cells", "33 cells", "189 cells",
                                  "1025 cells"])
def test_periodic_kernels_bitwise(dev, case):
    """Both periodic detectors bit for bit equal to their plain versions
    on the planted cells, on cells whose divisions leave the reciprocal
    division's range (the symmetric detector's passes run again with the
    IEEE division), and across the ragged edge of the spread launch."""
    sym, asym = _periodic_case(dev, case)
    ops.reset_launches()
    got = ops.symmetric_periodic(sym, n_flits=2048)
    assert ops.launches["symmetric_periodic"] == 1
    assert _same_bits(got, ref.symmetric_periodic_compute(sym,
                                                          n_flits=2048))
    if case == "planted":
        assert got[2].tolist() == [1.0, 25.0, 64.0, 0.0, 1.0, 12.0, 0.0]
    if asym is not None:
        for n_accesses in (4096, 1000):
            got = ops.asymmetric_periodic(asym, n_accesses=n_accesses)
            assert _same_bits(got, ref.asymmetric_periodic_compute(
                asym, n_accesses=n_accesses)), n_accesses
        assert ops.launches["asymmetric_periodic"] == 2


def test_chunk_kernel_equal_plain_over_a_run(dev):
    rows = _sym_rows(dev, [2.0, 8.0, 64.0])
    cells = rows.shape[1]
    state = torch.zeros((ref.SYM_ROWS, cells), device=dev)
    rng = np.random.default_rng(3)
    for k in range(1, 5):
        hist = torch.as_tensor(rng.uniform(0, 50, (ref.SYM_ROWS, cells)),
                               dtype=torch.float32, device=dev)
        scal = flitsim._scal_row([k, max(k - 4, (k + 1) // 2), k, 4, 16,
                                  128, 1e-3, 1.0, 0.0, 2.0], dev)
        got = ops.symmetric_chunk(rows, state, hist, scal, chunk=128)
        want = ref.symmetric_chunk_compute(rows, state, hist, scal,
                                           chunk=128)
        assert torch.equal(got, want), k
        state = want


def test_wrappers_reject_bad_operands(dev):
    rows = _sym_rows(dev, [2.0])
    with pytest.raises(ValueError, match="f32"):
        ops.symmetric_periodic(rows.double(), n_flits=2048)
    with pytest.raises(ValueError, match="shape"):
        ops.symmetric_periodic(rows[:8].contiguous(), n_flits=2048)
    with pytest.raises(ValueError, match="several devices"):
        ops.symmetric_chunk(rows, rows.cpu(), rows, rows[:1], chunk=8)
    with pytest.raises(ValueError, match="shape"):
        ops.symmetric_run(rows[:8].contiguous(), K=4, chunk=8, tol=1e-3,
                          budget=0)
    with pytest.raises(ValueError, match="K >= 1"):
        ops.pipelining_run(rows, K=0, chunk=8, tol=1e-3, n_lines=8)


def _perturbed_rows(dev, cells):
    """Symmetric rows of the three protocols under eight perturbations of
    the step's divisors and limits by factors that are not round numbers,
    over 4 backlogs and enough read fractions for ``cells`` cells."""
    rng = np.random.default_rng(18)
    perts = [{f: float(v) for f, v in zip(
        ("data_slots_per_line", "reqs_per_g", "resps_per_g",
         "credit_lines"), rng.uniform(0.7, 1.4, 4))} for _ in range(8)]
    ps = flitsim.SymmetricFlitParams.stack(
        [p.perturbed(q) for q in perts
         for p in flitsim.SYMMETRIC_PARAMS.values()], dev)
    n = -(-cells // (4 * 24))
    x = 100.0 * torch.linspace(0, 1, n, device=dev)
    rows = flitsim._sym_param_rows(ps, x, 100.0 - x,
                                   torch.tensor([2.0, 8.0, 24.0, 64.0],
                                                device=dev))
    return rows[:, :cells].contiguous()


def _out_of_range_sym(rows):
    """``rows`` with cells planted whose divisions leave the range where
    the run kernels' reciprocal division is exact ([2^-50, 2^50], no -0),
    so that their chunks run again with the IEEE division: the divisor
    data_slots_per_line below and above it, credit_r's dividend below and
    above it, credit_w's below it, reqs_per_g and resps_per_g above it, a
    quotient below the normal range (credit_lines x 2^-105 over
    data_slots_per_line x 2^28), and a -0 dividend (sent_req x rq_elig
    with a negative header capacity at read fraction 0, column 21)."""
    rows = rows.clone()
    rows[6, 1] *= 2.0 ** -60
    rows[6, 2] *= 2.0 ** 60
    rows[9, 3] *= 2.0 ** -70
    rows[9, 4] *= 2.0 ** 60
    rows[10, 5] *= 2.0 ** -70
    rows[4, 6] = 2.0 ** 60
    rows[5, 7] = 2.0 ** 60
    rows[9, 8] *= 2.0 ** -105
    rows[6, 8] *= 2.0 ** 28
    rows[4, 21] = -1.0
    return rows


def _out_of_range_pipe(rows):
    """``rows`` with the modulo's divisor k planted above and below the
    range of :func:`_out_of_range_sym`."""
    rows = rows.clone()
    rows[0, 0] = 2.0 ** 60
    rows[0, 1] = 2.0 ** -60
    return rows


def _same_bits(a, b):
    """Equal bit for bit, -0 and +0 told apart."""
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _sym_run_case(dev, case):
    """(rows, K, chunk, tol) of a symmetric run case."""
    if case == "out of range":
        return (_out_of_range_sym(_sym_rows(dev, [2.0, 8.0, 64.0])), 16, 128,
                1e-3)
    if case == "1 cell":
        return _sym_rows(dev, [8.0])[:, 5:6].contiguous(), 16, 128, 1e-3
    if case == "189 cells":
        return _sym_rows(dev, [2.0, 8.0, 64.0]), 16, 128, 1e-3
    if case == "1025 cells":
        return (_sym_rows(dev, [2.0, 8.0, 32.0, 64.0, 128.0], n=69)[:, :1025]
                .contiguous(), 16, 128, 1e-3)
    if case == "perturbed 2^16":
        return _perturbed_rows(dev, 1 << 16), 16, 128, 1e-3
    if case == "stragglers":
        return _sym_rows(dev, [16.0, 32.0, 64.0], n=43), 16, 128, 1e-3
    assert case == "chunk 8"
    return _sym_rows(dev, [2.0, 8.0, 64.0], n=9), 8, 8, 1e-3


def _assert_runs_equal(got, want, *, bits=False):
    for name, a, b in zip(("state rows", "conv_at", "exit chunk"), got,
                          want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        if bits:
            assert _same_bits(a, b), name


@pytest.mark.parametrize("case", ["1 cell", "189 cells", "1025 cells",
                                  "perturbed 2^16", "stragglers",
                                  "chunk 8", "out of range"])
def test_symmetric_run_equal_plain(dev, case):
    rows, K, chunk, tol = _sym_run_case(dev, case)
    budget = flitsim._escalation_budget(rows.shape[1], chunk, K * chunk)
    ops.reset_launches()
    got = ops.symmetric_run(rows, K=K, chunk=chunk, tol=tol, budget=budget)
    assert ops.launches["symmetric_run"] == 1
    want = ref.symmetric_run_compute(rows, K=K, chunk=chunk, tol=tol,
                                     budget=budget)
    _assert_runs_equal(got, want, bits=case == "out of range")
    if case == "stragglers":
        assert budget > 0 and int((got[0][11] < 0.5).sum()) > 0


@pytest.mark.parametrize("case", ["1 cell", "48 cells", "1025 cells",
                                  "chunk 8", "out of range"])
def test_pipelining_run_equal_plain(dev, case):
    ks, us, ds, K, chunk = {
        "1 cell": ((3,), (8.0,), (32.0,), 8, 64),
        "48 cells": (range(1, 9), (8.0, 16.0), (16.0, 32.0, 64.0), 8, 64),
        "out of range": (range(1, 9), (8.0, 16.0), (16.0, 32.0, 64.0), 8,
                         64),
        "1025 cells": (range(1, 9), (8.0, 11.0, 16.0, 23.0),
                       np.linspace(8.0, 96.0, 33), 8, 64),
        "chunk 8": (range(1, 9), (8.0, 13.0), (16.0, 37.0, 64.0), 8, 8),
    }[case]
    rows = flitsim._pipe_param_rows(
        torch.as_tensor(list(ks), device=dev),
        torch.as_tensor(us, dtype=torch.float32, device=dev),
        torch.as_tensor(ds, dtype=torch.float32, device=dev))
    if case == "1025 cells":
        rows = rows[:, :1025].contiguous()
    if case == "out of range":
        rows = _out_of_range_pipe(rows)
    ops.reset_launches()
    got = ops.pipelining_run(rows, K=K, chunk=chunk, tol=1e-3,
                             n_lines=K * chunk)
    assert ops.launches["pipelining_run"] == 1
    _assert_runs_equal(got, ref.pipelining_run_compute(
        rows, K=K, chunk=chunk, tol=1e-3, n_lines=K * chunk),
        bits=case == "out of range")


def test_chunk_kernels_equal_plain_out_of_range(dev):
    """The one-chunk kernels on the cells of :func:`_out_of_range_sym` and
    :func:`_out_of_range_pipe`, and on pipelining states whose line index
    (the modulo's dividend) is -0, 2^-60 or 2^55: chunk after chunk, bit
    for bit."""
    rows = _out_of_range_sym(_sym_rows(dev, [2.0, 8.0, 64.0]))
    cells = rows.shape[1]
    state = torch.zeros((ref.SYM_ROWS, cells), device=dev)
    rng = np.random.default_rng(5)
    for k in range(1, 5):
        hist = torch.as_tensor(rng.uniform(0, 50, (ref.SYM_ROWS, cells)),
                               dtype=torch.float32, device=dev)
        scal = flitsim._scal_row([k, max(k - 4, (k + 1) // 2), k, 4, 16,
                                  128, 1e-3, 1.0, 0.0, 2.0], dev)
        got = ops.symmetric_chunk(rows, state, hist, scal, chunk=128)
        want = ref.symmetric_chunk_compute(rows, state, hist, scal,
                                           chunk=128)
        assert _same_bits(got, want), k
        state = want
    params = _out_of_range_pipe(flitsim._pipe_param_rows(
        torch.arange(1, 9, device=dev), torch.tensor([8.0, 13.0], device=dev),
        torch.tensor([16.0, 37.0, 64.0], device=dev)))
    cells = params.shape[1]
    state = torch.zeros((ref.PIPE_ROWS, cells), device=dev)
    state[9, 2:5] = torch.tensor([-0.0, 2.0 ** -60, 2.0 ** 55], device=dev)
    hist = torch.zeros((ref.ASYM_ROWS, cells), device=dev)
    for k in range(1, 5):
        scal = flitsim._scal_row([k, 8, 64, 1e-3, 1.0 if k >= 4 else 0.0,
                                  0.0, 512], dev)
        got = ops.pipelining_chunk(params, state, hist, scal, chunk=64)
        want = ref.pipelining_chunk_compute(params, state, hist, scal,
                                            chunk=64)
        assert _same_bits(got, want), k
        state = want
        if k == 1:
            hist = torch.cat([state[8:9], torch.zeros((7, cells),
                                                      device=dev)])


def test_cell_division_equals_ieee(dev):
    """The run kernels' divisions (by a constant of the cell, and by the
    varying tot_q) equal the IEEE quotient for every significand of the
    dividend, at the divisors of the catalog's protocols, perturbed ones
    and 4096 random ones (``chip_smoke.py`` runs all 2^23)."""
    from repro_torch.kernels.flit_sim import kernel
    ps = flitsim.SymmetricFlitParams.stack(
        list(flitsim.SYMMETRIC_PARAMS.values()), "cpu")
    fixed = torch.cat([ps.data_slots_per_line, ps.reqs_per_g.clamp_min(1e-9),
                       ps.resps_per_g.clamp_min(1e-9),
                       torch.arange(1, 9, dtype=torch.float32),
                       _perturbed_rows("cpu", 96)[[4, 5, 6]].reshape(-1)
                       .clamp_min(1e-9)])
    rng = np.random.default_rng(7)
    rand = torch.as_tensor(rng.uniform(1e-3, 1e3, 4096), dtype=torch.float32)
    d = torch.cat([fixed, rand]).view(torch.int32).to(dev)
    for varying in (False, True):
        assert kernel.division_check(d, varying=varying) == 0, varying


def test_bridge_on_card_meets_golden(dev):
    sys.path.insert(0, str(ROOT / "tools"))
    from design_space_summary import summarize
    from repro_torch import explorer
    runs = []
    fused = flitsim._run_symmetric_fused

    def counted(*a, **kw):
        runs.append(1)
        return fused(*a, **kw)
    ops.reset_launches()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flitsim, "_run_symmetric_fused", counted)
        ds = explorer.bridge_mode(device=dev, verbose=False)
    assert ops.launches["asymmetric_periodic"] > 0
    # one launch per adaptive symmetric run, no one-chunk launch
    assert len(runs) == 2 and ops.launches["symmetric_run"] == len(runs)
    assert ops.launches["symmetric_chunk"] == 0
    # the serving section: one launch of each trace kernel
    assert ops.launches["symmetric_trace"] == 1
    assert ops.launches["asymmetric_trace"] == 1
    assert ds["serving_frontier"]["launches"] == {"symmetric_trace": 1,
                                                  "asymmetric_trace": 1}
    golden = json.loads(
        (ROOT / "experiments/golden/design_space_summary.json").read_text())
    assert summarize(ds) == golden


def _trace_grids(dev, case):
    """``(xs, ys, bls [T, N] on dev, symmetric cycles, asymmetric
    cycles)`` of a trace-kernel case."""
    from repro_torch.traces import (DEFAULT_MODELS, DEFAULT_QPS,
                                    ModelTrafficSpec, TrafficTrace,
                                    pad_traces, synthetic_serving_trace)
    rng = np.random.default_rng(20)
    if case == "frontier":
        traces = [synthetic_serving_trace(ModelTrafficSpec.from_name(m),
                                          qps=q, name=f"{m}@q{q:g}")
                  for m in DEFAULT_MODELS for q in DEFAULT_QPS]
        cycles = (2048, 4096)
    elif case == "ragged":
        traces = pad_traces([TrafficTrace(
            f"t{i}", (1.0,) * k, tuple(rng.uniform(0, 1, k)),
            tuple(rng.uniform(1, 128, k)))
            for i, k in enumerate((1, 5, 2, 3, 4, 1, 5))])
        cycles = (256, 256)
    else:
        T, N = {"one phase": (33, 1), "out of range": (24, 3),
                "1026 cells": (342, 4)}[case]
        traces = [TrafficTrace(f"t{i}", (1.0,) * N,
                               tuple(rng.uniform(0, 1, N)),
                               tuple(rng.uniform(1, 128, N)))
                  for i in range(T)]
        cycles = (512, 512) if case == "one phase" else (256, 256)
    xs = torch.tensor([[100.0 * r for r in t.read_fractions]
                       for t in traces], device=dev)
    bls = torch.tensor([list(t.backlogs) for t in traces], device=dev)
    return (xs, 100.0 - xs, bls) + cycles


@pytest.mark.parametrize("case", ["frontier", "one phase", "ragged",
                                  "out of range", "1026 cells"])
def test_trace_kernels_equal_plain(dev, case):
    """Each trace kernel against its plain version, bit for bit, one launch
    each; a one-phase trace also against the fixed engine's static cell;
    planted cells (``_out_of_range_sym``) run their trace again with the
    IEEE division."""
    xs, ys, bls, c_sym, c_asym = _trace_grids(dev, case)
    ps = flitsim.SymmetricFlitParams.stack(
        list(flitsim.SYMMETRIC_PARAMS.values()), dev)
    pa = flitsim.AsymmetricLaneParams.stack(
        list(flitsim.ASYMMETRIC_PARAMS.values()), dev)
    rows = flitsim._trace_rows(ps, ref.SYM_ROWS, xs, ys, bls)
    if case == "out of range":
        rows = (_out_of_range_sym(rows[0]),) + rows[1:]
    arows = flitsim._trace_rows(pa, ref.ASYM_ROWS, xs, ys)
    ops.reset_launches()
    got = ops.symmetric_trace(*rows, cycles=c_sym)
    agot = ops.asymmetric_trace(*arows, cycles=c_asym)
    assert ops.launches["symmetric_trace"] == 1
    assert ops.launches["asymmetric_trace"] == 1
    assert _same_bits(got, ref.symmetric_trace_compute(*rows, cycles=c_sym))
    assert _same_bits(agot, ref.asymmetric_trace_compute(*arows,
                                                         cycles=c_asym))
    assert got.shape == (xs.shape[1], 3 * xs.shape[0])
    if case == "one phase":
        fixed = flitsim._symmetric_grid(ps, xs[:, 0], ys[:, 0], bls[:, 0],
                                        n_flits=c_sym)   # [P, T, T]
        diag = torch.diagonal(fixed, dim1=1, dim2=2).reshape(-1)
        assert torch.equal(got[0], diag)
        fixed = flitsim._asymmetric_grid(pa, xs[:, 0], ys[:, 0],
                                         n_accesses=c_asym)
        assert torch.equal(agot[0], fixed.reshape(-1))


def test_trace_wrappers_reject_bad_operands(dev):
    xs, ys, bls, _, _ = _trace_grids(dev, "one phase")
    ps = flitsim.SymmetricFlitParams.stack(
        list(flitsim.SYMMETRIC_PARAMS.values()), dev)
    params, rx, ry, rb = flitsim._trace_rows(ps, ref.SYM_ROWS, xs, ys, bls)
    with pytest.raises(ValueError, match="expected shape"):
        ops.symmetric_trace(params[:8].contiguous(), rx, ry, rb, cycles=8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.symmetric_trace(params, rx, torch.stack([ry, ry], -1)[..., 0],
                            rb, cycles=8)
    with pytest.raises(ValueError, match="cycles"):
        ops.symmetric_trace(params, rx, ry, rb, cycles=0)
    with pytest.raises(ValueError, match="several devices"):
        ops.symmetric_trace(params.cpu(), rx, ry, rb, cycles=8)


def test_pipelining_chunk_equal_plain_over_a_run(dev):
    params = flitsim._pipe_param_rows(
        torch.arange(1, 9, device=dev), torch.tensor([8.0, 13.0], device=dev),
        torch.tensor([16.0, 37.0, 64.0], device=dev))
    cells = params.shape[1]
    state = torch.zeros((ref.PIPE_ROWS, cells), device=dev)
    hist = torch.zeros((ref.ASYM_ROWS, cells), device=dev)
    ops.reset_launches()
    for k in range(1, 9):
        scal = flitsim._scal_row([k, 8, 64, 1e-3, 1.0 if k >= 4 else 0.0,
                                  1.0 if k >= 8 else 0.0, 512], dev)
        got = ops.pipelining_chunk(params, state, hist, scal, chunk=64)
        want = ref.pipelining_chunk_compute(params, state, hist, scal,
                                            chunk=64)
        assert torch.equal(got, want), k
        state = want
        if k == 1:
            hist = torch.cat([state[8:9], torch.zeros((7, cells),
                                                      device=dev)])
    assert ops.launches["pipelining_chunk"] == 8


@pytest.mark.parametrize("n", [1, 15, 64, 1000])
def test_pack_flits_equal_plain_and_round_trips(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    f = pack_ref.flits_needed(n)
    args = [torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.int32)
            for shape in ((n, 64), (f, 10), (f, 4))]
    pack_ops.reset_launches()
    got = pack_ops.pack(*args)
    assert pack_ops.launches["pack_flits"] == 1
    assert torch.equal(got, pack_ref.pack_flits_ref(*args))
    lines, headers, meta, ok = pack_ops.unpack(got, n)
    assert bool(ok.all())
    for a, b in zip((lines, headers, meta), args):
        assert torch.equal(a, b)


def test_fig13_on_card_matches_cpu(dev):
    axes = [axis("k", range(1, 9)), axis("ucie_line_ui", (8, 16)),
            axis("device_line_ui", (16, 32, 64))]
    ops.reset_launches()
    card = DesignSpace(axes, sim=ADAPTIVE_SIM, device=dev).evaluate()
    assert ops.launches["pipelining_run"] == 1      # one adaptive run
    assert ops.launches["pipelining_chunk"] == 0
    cpu = DesignSpace(axes, sim=ADAPTIVE_SIM, device="cpu").evaluate()
    np.testing.assert_allclose(card["utilization"].values,
                               cpu["utilization"].values, atol=1e-6, rtol=0)
    assert abs(flitsim.simulate_lpddr6_pipelining(4, device=dev) - 1.0) \
        <= 1e-3


@pytest.mark.parametrize("b,k,g,sq,skv,hd,causal,window,off,dtype", [
    (2, 2, 3, 128, 128, 64, True, 0, 0, torch.float32),
    (1, 1, 2, 64, 192, 64, True, 0, 128, torch.float32),
    (1, 2, 2, 128, 128, 64, True, 16, 0, torch.float32),
    (2, 1, 1, 64, 160, 64, False, 0, 0, torch.float32),
    (1, 2, 2, 100, 300, 16, True, 0, 200, torch.float32),
    (1, 1, 10, 300, 300, 256, True, 64, 0, torch.bfloat16),
    (1, 5, 3, 77, 77, 64, True, 0, 0, torch.bfloat16),
    (1, 1, 4, 33, 97, 96, True, 40, 64, torch.bfloat16),
    # the tensor-core kernel: hd 16 (zero-padded to 64), ragged Sq and Skv
    (1, 2, 2, 100, 300, 16, True, 0, 200, torch.bfloat16),
    # hd 128, GQA G = 3, two batches, Sq = Skv = 130
    (2, 2, 3, 130, 130, 128, True, 0, 0, torch.bfloat16),
    # Sq = 1: MQA G = 10 at hd 256, and one query against 200 keys
    (1, 1, 10, 1, 1, 256, True, 2048, 0, torch.bfloat16),
    (1, 1, 2, 1, 200, 64, True, 0, 199, torch.bfloat16),
    # non-causal cross attention, ragged Skv
    (2, 1, 1, 64, 160, 64, False, 0, 0, torch.bfloat16),
    (1, 3, 1, 65, 129, 96, False, 0, 0, torch.bfloat16),
    # q_offset with a window edge inside a tile; whole tiles below the
    # window masked for some rows and skipped for the others
    (1, 1, 10, 200, 700, 256, True, 100, 500, torch.bfloat16),
    (1, 1, 1, 500, 500, 128, True, 70, 0, torch.bfloat16),
    (1, 2, 3, 257, 257, 256, True, 0, 0, torch.bfloat16),
    # two warpgroups a block (the grid fills the card): G = 4 pairs the
    # same rows, G = 3 pairs query tiles of different reach
    (2, 2, 4, 1100, 1100, 64, True, 0, 0, torch.bfloat16),
    (2, 4, 3, 1000, 1000, 128, True, 300, 0, torch.bfloat16),
    # head dims that are not a multiple of 8: element loads, odd stores
    (1, 1, 2, 100, 100, 20, True, 0, 0, torch.bfloat16),
    (1, 1, 2, 50, 50, 33, True, 0, 0, torch.bfloat16),
    # the moe, vision and enc-dec families: llama4-scout's GQA at hd 128,
    # internvl2-1b's 256 patches + 40 tokens, seamless-m4t-large-v2's
    # non-causal encoder (37 frames) and cross attention (Sq < 64 < Skv,
    # Skv not a multiple of 64)
    (1, 8, 5, 300, 300, 128, True, 0, 0, torch.bfloat16),
    (1, 2, 7, 296, 296, 64, True, 0, 0, torch.bfloat16),
    (1, 16, 1, 37, 37, 64, False, 0, 0, torch.bfloat16),
    (1, 16, 1, 40, 1000, 64, False, 0, 0, torch.bfloat16),
])
def test_flash_attention_close_to_plain(dev, b, k, g, sq, skv, hd, causal,
                                        window, off, dtype):
    gen = torch.Generator(device=dev).manual_seed(sq + skv + hd)
    q, kk, v = [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in ((b, k, g, sq, hd), (b, k, skv, hd),
                          (b, k, skv, hd))]
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, kk, v, causal, window, off)
    assert fa_ops.launches["flash_attention_fwd"] == 1
    want = fa_ref.attention_ref(q, kk, v, causal=causal, window=window,
                                q_offset=off)
    assert got.dtype == dtype
    tol = dict(atol=3e-5, rtol=1e-4) if dtype == torch.float32 else \
        dict(atol=4e-3, rtol=2.0 ** -7)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("shape,offset", [
    ((1, 7, 2560), 0), ((1, 2304, 2560), 0), ((1, 2305, 2560), 0),
    ((4, 4096, 2560), 0), ((2, 300, 37), 0), ((1, 129, 12), 0),
    ((3, 77, 40), 0), ((2, 1, 8), 0), ((1, 256, 2560), 1)])
def test_rglru_scan_equal_plain(dev, shape, offset):
    """Bitwise at the serving shapes, a tail tile (2305 steps), C % 4 != 0
    (cp.async copies), C below one block's width, one step, and a view one
    element into its storage (not 16-byte aligned: cp.async)."""
    gen = torch.Generator(device=dev).manual_seed(shape[1])
    n = shape[0] * shape[1] * shape[2]
    log_a = (-torch.rand(n + offset, generator=gen, device=dev)
             * 2.0)[offset:].view(shape)
    b = torch.randn(n + offset, generator=gen, device=dev)[offset:].view(
        shape)
    assert log_a.storage_offset() == offset and b.is_contiguous()
    lru_ops.reset_launches()
    got = lru_ops.lru(log_a, b)
    assert lru_ops.launches["rglru_scan"] == 1
    assert torch.equal(got, lru_ref.lru_ref(log_a, b))


@pytest.mark.parametrize("bsz,s,h,p,n,chunk", [
    (2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32), (2, 96, 3, 16, 8, 32),
    (1, 64, 1, 64, 32, 64), (1, 7, 80, 64, 128, 256),
    (1, 300, 8, 64, 128, 256), (2, 100, 3, 80, 16, 32)])
def test_ssd_scan_close_to_plain(dev, bsz, s, h, p, n, chunk):
    """tests/test_kernels.py's shapes, mamba2-2.7b's launcher prompt, a
    ragged 300 steps and a P that is not a multiple of the kernel's
    64-column tile, against both plain versions at the reference's atol
    5e-5 / rtol 1e-4."""
    gen = torch.Generator(device=dev).manual_seed(s + h)
    x = torch.randn((bsz, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, s, h), generator=gen, device=dev))
    b = torch.randn((bsz, s, n), generator=gen, device=dev) * 0.5
    c = torch.randn((bsz, s, n), generator=gen, device=dev) * 0.5
    a_log = torch.randn((h,), generator=gen, device=dev) * 0.3
    ssd_ops.reset_launches()
    y, fs = ssd_ops.ssd(x, dt, b, c, a_log, chunk)
    assert ssd_ops.launches["ssd_scan"] == 1
    for want in (ssd_ref.ssd_ref(x, dt, b, c, a_log),
                 ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log,
                             min(chunk, s))):
        torch.testing.assert_close(y, want[0], atol=5e-5, rtol=1e-4)
        torch.testing.assert_close(fs, want[1], atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("bsz,s,h,p,n,init", [
    (2, 96, 3, 16, 8, False), (2, 96, 3, 16, 8, True),
    (1, 7, 80, 64, 128, True), (1, 300, 8, 64, 128, False),
    (1, 300, 8, 64, 128, True)])
def test_ssd_scan_slow_decay_and_initial_state_close_to_plain(
        dev, bsz, s, h, p, n, init):
    """dt = softplus(N(0, 1) - 5), about 0.011, so the kernel's 64-step
    chunk decays by about 0.5 and the state it carries to the next chunk
    counts; with and without a given initial state; against both plain
    versions at the reference's atol 5e-5 / rtol 1e-4."""
    gen = torch.Generator(device=dev).manual_seed(s + h + 1)
    x = torch.randn((bsz, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, s, h), generator=gen, device=dev) - 5.0)
    b = torch.randn((bsz, s, n), generator=gen, device=dev) * 0.5
    c = torch.randn((bsz, s, n), generator=gen, device=dev) * 0.5
    a_log = torch.randn((h,), generator=gen, device=dev) * 0.3
    s0 = (torch.randn((bsz, h, p, n), generator=gen, device=dev)
          if init else None)
    ssd_ops.reset_launches()
    y, fs = ssd_ops.ssd(x, dt, b, c, a_log, 64, init_state=s0)
    assert ssd_ops.launches["ssd_scan"] == 1
    for want in (ssd_ref.ssd_ref(x, dt, b, c, a_log, init_state=s0),
                 ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log,
                             min(64, s), init_state=s0)):
        torch.testing.assert_close(y, want[0], atol=5e-5, rtol=1e-4)
        torch.testing.assert_close(fs, want[1], atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("bsz,s,p,n,slow,init", [
    (1, 1, 64, 128, False, False), (1, 16, 64, 128, False, True),
    (1, 17, 64, 128, False, False), (1, 127, 64, 128, False, False),
    (1, 128, 64, 128, False, False), (1, 129, 64, 128, False, True),
    (1, 389, 64, 128, False, False), (1, 389, 64, 16, False, False),
    (1, 389, 64, 32, True, False), (1, 389, 80, 128, False, True),
    (4, 300, 64, 128, True, True), (1, 77, 18, 10, False, True),
    (2, 11, 18, 10, True, True)])
def test_ssd_scan_chunk_edges_close_to_plain(dev, bsz, s, p, n, slow, init):
    """mamba2-2.7b's 80 heads at the edges of the kernel's 128-step chunk
    (1, Q - 1, Q, Q + 1 and 3 Q + 5 steps) and of its one-launch path for
    short prompts (16, 17 steps), N 16 and 32, P 80 (a 64-column tile and a
    ragged one), four rows under a slow decay from a given state, and P 18
    with N 10 (rows not of whole 16 bytes: the 4-byte copies): against
    both plain versions within 1e-4 of the largest |y| and |state|
    (chip_smoke.py's SSD_REL for its full-width cases: at this width the
    two plain versions part by more than atol 5e-5 / rtol 1e-4 elementwise
    from 389 steps on)."""
    h = 80
    gen = torch.Generator(device=dev).manual_seed(s + p + n)
    x = torch.randn((bsz, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, s, h), generator=gen, device=dev)
        - (5.0 if slow else 0.0))
    b = torch.randn((bsz, s, n), generator=gen, device=dev) * 0.5
    c = torch.randn((bsz, s, n), generator=gen, device=dev) * 0.5
    a_log = torch.randn((h,), generator=gen, device=dev) * 0.3
    s0 = (torch.randn((bsz, h, p, n), generator=gen, device=dev)
          if init else None)
    ssd_ops.reset_launches()
    y, fs = ssd_ops.ssd(x, dt, b, c, a_log, 256, init_state=s0)
    assert ssd_ops.launches["ssd_scan"] == 1
    for want in (ssd_ref.ssd_ref(x, dt, b, c, a_log, init_state=s0),
                 ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log,
                             min(256, s), init_state=s0)):
        for got, w in ((y, want[0]), (fs, want[1])):
            assert torch.isfinite(got).all()
            err = (got - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item(), err


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-360m",
                                  "mamba2-2.7b", "olmoe-1b-7b",
                                  "internvl2-1b"])
def test_reduced_serving_on_card(dev, arch):
    """The reduced model from the same weights: its prefill logits on the
    card within 8 bf16 epsilons (2^-7) of the largest CPU logit, the
    tolerance of tests/test_torch_models.py; served on the card, one kernel
    launch per attention / recurrent layer and prefill, none per decode
    step."""
    cfg = get(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    card_params = _to(params, dev)
    toks = torch.as_tensor((np.arange(70) * 7) % 200)[None]
    want, _ = model.prefill(params, toks)
    got, _ = model.prefill(card_params, toks.to(dev))
    tol = 8 * 2.0 ** -7 * want.float().abs().max().item()
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=tol,
                               rtol=0)
    eng = ServingEngine(model, card_params, batch_slots=2, max_len=96,
                        device=dev)
    for i, n in enumerate((5, 40, 70)):
        eng.submit(Request(rid=i, prompt=(np.arange(n) * 7) % 200,
                           max_new_tokens=4))
    fa_ops.reset_launches()
    lru_ops.reset_launches()
    ssd_ops.reset_launches()
    done = eng.run_until_drained()
    assert [len(r.generated) for r in done] == [4, 4, 4]
    kinds = cfg.layer_kinds()
    assert fa_ops.launches["flash_attention_fwd"] == \
        3 * (kinds.count("attn") + kinds.count("moe"))
    assert lru_ops.launches["rglru_scan"] == 3 * kinds.count("rec")
    assert ssd_ops.launches["ssd_scan"] == 3 * kinds.count("ssm")


def test_reduced_encdec_on_card(dev):
    """seamless-m4t-large-v2 reduced from the same weights: prefill (13
    frames, 9 tokens) and two decode steps on the card within 8 bf16
    epsilons of the CPU's largest logit; 2 encoder, 2 decoder and 2 cross
    attention launches a prefill, none a decode step."""
    cfg = get("seamless-m4t-large-v2").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    card_params = _to(params, dev)
    toks = torch.as_tensor((np.arange(9) * 7) % 200)[None]
    frames = torch.randn((1, 13, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    want, caches = model.prefill(params, toks, pad_cache_to=16,
                                 frames=frames)
    fa_ops.reset_launches()
    got, card_caches = model.prefill(card_params, toks.to(dev),
                                     pad_cache_to=16, frames=frames.to(dev))
    assert fa_ops.launches["flash_attention_fwd"] == 6
    for step in range(3):
        tol = 8 * 2.0 ** -7 * want.float().abs().max().item()
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   atol=tol, rtol=0)
        tok = torch.argmax(want[0]).reshape(1, 1)
        pos = torch.tensor([[9 + step]])
        want, caches = model.decode_step(params, tok, caches, pos)
        got, card_caches = model.decode_step(card_params, tok.to(dev),
                                             card_caches, pos.to(dev))
    assert fa_ops.launches["flash_attention_fwd"] == 6


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _cell_columns(dev, perts, fracs, backlogs):
    """Per-cell operands of the fixed-horizon runner over every
    (perturbation, protocol, backlog, fraction) cell, and the fixed
    engine's perturbation-major stacks and mix tensors."""
    ps = flitsim.SymmetricFlitParams.stack(
        [p.perturbed(q) for q in perts
         for p in flitsim.SYMMETRIC_PARAMS.values()], dev)
    pa = flitsim.AsymmetricLaneParams.stack(
        [p.perturbed(q) for q in perts
         for p in flitsim.ASYMMETRIC_PARAMS.values()], dev)
    x = torch.as_tensor(100.0 * np.asarray(fracs), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(backlogs, dtype=torch.float32, device=dev)
    srows = flitsim._sym_param_rows(ps, x, 100.0 - x, b)   # cells p, b, m
    sym = (srows, srows[11:12].contiguous(), srows[12:13].contiguous(),
           srows[13:14].contiguous())
    arows = flitsim._asym_param_rows(pa, x, 100.0 - x)
    asym = (arows, arows[6:7].contiguous(), arows[7:8].contiguous())
    return sym, asym, ps, pa, x, b


@pytest.mark.parametrize("cycles", [64, 66, 96, 2048])
def test_cells_fixed_runner_equals_fixed_engine(dev, cycles):
    """The per-cell fixed-horizon runner: ONE launch of each trace kernel
    on per-cell columns of perturbed stacks equals the card's fixed engine
    and the plain versions on the CPU bit for bit, at horizons that are
    and are not multiples of four."""
    perts = [{}, {"g_slots": 2.0, "read_lanes": 0.8}, {"credit_lines": 0.5}]
    fracs = np.linspace(0.0, 1.0, 11)
    sym, asym, ps, pa, x, b = _cell_columns(dev, perts, fracs,
                                            [1.0, 2.0, 8.0, 64.0])
    ops.reset_launches()
    s_eff, a_eff = flitsim._run_cells_fixed(sym, asym, n_flits=cycles,
                                            n_accesses=cycles)
    assert ops.launches["symmetric_trace"] == 1
    assert ops.launches["asymmetric_trace"] == 1
    fixed_s = flitsim._symmetric_grid(ps, x, 100.0 - x, b, n_flits=cycles)
    fixed_a = flitsim._asymmetric_grid(pa, x, 100.0 - x, n_accesses=cycles)
    assert _same_bits(s_eff, fixed_s.reshape(-1))
    assert _same_bits(a_eff, fixed_a.reshape(-1))
    cpu_s, cpu_a = flitsim._run_cells_fixed(
        tuple(t.cpu() for t in sym), tuple(t.cpu() for t in asym),
        n_flits=cycles, n_accesses=cycles)
    assert _same_bits(s_eff.cpu(), cpu_s)
    assert _same_bits(a_eff.cpu(), cpu_a)


def _stream_space(dev, **kw):
    from repro_torch.core.ucie import UCIE_A_32G_55U, UCIE_S_32G
    return DesignSpace([
        axis("protocol_param", [{}, {"g_slots": 2.0}, {"write_lanes": 0.5}]),
        axis("phy", [UCIE_S_32G, UCIE_A_32G_55U]),
        axis("backlog", [2.0, 8.0, 64.0]),
        axis("read_fraction", np.linspace(0.0, 1.0, 21)),
    ], n_flits=64, n_accesses=64, device=dev, **kw)


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_stream_on_card_equals_materialized(dev, prefetch):
    """The streamed sim_bandwidth_gbs frontier on the card: winners, win
    counts and bests equal the card's materialized fixed engine and the
    CPU's stream; one launch of each trace kernel per dispatch."""
    from repro_torch.core.space import StreamConfig
    space = _stream_space(dev)
    mat = space.evaluate(metrics=("sim_bandwidth_gbs",))["sim_bandwidth_gbs"]
    ops.reset_launches()
    sr = space.evaluate(metrics=("sim_bandwidth_gbs",),
                        stream=StreamConfig(chunk_cells=40,
                                            prefetch=prefetch))
    assert ops.launches["symmetric_trace"] == sr.n_dispatches
    assert ops.launches["asymmetric_trace"] == sr.n_dispatches
    assert sr.n_dispatches == 5 and sr.peak_cells_per_chunk == 80
    info = flitsim.last_run_info()["stream.sim"]
    assert info["prefetch"] == prefetch and info["dispatches"] == 5
    win = mat.argbest("protocol")
    assert sr.winners.dims == win.dims
    assert (sr.winners.values == win.values).all()
    vals = np.asarray(win.values, dtype=object).ravel()
    assert sr.win_counts == {k: int(np.sum(vals == k)) for k in sr.labels}
    v = np.moveaxis(mat.values, 1, 0).reshape(len(sr.labels), -1)
    assert sr.best_by_label == {k: float(v[i].max())
                                for i, k in enumerate(sr.labels)}
    cpu = _stream_space("cpu").evaluate(
        metrics=("sim_bandwidth_gbs",), stream=StreamConfig(chunk_cells=40))
    assert (sr.winners.values == cpu.winners.values).all()
    assert sr.best_by_label == cpu.best_by_label


def test_catalog_stream_on_card_equals_cpu(dev):
    """The streamed analytic frontier with constraints on the card equals
    the card's materialized frontier and the CPU's stream."""
    from repro_torch.core.selector import SelectionConstraints
    from repro_torch.core.space import StreamConfig
    cons = SelectionConstraints(packaging="UCIe-A", max_power_w=40.0)
    out = {}
    for d in (dev, "cpu"):
        space = DesignSpace([axis("read_fraction", np.linspace(0, 1, 21)),
                             axis("shoreline_mm", [4.0, 8.0, 16.0])],
                            device=d)
        out[str(d)] = space.evaluate(metrics=("bandwidth_gbs",),
                                     stream=StreamConfig(chunk_cells=8,
                                                         constraints=cons))
        if d == dev:
            res = space.evaluate(metrics=("bandwidth_gbs", "power_w"))
            ref = res.frontier("bandwidth_gbs", where=res.feasible(cons))
            assert (out[str(d)].winners.values == ref.values).all()
    card, cpu = out[str(dev)], out["cpu"]
    assert (card.winners.values == cpu.winners.values).all()
    assert card.win_counts == cpu.win_counts
    np.testing.assert_allclose(list(card.best_by_label.values()),
                               list(cpu.best_by_label.values()), rtol=0,
                               atol=1e-6)


def test_sweep_perturbed_adaptive_on_card(dev):
    """``sweep_perturbed`` on the card: ADAPTIVE_SIM within 1e-3 of the
    fixed engine, the labels and numbers of the CPU's run (atol 1e-6)."""
    perts = [{}, {"credit_lines": 0.5}, {"g_slots": 0.8, "read_lanes": 0.8}]
    kw = dict(mixes=[(2, 1), (1, 1), (1, 3)], backlogs=[2.0, 64.0])
    card = flitsim.sweep_perturbed(perts, sim=ADAPTIVE_SIM, device=dev,
                                   **kw)["sim_efficiency"]
    fixed = flitsim.sweep_perturbed(perts, device=dev, **kw)[
        "sim_efficiency"]
    cpu = flitsim.sweep_perturbed(perts, sim=ADAPTIVE_SIM, device="cpu",
                                  **kw)["sim_efficiency"]
    assert card.coords == cpu.coords
    assert np.max(np.abs(card.values - fixed.values)) <= 1e-3
    assert np.max(np.abs(card.values - cpu.values)) <= 1e-6


#: f32 gradients of a Function against autograd of its plain version:
#: within GRAD_REL of the largest |gradient|
GRAD_REL = 1e-5


def _grads(fn, ins, cot):
    leaves = [t.detach().requires_grad_(True) for t in ins]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def _grads_close(got, want):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= \
            GRAD_REL * w.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_function_backward_on_card(dev, dtype, window):
    """The Function's forward is the kernel (one launch), its backward the
    VJP of the plain version: the gradients equal autograd's of the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(window)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((2, 2, 3, 70, 64), (2, 2, 70, 64),
                                (2, 2, 70, 64), (2, 2, 3, 70, 64)))
    fa_ops.reset_launches()
    got = _grads(lambda *t: fa_ops.flash_attention(*t, True, window),
                 (q, k, v), g)
    assert fa_ops.launches["flash_attention_fwd"] == 1
    want = _grads(lambda *t: fa_ref.attention_ref(*t, causal=True,
                                                  window=window), (q, k, v), g)
    _grads_close([x.float() for x in got], [x.float() for x in want])


@pytest.mark.parametrize("shape", [(2, 300, 40), (1, 1, 16), (3, 77, 2560)])
def test_lru_function_backward_on_card(dev, shape):
    """The adjoint scan: one more launch of the kernel, the gradients of
    autograd through the plain loop."""
    gen = torch.Generator(device=dev).manual_seed(shape[1])
    log_a = -2.0 * torch.rand(shape, generator=gen, device=dev)
    b, dh = (torch.randn(shape, generator=gen, device=dev)
             for _ in range(2))
    lru_ops.reset_launches()
    got = _grads(lru_ops.lru, (log_a, b), dh)
    assert lru_ops.launches["rglru_scan"] == 2
    _grads_close(got, _grads(lru_ref.lru_ref, (log_a, b), dh))


@pytest.mark.parametrize("s", [40, 300])
def test_ssd_function_backward_on_card(dev, s):
    gen = torch.Generator(device=dev).manual_seed(s)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    ins = (rn(2, s, 4, 16), torch.nn.functional.softplus(rn(2, s, 4) - 2),
           0.5 * rn(2, s, 32), 0.5 * rn(2, s, 32), 0.3 * rn(4))
    cot = rn(2, s, 4, 16)
    ssd_ops.reset_launches()
    got = _grads(lambda *t: ssd_ops.ssd(*t, 64)[0], ins, cot)
    assert ssd_ops.launches["ssd_scan"] == 1
    _grads_close(got, _grads(lambda *t: ssd_ops.chunked(*t, 64)[0], ins,
                             cot))


@pytest.mark.parametrize("arch,seq", [
    ("smollm-360m", 32), ("recurrentgemma-2b", 48), ("mamba2-2.7b", 32),
    ("olmoe-1b-7b", 32), ("internvl2-1b", 24),
    ("seamless-m4t-large-v2", 32)])
def test_reduced_training_step_on_card(dev, arch, seq):
    """A reduced training step of each family on the card from the CPU's
    weights: every gradient leaf finite and non-zero (a Function that
    dropped its graph would leave the projections before it without
    one), the loss within 8 bf16 epsilons of the CPU's, each layer's
    kernel launched in the forward and again in its recompute (and the
    RG-LRU scan a third time for its adjoint).  An moe model's CPU step
    takes the card's expert choices."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.routes import Routes
    from repro_torch.train import SyntheticLM
    from repro_torch.train.train_step import value_and_grad
    cfg = get(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    src = SyntheticLM(cfg, ShapeSpec("t", seq, 2, "train"))
    batch = src.batch_for_step(0)
    for ops_ in (fa_ops, lru_ops, ssd_ops):
        ops_.reset_launches()
    with Routes() as card_routes:
        loss, _, grads = value_and_grad(model, _to(params, dev),
                                        src.place(batch, dev))
    kinds = cfg.layer_kinds() + (("attn",) * 2 * cfg.encoder_layers
                                 if cfg.is_encdec else ())
    attn = kinds.count("attn") + kinds.count("moe")
    assert fa_ops.launches["flash_attention_fwd"] == 2 * attn
    assert lru_ops.launches["rglru_scan"] == 3 * kinds.count("rec")
    assert ssd_ops.launches["ssd_scan"] == 2 * kinds.count("ssm")

    def leaves(tree):
        return [x for k in sorted(tree) for x in leaves(tree[k])] \
            if isinstance(tree, dict) else [tree]
    for g in leaves(grads):
        assert torch.isfinite(g).all() and (g != 0).any()
    with Routes(forced=card_routes.own if cfg.is_moe else None):
        want, _, _ = value_and_grad(model, params, src.place(batch, "cpu"))
    assert abs(float(loss) - float(want)) <= 8 * 2.0 ** -7 * abs(
        float(want))


# -- decode attention ----------------------------------------------------------

#: label -> (B, S, K, G, hd, lengths, dtype): the two olmoe cells' ticks,
#: the other families' decode heads (smollm-360m, internvl2-1b,
#: recurrentgemma-2b's ring of 2048 at batch 1, before and after it fills),
#: the edges of the kernel's instances (one live position, hd 8 with a
#: group of 16), and f32
DA_CASES = {
    "olmoe chat": (32, 2560, 16, 1, 128, "ragged", torch.bfloat16),
    "olmoe code": (16, 4160, 16, 1, 128, "ragged", torch.bfloat16),
    "smollm-360m": (8, 1024, 5, 3, 64, "ragged", torch.bfloat16),
    "internvl2-1b": (4, 640, 2, 7, 64, "ragged", torch.bfloat16),
    "ring wrapped": (1, 2048, 1, 10, 256, "full", torch.bfloat16),
    "ring filling": (1, 2048, 1, 10, 256, "ragged", torch.bfloat16),
    "one position": (3, 300, 2, 2, 32, "one", torch.bfloat16),
    "hd 8 group 16": (2, 77, 3, 16, 8, "ragged", torch.bfloat16),
    "f32 smollm-360m": (4, 1024, 5, 3, 64, "ragged", torch.float32),
    "f32 ring": (2, 600, 1, 10, 256, "ragged", torch.float32),
}


def _da_inputs(dev, b, s, kh, g, hd, kind, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, 1, kh, g, hd), (b, s, kh, hd),
                             (b, s, kh, hd)))
    if kind == "one":
        lengths = torch.ones(b, dtype=torch.int32)
    elif kind == "full":
        lengths = torch.full((b,), s, dtype=torch.int32)
    else:
        lengths = torch.randint(1, s + 1, (b,), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(seed))
        lengths[0] = 1 if b > 1 else lengths[0]
        lengths[-1] = s if b > 2 else lengths[-1]
    return q, k, v, lengths.to(dev)


@pytest.mark.parametrize("label", list(DA_CASES))
def test_decode_attention_close_to_plain(dev, label):
    """The kernel against its plain version on the card, within one bf16
    ulp of each output element (its rounding) and one of the largest (the
    softmax weights' bf16 roundings, which the f32 sums' order moves); f32
    within 2^-16 of each and of the largest.  A second call gives the same
    bits (no atomics)."""
    b, s, kh, g, hd, kind, dtype = DA_CASES[label]
    q, k, v, lengths = _da_inputs(dev, b, s, kh, g, hd, kind, dtype)
    da_ops.reset_launches()
    got = da_ops.decode_attention(q, k, v, lengths)
    assert da_ops.launches["decode_attention"] == 1
    want = da_ref.decode_attention_ref(q, k, v, lengths)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -16
    g32, w32 = got.float(), want.float()
    assert torch.isfinite(g32).all()
    torch.testing.assert_close(g32, w32, rtol=tol,
                               atol=tol * w32.abs().max().item())
    assert torch.equal(da_ops.decode_attention(q, k, v, lengths), got)


@pytest.mark.parametrize("what", ["hd 96", "group 17", "int64 lengths",
                                  "lengths on the host", "strided cache",
                                  "unaligned cache", "float16"])
def test_decode_attention_refuses_on_card(dev, what):
    b, s, kh, g, hd = 2, 64, 2, 2, 64
    q, k, v, lengths = _da_inputs(dev, b, s, kh, g, hd, "ragged",
                                  torch.bfloat16)
    if what == "hd 96":
        q, k, v = _da_inputs(dev, b, s, kh, g, 96, "ragged",
                             torch.bfloat16)[:3]
    elif what == "group 17":
        q = _da_inputs(dev, b, s, kh, 17, hd, "ragged", torch.bfloat16)[0]
    elif what == "int64 lengths":
        lengths = lengths.long()
    elif what == "lengths on the host":
        lengths = lengths.cpu()
    elif what == "strided cache":
        k = torch.cat([k, k], dim=1)[:, ::2]
    elif what == "unaligned cache":
        k = k.new_empty(k.numel() + 1)[1:].view(k.shape).copy_(k)
    else:
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
    da_ops.reset_launches()
    with pytest.raises(ValueError):
        da_ops.decode_attention(q, k, v, lengths)
    assert da_ops.launches["decode_attention"] == 0


def test_decode_step_on_card_takes_the_kernel(dev):
    """A decode step of the reduced olmoe-1b-7b on the card: one kernel
    call a layer (``launches`` and ``attn.decode_kernel``), no plain call,
    no ``copy.kv_upcast``, and one sync a layer under ``block.attn`` (the
    rope's; the plain version's scale and masked score made two more)."""
    cfg = get("olmoe-1b-7b").reduced()
    model = build(cfg)
    params = _to(model.init(torch.Generator().manual_seed(0)), dev)
    toks = torch.as_tensor((np.arange(9) * 7) % 200, device=dev)[None]
    _, caches = model.prefill(params, toks, pad_cache_to=32)
    tok = torch.tensor([[3]], device=dev)
    pos = torch.tensor([[9]], device=dev)
    torch.cuda.synchronize()
    da_ops.reset_launches()
    with spans.recording():
        with spans.span("engine.decode"):
            model.decode_step(params, tok, caches, pos)
        counters = spans.snapshot().counters
    torch.cuda.synchronize()
    layers = cfg.num_layers
    assert da_ops.launches["decode_attention"] == layers
    assert counters["attn.decode_kernel"] == layers
    assert "attn.decode_plain" not in counters
    assert "copy.kv_upcast" not in counters
    assert counters.get("sync.block.attn", 0) == layers


@pytest.mark.parametrize("arch", ["smollm-360m", "internvl2-1b",
                                  "recurrentgemma-2b"])
def test_reduced_decode_on_card(dev, arch):
    """The reduced model from the same weights: prefill 40 tokens, then
    three decode steps through the kernel (recurrentgemma-2b's ring of 32
    has wrapped), the logits within 8 bf16 epsilons of the largest CPU
    logit, the tolerance of tests/test_torch_models.py."""
    cfg = get(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    card_params = _to(params, dev)
    toks = torch.as_tensor((np.arange(40) * 7) % 200)[None]
    want, caches = model.prefill(params, toks, pad_cache_to=48)
    got, card_caches = model.prefill(card_params, toks.to(dev),
                                     pad_cache_to=48)
    da_ops.reset_launches()
    for step in range(3):
        tok = torch.argmax(want[0]).reshape(1, 1)
        pos = torch.tensor([[40 + step]])
        want, caches = model.decode_step(params, tok, caches, pos)
        got, card_caches = model.decode_step(card_params, tok.to(dev),
                                             card_caches, pos.to(dev))
        tol = 8 * 2.0 ** -7 * want.float().abs().max().item()
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   atol=tol, rtol=0)
    kinds = cfg.layer_kinds()
    assert da_ops.launches["decode_attention"] == 3 * (
        kinds.count("attn") + kinds.count("moe"))
