"""The port's CUDA kernels on the card: each kernel bitwise equal to its
plain version, the launch counters, the bridge and the Fig-13 design
space on the card.  Marked
``cuda``: they skip where there is no card (as on a CPU-only machine) and
run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none."""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import flitsim
from repro_torch.core.space import ADAPTIVE_SIM, DesignSpace, axis
from repro_torch.kernels.flit_pack import ops as pack_ops
from repro_torch.kernels.flit_pack import ref as pack_ref
from repro_torch.kernels.flit_sim import ops, ref

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


def test_bridge_on_card_meets_golden(dev):
    sys.path.insert(0, str(ROOT / "tools"))
    from design_space_summary import summarize
    from repro_torch import explorer
    ops.reset_launches()
    ds = explorer.bridge_mode(device=dev, verbose=False)
    assert ops.launches["asymmetric_periodic"] > 0
    assert ops.launches["symmetric_chunk"] > 0
    golden = json.loads(
        (ROOT / "experiments/golden/design_space_summary.json").read_text())
    got = summarize(ds)
    for key in golden:
        if key != "serving_frontier":
            assert got[key] == golden[key], key


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
    assert 4 <= ops.launches["pipelining_chunk"] <= 8
    cpu = DesignSpace(axes, sim=ADAPTIVE_SIM, device="cpu").evaluate()
    np.testing.assert_allclose(card["utilization"].values,
                               cpu["utilization"].values, atol=1e-6, rtol=0)
    assert abs(flitsim.simulate_lpddr6_pipelining(4, device=dev) - 1.0) \
        <= 1e-3
