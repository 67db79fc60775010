"""The port's SSD scan on the CPU against the JAX reference: the port's
sequential oracle ``ssd_ref``, its chunked closed form ``ssd_chunked`` and
the launch wrapper ``ops.ssd`` (which runs ``ssd_chunked`` for CPU
tensors) against the reference's ``ssd_ref``, ``ssd_chunked`` and Pallas
``ssd_scan`` (in interpret mode, as ``tests/test_kernels.py`` runs it),
on inputs made with numpy from a seed, at atol 5e-5 / rtol 1e-4 (the
reference's own tolerance for its kernel, ``tests/test_kernels.py``).

Ragged sequences (S above one chunk and not a multiple of it), which the
reference's chunked forms refuse (ROADMAP.md queue 3, R6), are held
against the reference's sequential ``ssd_ref``, which takes any S.

With dt = softplus(N(0, 1)) and |A| near 1 the state decays by about
exp(-0.8) a step, so a chunk hands almost nothing to the next one.  The
slow-decay cases draw dt = softplus(N(0, 1) - 5), about 0.011, as
trained Mamba2 step sizes are: a chunk of 64 then decays by about 0.5,
and the term carrying the state across chunks decides the result.  The
CUDA kernel against these plain versions is in
``tests/test_torch_cuda.py`` (it needs the card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.models.ssm import ssd_chunked

TOL = dict(atol=5e-5, rtol=1e-4)
#: tests/test_kernels.py's shapes (B, S, H, P, N, chunk)
SHAPES = [(2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
          (2, 96, 3, 16, 8, 32), (1, 64, 1, 64, 32, 64)]


#: shift of dt's pre-activation in the slow-decay cases
SLOW = -5.0


def _inputs(seed, bsz, s, h, p, n, shift=0.0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((bsz, s, h, p)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)) + shift)).astype(
        f32)
    b = (rng.standard_normal((bsz, s, n)) * 0.5).astype(f32)
    c = (rng.standard_normal((bsz, s, n)) * 0.5).astype(f32)
    a_log = (rng.standard_normal((h,)) * 0.3).astype(f32)
    return x, dt, b, c, a_log


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("bsz,s,h,p,n,chunk", SHAPES)
def test_port_matches_reference_kernel_oracle_and_chunked_form(
        bsz, s, h, p, n, chunk):
    args = _inputs(s + h, bsz, s, h, p, n)
    x, dt, b, c, a_log = _j(args)
    want_ref = jax_ssd_ref(x, dt, b, c, a_log)
    want_kernel = jax_ssd_scan(x, dt, b, c, a_log, chunk=chunk,
                               interpret=True)
    want_chunked = jax_ssd_chunked(x, dt, b[:, :, None], c[:, :, None],
                                   a_log, chunk)
    tx, tdt, tb, tc, ta = _t(args)
    got_ref = ssd_ref(tx, tdt, tb, tc, ta)
    got_chunked = ssd_chunked(tx, tdt, tb[:, :, None], tc[:, :, None], ta,
                              chunk)
    ops.reset_launches()
    got_ops = ops.ssd(tx, tdt, tb, tc, ta, chunk=chunk)
    assert ops.launches["ssd_scan"] == 0                # CPU: plain version
    assert got_ops[0].shape == (bsz, s, h, p)
    assert got_ops[1].shape == (bsz, h, p, n)
    for got in (got_ref, got_chunked, got_ops):
        for want in (want_ref, want_kernel, want_chunked):
            _close(got, want)


@pytest.mark.parametrize("s,chunk", [(100, 32), (7, 64), (257, 64)])
def test_ragged_sequence_matches_reference_oracle(s, chunk):
    """A last chunk shorter than the others (100 = 3 x 32 + 4, 257 =
    4 x 64 + 1) and a sequence shorter than one chunk: the port pads with
    dt = 0 and x = 0 and drops the padded rows."""
    args = _inputs(s, 2, s, 3, 16, 8)
    want = jax_ssd_ref(*_j(args))
    tx, tdt, tb, tc, ta = _t(args)
    _close(ssd_chunked(tx, tdt, tb[:, :, None], tc[:, :, None], ta, chunk),
           want)
    _close(ops.ssd(tx, tdt, tb, tc, ta, chunk=chunk), want)
    _close(ssd_ref(tx, tdt, tb, tc, ta), want)


@pytest.mark.parametrize("bsz,s,h,p,n,chunk", SHAPES)
def test_slow_decay_matches_reference_kernel_oracle_and_chunked_form(
        bsz, s, h, p, n, chunk):
    """Chunk decays of order 0.1-1: the state carried from chunk to chunk
    counts."""
    args = _inputs(s + h + 1, bsz, s, h, p, n, shift=SLOW)
    x, dt, b, c, a_log = _j(args)
    a = np.exp(args[4])[None, None] * args[1]
    assert 0.05 < np.exp(-a[:, :chunk].sum(1)).mean() < 0.95
    wants = (jax_ssd_ref(x, dt, b, c, a_log),
             jax_ssd_scan(x, dt, b, c, a_log, chunk=chunk, interpret=True),
             jax_ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log,
                             chunk))
    tx, tdt, tb, tc, ta = _t(args)
    for got in (ssd_ref(tx, tdt, tb, tc, ta),
                ssd_chunked(tx, tdt, tb[:, :, None], tc[:, :, None], ta,
                            chunk),
                ops.ssd(tx, tdt, tb, tc, ta, chunk=chunk)):
        for want in wants:
            _close(got, want)


@pytest.mark.parametrize("s,chunk", [(100, 32), (257, 64)])
def test_slow_decay_ragged_with_initial_state_matches_reference_oracle(
        s, chunk):
    """Ragged S, slow decay and a carried initial state (a continued
    prefill) through the wrapper and both plain versions."""
    args = _inputs(s + 1, 2, s, 3, 16, 8, shift=SLOW)
    s0 = np.random.default_rng(s).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    for init in (None, s0):
        want = jax_ssd_ref(*_j(args), init_state=None if init is None
                           else jnp.asarray(init))
        tx, tdt, tb, tc, ta = _t(args)
        ti = None if init is None else torch.from_numpy(init)
        _close(ssd_ref(tx, tdt, tb, tc, ta, init_state=ti), want)
        _close(ssd_chunked(tx, tdt, tb[:, :, None], tc[:, :, None], ta,
                           chunk, init_state=ti), want)
        _close(ops.ssd(tx, tdt, tb, tc, ta, chunk=chunk, init_state=ti),
               want)


def test_reference_chunked_form_refuses_a_ragged_sequence():
    """R6 at the function level: the reference's ``ssd_chunked`` asserts
    S % chunk == 0 (``src/repro/models/ssm.py:69``)."""
    args = _j(_inputs(1, 1, 100, 2, 16, 8))
    x, dt, b, c, a_log = args
    with pytest.raises(AssertionError):
        jax_ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log, 32)


def test_initial_state_matches_reference():
    args = _inputs(5, 2, 48, 3, 16, 8)
    s0 = np.random.default_rng(2).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    want = jax_ssd_ref(*_j(args), init_state=jnp.asarray(s0))
    tx, tdt, tb, tc, ta = _t(args)
    ts0 = torch.from_numpy(s0)
    _close(ssd_ref(tx, tdt, tb, tc, ta, init_state=ts0), want)
    _close(ssd_chunked(tx, tdt, tb[:, :, None], tc[:, :, None], ta, 16,
                       init_state=ts0), want)


def test_grouped_chunked_form_matches_reference():
    """G = 2 groups of B/C broadcast over 4 heads (no shipped config has
    G > 1; the chunked form keeps the reference's group path)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 32, 4, 8)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, 32, 4)))).astype(np.float32)
    b = (rng.standard_normal((1, 32, 2, 8)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((1, 32, 2, 8)) * 0.5).astype(np.float32)
    a_log = (rng.standard_normal((4,)) * 0.3).astype(np.float32)
    want = jax_ssd_chunked(*_j((x, dt, b, c, a_log)), 8)
    _close(ssd_chunked(*_t((x, dt, b, c, a_log)), 8), want)


def test_bf16_operands_are_cast_to_f32():
    args = _inputs(4, 1, 40, 2, 16, 8)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in args[:4]]
    got = ops.ssd(*bf, torch.from_numpy(args[4]), chunk=16)
    assert got[0].dtype == got[1].dtype == torch.float32
    want = jax_ssd_ref(*[jnp.asarray(a).astype(jnp.bfloat16)
                         for a in args[:4]], jnp.asarray(args[4]))
    _close(got, want)


def test_wrapper_rejects_bad_operands():
    x, dt, b, c, a_log = _t(_inputs(0, 1, 4, 2, 8, 4))
    with pytest.raises(ValueError, match="dt"):
        ops.ssd(x, dt[:, :3], b, c, a_log)
    with pytest.raises(ValueError, match="one shape"):
        ops.ssd(x, dt, b, c[..., :3], a_log)
    with pytest.raises(ValueError, match="one shape"):
        ops.ssd(x, dt, b[:, :, None], c[:, :, None], a_log)
    with pytest.raises(ValueError, match="a_log"):
        ops.ssd(x, dt, b, c, a_log[:1])
    with pytest.raises(ValueError, match="init_state"):
        ops.ssd(x, dt, b, c, a_log, init_state=torch.zeros(1, 2, 8, 3))
    with pytest.raises(ValueError, match="several devices"):
        ops.ssd(x, dt, b, c, a_log, init_state=torch.zeros(
            1, 2, 8, 4, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd(*[t.to("meta") for t in (x, dt, b, c, a_log)])
    with pytest.raises(ValueError, match="several devices"):
        ops.ssd(x.to("meta"), dt, b, c, a_log)
