"""The port's RG-LRU scan on the CPU (its plain version, which the wrapper
runs for CPU tensors) against the JAX reference: the kernel oracle
``lru_ref`` (sequential) and the model's ``lru_scan`` (associative scan),
on inputs made with numpy from a seed, at atol 1e-5 / rtol 1e-4 (the
reference's own tolerance for its kernel; the associative scan rounds in
another order).  Sequence lengths include ones that are not a multiple of
the TPU kernel's block of 128."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import lru_ref as jax_lru_ref
from repro.models.rglru import lru_scan
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import lru_ref

TOL = dict(atol=1e-5, rtol=1e-4)
_jax_ref = jax.jit(jax_lru_ref)
_jax_scan = jax.jit(lru_scan)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    # log a in [-2, 0): decays between e^-2 and 1, as the gates give
    log_a = -rng.uniform(0.0, 2.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return log_a, b


@pytest.mark.parametrize("shape", [(2, 128, 64), (1, 77, 40), (3, 200, 16),
                                   (1, 1, 8)])
def test_matches_reference_oracle_and_model_scan(shape):
    log_a, b = _inputs(shape[1], shape)
    ops.reset_launches()
    got = ops.lru(torch.from_numpy(log_a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == shape
    assert ops.launches["rglru_scan"] == 0           # CPU: plain version
    args = (jnp.asarray(log_a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_ref(*args)),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_scan(*args)),
                               **TOL)


def test_initial_state_matches_reference():
    log_a, b = _inputs(9, (2, 33, 24))
    h0 = np.random.default_rng(1).standard_normal((2, 24)).astype(np.float32)
    got = lru_ref(torch.from_numpy(log_a), torch.from_numpy(b),
                  torch.from_numpy(h0))
    want = jax_lru_ref(jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_operands_are_cast_to_f32():
    """The wrapper casts to f32 as the reference's ``ops.lru`` does."""
    log_a, b = _inputs(4, (1, 50, 8))
    la16 = torch.from_numpy(log_a).to(torch.bfloat16)
    b16 = torch.from_numpy(b).to(torch.bfloat16)
    got = ops.lru(la16, b16)
    want = jax_lru_ref(jnp.asarray(log_a).astype(jnp.bfloat16),
                       jnp.asarray(b).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="one shape"):
        ops.lru(x, torch.zeros((1, 4, 9)))
    with pytest.raises(ValueError, match="one shape"):
        ops.lru(x[0], x[0])
    with pytest.raises(ValueError, match="no kernel"):
        ops.lru(x.to("meta"), x.to("meta"))
