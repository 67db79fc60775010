"""The port's flash-attention forward on the CPU (its plain version, which
the wrapper runs for CPU tensors) against the JAX reference: the kernel
oracle ``attention_ref`` at ``tests/test_kernels.py``'s shapes, windows
and dtypes, and the model's streaming ``attend_chunked`` in the model
layout.  Inputs come from numpy with a seed.

Tolerances: atol 3e-5 / rtol 1e-4 in f32 and 3e-2 in bf16, the reference's
own for its kernel (``tests/test_kernels.py``).  Against ``attend_chunked``
in bf16 the reference rounds the probabilities to bf16 before the PV
product where the port keeps them in f32, so that comparison is at the
bf16 tolerance 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import attend_chunked
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    MAX_HEAD_DIM, NEG_INF, attention_ref,
)
from repro_torch.models.attention import attend_prefill

F32_TOL = dict(atol=3e-5, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, qshape, kvshape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in (qshape, kvshape, kvshape)]


def _both(arrs, dtype):
    """The same numbers as JAX arrays and as CPU tensors of ``dtype``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(dtype) for a in arrs])


def _check(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,k,g,sq,skv,hd", [
    (2, 2, 3, 128, 128, 64),
    (1, 1, 1, 256, 256, 128),
    (2, 2, 2, 96, 96, 64),          # non-multiple of the TPU block
    (1, 1, 2, 64, 192, 64),         # Sq != Skv, q_offset 128
])
def test_causal_matches_reference(b, k, g, sq, skv, hd):
    arrs = _qkv(sq + skv, (b, k, g, sq, hd), (b, k, skv, hd))
    (jq, jk, jv), (q, kk, v) = _both(arrs, torch.float32)
    off = skv - sq
    ops.reset_launches()
    got = ops.flash_attention(q, kk, v, True, 0, off)
    _check(got, jax_ref(jq, jk, jv, causal=True, q_offset=off), F32_TOL)
    assert ops.launches["flash_attention_fwd"] == 0     # CPU: plain version


@pytest.mark.parametrize("window", [16, 32, 64])
def test_local_window_matches_reference(window):
    arrs = _qkv(window, (1, 2, 2, 128, 64), (1, 2, 128, 64))
    (jq, jk, jv), (q, kk, v) = _both(arrs, torch.float32)
    got = ops.flash_attention(q, kk, v, True, window)
    _check(got, jax_ref(jq, jk, jv, causal=True, window=window), F32_TOL)


def test_window_with_q_offset_matches_reference():
    """A continuation chunk: 48 queries at positions 80..127 against 128
    keys, window 32."""
    arrs = _qkv(7, (1, 1, 4, 48, 64), (1, 1, 128, 64))
    (jq, jk, jv), (q, kk, v) = _both(arrs, torch.float32)
    got = ops.flash_attention(q, kk, v, True, 32, 80)
    _check(got, jax_ref(jq, jk, jv, causal=True, window=32, q_offset=80),
           F32_TOL)


def test_non_causal_cross_matches_reference():
    arrs = _qkv(3, (2, 1, 1, 64, 64), (2, 1, 160, 64))
    (jq, jk, jv), (q, kk, v) = _both(arrs, torch.float32)
    got = ops.flash_attention(q, kk, v, False)
    _check(got, jax_ref(jq, jk, jv, causal=False), F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtypes_match_reference(dtype):
    arrs = _qkv(11, (1, 1, 2, 64, 64), (1, 1, 64, 64))
    (jq, jk, jv), (q, kk, v) = _both(arrs, dtype)
    got = ops.flash_attention(q, kk, v)
    assert got.dtype == dtype
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    _check(got, jax_ref(jq, jk, jv), tol)


@pytest.mark.parametrize("sq,window,k,g,hd", [
    (40, 0, 2, 2, 16),              # smollm-like GQA, causal
    (70, 32, 1, 4, 16),             # recurrentgemma-like MQA, window bites
    (24, 32, 1, 4, 16),             # prompt shorter than the window
])
def test_model_layout_matches_attend_chunked(sq, window, k, g, hd):
    """The model's prefill attention (kernel layout, through the wrapper)
    against the reference model's streaming ``attend_chunked`` on bf16
    operands in the model layout q [B,S,K,G,hd], k/v [B,S,K,hd]."""
    arrs = _qkv(sq, (1, sq, k, g, hd), (1, sq, k, hd))
    (jq, jk, jv), (q, kk, v) = _both(arrs, torch.bfloat16)
    got = attend_prefill(q, kk, v, causal=True, window=window)
    want = attend_chunked(jq, jk, jv, causal=True, window=window)
    assert got.shape == (1, sq, k, g, hd) and got.dtype == torch.bfloat16
    _check(got, want, BF16_TOL)


def test_constants_and_scale_match_reference():
    assert NEG_INF == -1e30 and MAX_HEAD_DIM == 256
    for hd in (16, 64, 96, 256):
        want = np.float32(1.0) / np.sqrt(np.float32(hd))
        assert np.float32(ops.softmax_scale(hd)) == want


@pytest.mark.parametrize("hd", [16, 64, 96, 128, 256])
def test_softmax_scale_is_cached_reference_scale(hd):
    """The wrapper's scale, computed once per head dim, is the reference
    model's ``1 / sqrt(f32(hd))`` in f32 (``attend_chunked``), bit for
    bit, on every call."""
    want = np.float32((1.0 / jnp.sqrt(hd)).astype(jnp.float32))
    first = ops.softmax_scale(hd)
    hits = ops.softmax_scale.cache_info().hits
    assert np.float32(first) == want
    assert ops.softmax_scale(hd) == first
    assert ops.softmax_scale.cache_info().hits == hits + 1


def test_wrapper_rejects_bad_operands():
    q = torch.zeros((1, 1, 2, 8, 16))
    kv = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="f32 or"):
        ops.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(q, torch.zeros((1, 2, 8, 16)),
                            torch.zeros((1, 2, 8, 16)))
    with pytest.raises(ValueError, match=r"\[B,K,G,Sq,hd\]"):
        ops.flash_attention(q[0], kv, kv)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


def test_plain_version_is_the_full_softmax():
    """attention_ref equals an explicit per-row softmax in float64 on a
    tiny case (the plain version is the oracle the card is held to)."""
    arrs = _qkv(5, (1, 1, 1, 6, 4), (1, 1, 6, 4))
    q, k, v = [torch.from_numpy(a) for a in arrs]
    got = attention_ref(q, k, v, causal=True, window=3).double()
    qd, kd, vd = [torch.from_numpy(a).double()[0, 0] for a in arrs]
    for i in range(6):
        keys = [j for j in range(6) if j <= i and j > i - 3]
        s = (qd[0, i] @ kd[keys].T) / 2.0
        p = torch.softmax(s, dim=-1)
        np.testing.assert_allclose(got[0, 0, 0, i].numpy(),
                                   (p @ vd[keys]).numpy(), atol=1e-6)
