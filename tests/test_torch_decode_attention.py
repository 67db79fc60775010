"""The port's decode attention on the CPU (the plain version, which the
wrapper runs for CPU tensors) against the plain ``attend_decode`` on the
mask that ``decode_attend`` built before it took the wrapper, and against
the JAX reference's ``attend_decode`` on the same mask.  Inputs come from
numpy with a seed; the caches are bf16, as served.

The wrapper's live prefix (``live_lengths``) must give the old mask exactly,
so the plain version equals ``attend_decode`` bit for bit.  Against the
reference the tolerance is one bf16 ulp of the output's largest value
(2^-7 of it): both round the f32 softmax weights and the output to bf16,
and their f32 sums (XLA's and PyTorch's) run in other orders, which moves
a rounding of either across a bf16 boundary."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attend_decode as jax_attend_decode
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    attend_masked, check_operands,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.attention import (
    attend_decode, decode_attend, live_lengths,
)
from repro_torch.runtime import spans

S = 96
WINDOW = 64          # a ring of WINDOW positions


def _inputs(seed, b, s, kh, g, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, kh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    return q, k, v


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _old_mask(pos, s, window):
    """The validity mask ``decode_attend`` built before it took the
    wrapper (one device, positions 0 .. s - 1)."""
    j = torch.arange(s)
    if window > 0:
        return (j[None, :] <= pos[:, None]) | (pos[:, None] >= window - 1)
    return j[None, :] <= pos[:, None]


def _positions(kind, b, s, window, seed):
    """Per-row positions of the new token: every row at 0 (one live
    position), ragged, or every row at the cache's end; a ring before it
    fills and after it wraps."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        pos = np.zeros(b)
    elif kind == "ragged":
        pos = rng.integers(0, s, size=b)
        pos[0] = 0
        pos[-1] = s - 1
    elif kind == "full":
        pos = np.full(b, s - 1)
    elif kind == "ring_filling":
        pos = rng.integers(0, window - 1, size=b)
    else:                                          # "ring_wrapped"
        pos = rng.integers(window - 1, 4 * window, size=b)
    return torch.as_tensor(pos, dtype=torch.int64)


CASES = [
    # kind, window, b, g, hd
    ("one", 0, 3, 1, 128),
    ("ragged", 0, 4, 1, 128),
    ("full", 0, 2, 1, 128),
    ("ragged", 0, 3, 3, 64),
    ("full", 0, 2, 3, 64),
    ("one", 0, 2, 10, 256),
    ("ragged", 0, 3, 10, 256),
    ("ring_filling", WINDOW, 3, 10, 256),
    ("ring_wrapped", WINDOW, 3, 10, 256),
    ("ring_filling", WINDOW, 4, 1, 128),
    ("ring_wrapped", WINDOW, 4, 3, 64),
]


@pytest.mark.parametrize("kind,window,b,g,hd", CASES)
def test_plain_version_equals_attend_decode_and_the_reference(
        kind, window, b, g, hd):
    s = window if window > 0 else S
    kh = 2
    q, k, v = _inputs(b * 1000 + g * 10 + hd, b, s, kh, g, hd)
    pos = _positions(kind, b, s, window, seed=hd + g)
    mask = _old_mask(pos, s, window)
    lengths = live_lengths(pos, s, window)
    assert lengths.dtype == torch.int32
    # the live positions are a prefix, and exactly the old mask
    assert torch.equal(torch.arange(s)[None, :] < lengths[:, None], mask)
    tq, tk, tv = _bf16(q), _bf16(k), _bf16(v)
    ops.reset_launches()
    got = ops.decode_attention(tq, tk, tv, lengths)
    assert ops.launches["decode_attention"] == 0      # CPU: plain version
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert torch.equal(got, attend_decode(tq, tk, tv, valid_mask=mask))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_attend_decode(jq, jk, jv,
                                        valid_mask=jnp.asarray(mask.numpy())),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("window,kind", [(0, "ragged"), (0, "full"),
                                         (WINDOW, "ring_filling"),
                                         (WINDOW, "ring_wrapped")])
def test_decode_attend_writes_then_attends_the_live_prefix(window, kind):
    """``decode_attend`` on one device: the new K/V lands at ``pos`` (its
    ring slot), and the output is ``attend_decode`` over the old mask."""
    b, kh, g, hd = 3, 2, 3, 64
    s = window if window > 0 else S
    q, k, v = _inputs(7 + window, b, s, kh, g, hd)
    new_k, new_v = (_bf16(a[:, :1]) for a in _inputs(8, b, 1, kh, 1, hd)[1:])
    pos = _positions(kind, b, s, window, seed=5)
    cache = {"k": _bf16(k), "v": _bf16(v)}
    kc0, vc0 = cache["k"].clone(), cache["v"].clone()
    out_cache, o = decode_attend(_bf16(q), new_k, new_v, cache, pos, window,
                                 None)
    at = pos % window if window > 0 else pos
    rows = torch.arange(b)
    kc0[rows, at], vc0[rows, at] = new_k[:, 0], new_v[:, 0]
    assert torch.equal(out_cache["k"], kc0)
    assert torch.equal(out_cache["v"], vc0)
    assert torch.equal(o, attend_decode(_bf16(q), kc0, vc0,
                                        valid_mask=_old_mask(pos, s, window)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attend_masked_equals_the_tensor_scalar_form(dtype):
    """The host scalars (the scale, the masked score) give the bits of the
    0-d tensors ``attend_decode`` used before, which drained the card."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs(3, 3, 40, 2, 3, 64))
    mask = torch.arange(40)[None, :] < torch.tensor([[1], [17], [40]])
    scale = 1.0 / torch.sqrt(torch.tensor(64, dtype=torch.float32))
    logits = torch.einsum("bqkgx,bskx->bqkgs", q.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None, None, :], logits,
                         torch.tensor(NEG_INF, dtype=torch.float32))
    w = torch.softmax(logits, dim=-1)
    want = torch.einsum("bqkgs,bskx->bqkgx", w.to(dtype).float(),
                        v.float()).to(dtype)
    assert torch.equal(attend_masked(q, k, v, mask), want)


def test_live_lengths_clamp_to_the_cache():
    pos = torch.tensor([0, 5, 95, 96, 300])
    assert live_lengths(pos, 96, 0).tolist() == [1, 6, 96, 96, 96]
    pos = torch.tensor([0, 62, 63, 64, 500])
    assert live_lengths(pos, 64, 64).tolist() == [1, 63, 64, 64, 64]


def test_counters_on_the_plain_path():
    b, s, kh, g, hd = 2, 24, 2, 1, 64
    q, k, v = (_bf16(a) for a in _inputs(1, b, s, kh, g, hd))
    with spans.recording():
        ops.decode_attention(q, k, v, torch.tensor([3, 24],
                                                   dtype=torch.int32))
    got = spans.snapshot().counters
    assert got == {"attn.decode_plain": 1,
                   "copy.kv_upcast": 2 * b * s * kh * hd * (2 + 4)}


@pytest.mark.parametrize("what", ["q_rank", "kv_shape", "hd", "dtype",
                                  "mixed", "lengths_shape",
                                  "lengths_float"])
def test_operands_are_checked(what):
    q, k, v = (_bf16(a) for a in _inputs(2, 2, 16, 2, 3, 64))
    lengths = torch.tensor([1, 16], dtype=torch.int32)
    if what == "q_rank":
        q = q[:, 0]
    elif what == "kv_shape":
        v = v[:, :8]
    elif what == "hd":
        k, v = k[..., :32], v[..., :32]
    elif what == "dtype":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
    elif what == "mixed":
        q = q.float()
    elif what == "lengths_shape":
        lengths = lengths[:1]
    else:
        lengths = lengths.float()
    with pytest.raises(ValueError):
        check_operands(q, k, v, lengths)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, v, lengths)


def test_long_cache_against_the_reference_cache_len():
    """A cache of 2560 positions (the chat cell's ``max_len``) at olmoe's
    head shape, ragged lengths, against the reference's own ``cache_len``
    form."""
    b, s, kh, g, hd = 2, 2560, 2, 1, 128
    q, k, v = _inputs(11, b, s, kh, g, hd)
    lengths = torch.tensor([1021, 2560], dtype=torch.int32)
    got = ops.decode_attention(_bf16(q), _bf16(k), _bf16(v), lengths)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_attend_decode(
        jq, jk, jv, cache_len=jnp.asarray(lengths.numpy())), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
