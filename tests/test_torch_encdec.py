"""The port's encoder-decoder family on the CPU against the JAX reference:
``seamless-m4t-large-v2.reduced()`` (2 encoder and 2 decoder layers, 4
query heads on 2 KV heads of 16, the plain GELU MLP), with the
reference's parameters carried across by ``convert.model_params`` and
frames of 8 and 13 positions.

The encoder's self attention (non-causal), the decoder's (causal) and the
prefill's cross attention (non-causal, ``St`` queries against ``Se``
keys) go through the flash-attention wrapper, its plain version on the
CPU; decode reads the cross K/V from the prefill's caches.  Tolerances as
in ``tests/test_torch_models.py``: ``TOL_EPS`` bf16 epsilons of the
largest reference value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.models import attention
from test_torch_models import (MAX_LEN, Pair, _decode_extends_prefill,
                               _decode_matches, _flat_caches,
                               _prefill_matches, _schema_matches, _tok,
                               close)

ARCH = "seamless-m4t-large-v2"
FRAMES = (8, 13)


@pytest.fixture(scope="module")
def pair():
    return Pair(ARCH)


@pytest.mark.parametrize("n", [5, 20])
@pytest.mark.parametrize("se", FRAMES)
def test_prefill_logits_and_caches_match_reference(pair, se, n):
    """Logits, the decoder's self caches (padded to ``MAX_LEN``) and the
    cross caches (``se`` positions) of every layer."""
    _prefill_matches(pair, n, frames=pair.embeds(se, seed=se + n))


@pytest.mark.parametrize("n", [5, 20])
@pytest.mark.parametrize("se", FRAMES)
def test_decode_logits_match_reference_teacher_forced(pair, se, n):
    _decode_matches(pair, n, frames=pair.embeds(se, seed=30 + se + n))


@pytest.mark.parametrize("n", [4, 17])
@pytest.mark.parametrize("se", FRAMES)
def test_prefill_then_decode_equals_longer_prefill(pair, se, n):
    _decode_extends_prefill(pair, n, frames=pair.embeds(se, seed=60 + se))


def test_schema_matches_reference(pair):
    """Encoder and decoder blocks one entry per layer; the decoder's
    cross attention has no qkv bias (none has one here) and its own
    norm."""
    _schema_matches(pair)
    p = pair.params
    assert sorted(p) == ["decoder", "embedding", "encoder", "final_norm",
                         "frontend"]
    assert sorted(p["encoder"]["blocks"]) == ["layer_00", "layer_01"]
    assert sorted(p["decoder"]["blocks"]["layer_01"]) == \
        ["attn", "ln1", "ln2", "lnx", "mlp", "xattn"]


def test_cross_schema_drops_the_bias():
    """``attn_schema(cross=True)`` leaves out the qkv bias, as the
    reference's does (a config with qkv bias)."""
    import dataclasses
    from repro.models.attention import attn_schema as ref_schema
    from repro.configs import get as ref_get
    from repro_torch.configs import get
    cfg = dataclasses.replace(get(ARCH).reduced(), qkv_bias=True)
    ref_cfg = dataclasses.replace(ref_get(ARCH).reduced(), qkv_bias=True)
    for cross in (False, True):
        got = attention.attn_schema(cfg, cross=cross)
        want = ref_schema(ref_cfg, cross=cross)
        assert sorted(got) == sorted(want)
        assert all(got[k].shape == want[k].shape for k in got)
    assert "bq" not in attention.attn_schema(cfg, cross=True)


def test_params_carry_across_layer_by_layer(pair):
    """``convert.model_params`` unstacks the reference's ``[L, ...]``
    encoder and decoder stacks bit for bit, and keeps the frontend's
    adapter and the top-level leaves."""
    ref = jax.tree.map(np.asarray, pair.ref_params)
    for stack in ("encoder", "decoder"):
        for i in range(2):
            got = pair.params[stack]["blocks"][f"layer_{i:02d}"]
            np.testing.assert_array_equal(
                got["attn"]["wq"].numpy(),
                ref[stack]["blocks"]["attn"]["wq"][i])
            np.testing.assert_array_equal(
                got["mlp"]["wi"].numpy(), ref[stack]["blocks"]["mlp"]["wi"][i])
    np.testing.assert_array_equal(
        pair.params["decoder"]["blocks"]["layer_01"]["xattn"]["wk"].numpy(),
        ref["decoder"]["blocks"]["xattn"]["wk"][1])
    np.testing.assert_array_equal(pair.params["frontend"]["adapter"].numpy(),
                                  ref["frontend"]["adapter"])
    np.testing.assert_array_equal(
        pair.params["encoder"]["final_norm"]["scale"].numpy(),
        ref["encoder"]["final_norm"]["scale"])


def test_reference_caches_continue_in_the_port(pair):
    """A run started in the reference continues in the port: the
    reference's prefill caches (``{"self", "cross"}`` stacked over the
    layers) carried across by ``convert.decode_caches`` give the port's
    decode step the reference's logits."""
    toks = pair.prompt(9, seed=9)
    frames = pair.embeds(13, seed=9)
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(toks),
                              frames=frames)
    caches = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc),
                                   device="cpu")
    assert sorted(caches["layer_00"]) == ["cross", "self"]
    assert caches["layer_00"]["self"]["k"].shape == (1, MAX_LEN, 2, 16)
    assert caches["layer_00"]["cross"]["k"].shape == (1, 13, 2, 16)
    tok = int(np.argmax(np.asarray(rl[0], np.float32)))
    want, rc2 = pair.ref_decode(pair.ref_params,
                                jnp.asarray([[tok]], jnp.int32), rc,
                                jnp.asarray([[9]], jnp.int32))
    got, caches = pair.model.decode_step(pair.params, torch.tensor([[tok]]),
                                         caches, torch.tensor([[9]]))
    close(got, want, "decode from the reference's caches")
    want_c = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc2),
                                   device="cpu")
    for name in caches:
        for g, w in zip(_flat_caches(caches[name]), _flat_caches(
                want_c[name])):
            close(g, w, f"cache {name} after one step")


def test_prefill_needs_frames(pair):
    with pytest.raises(ValueError, match="frames"):
        pair.model.prefill(pair.params, _tok(pair.prompt(3, seed=0)))


def test_decode_only_caches_have_the_reference_shapes(pair):
    """``init_decode_caches``: self and cross caches of ``max_len``
    positions per decoder layer, bf16, as the reference's (stacked)."""
    ref = pair.ref.init_decode_caches(2, 24)
    got = pair.model.init_decode_caches(2, 24, "cpu")
    assert sorted(got) == ["layer_00", "layer_01"]
    for name in got:
        for part in ("self", "cross"):
            for kv in ("k", "v"):
                t = got[name][part][kv]
                assert (2,) + tuple(t.shape) == \
                    tuple(ref[part][kv].shape) and t.dtype == torch.bfloat16
                assert not t.any()
