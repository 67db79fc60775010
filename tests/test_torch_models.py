"""The port's LM substrate (configs, schema, layers, attention, RG-LRU
block, transformer, model) on the CPU against the JAX reference, for
``recurrentgemma-2b.reduced()`` (hybrid: rec, rec, attn with a local
window of 32) and ``smollm-360m.reduced()`` (dense GQA), with the
reference's parameters carried across by ``convert.model_params``.

Tolerance (bf16): both packages compute on bf16 operands, but XLA's CPU
backend keeps excess f32 precision inside fused elementwise chains where
PyTorch rounds every op, and the matmuls sum in other orders.  A compared
tensor must lie within ``TOL_EPS`` bf16 epsilons (2^-7) of the largest
magnitude of the reference's tensor.  The reference itself moves by up to
3.3 such epsilons when its compute dtype is switched from bf16 to f32
(measured on these configs' prefill logits, prompts of 5, 40 and 70
tokens), so 8 leaves a margin of about 2x over the reference's own bf16
rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import ShardingCtx
from repro.models import build as ref_build
from repro_torch import convert
from repro_torch.configs import arch_ids, get
from repro_torch.models import build
from repro_torch.models.schema import leaves

CTX = ShardingCtx()
BF16_EPS = 2.0 ** -7
TOL_EPS = 8
ARCHS = ("recurrentgemma-2b", "smollm-360m")
MAX_LEN = 96


def close(got, want, what):
    """Fail unless ``got`` is within TOL_EPS bf16 epsilons of the largest
    |want|."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    tol = TOL_EPS * BF16_EPS * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


def _flat_caches(c):
    if isinstance(c, dict):
        return [t for k in sorted(c) for t in _flat_caches(c[k])]
    if isinstance(c, (tuple, list)):
        return [t for x in c for t in _flat_caches(x)]
    return [c]


class Pair:
    """One config in both packages with the same parameters."""

    def __init__(self, arch):
        self.ref_cfg = ref_get(arch).reduced()
        self.cfg = get(arch).reduced()
        self.ref = ref_build(self.ref_cfg)
        self.model = build(self.cfg)
        self.ref_params = self.ref.init(jax.random.PRNGKey(0))
        self.params = convert.model_params(
            self.cfg, jax.tree.map(np.asarray, self.ref_params),
            device="cpu")
        self.ref_prefill = jax.jit(
            lambda p, t: self.ref.prefill(p, {"tokens": t}, CTX,
                                          pad_cache_to=MAX_LEN))
        self.ref_decode = jax.jit(
            lambda p, t, c, pos: self.ref.decode_step(p, t, c, pos, CTX))

    def prompt(self, n, seed):
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.cfg.vocab_size, (1, n)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def _tok(a):
    return torch.as_tensor(np.asarray(a, np.int64))


@pytest.mark.parametrize("n", [5, 40, 70])
def test_prefill_logits_and_caches_match_reference(pair, n):
    """Prompts below (5) and above (40, 70) the reduced window of 32."""
    toks = pair.prompt(n, seed=n)
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(toks))
    logits, caches = pair.model.prefill(pair.params, _tok(toks),
                                        pad_cache_to=MAX_LEN)
    close(logits, rl, f"prefill logits n={n}")
    want = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc),
                                 device="cpu")
    assert sorted(caches) == sorted(want)
    for name in caches:
        for i, (g, w) in enumerate(zip(_flat_caches(caches[name]),
                                       _flat_caches(want[name]))):
            close(g, w, f"cache {name}[{i}] n={n}")


@pytest.mark.parametrize("n", [5, 40])
def test_decode_logits_match_reference_teacher_forced(pair, n):
    """Six decode steps from each package's own prefill caches, both fed
    the reference's greedy tokens."""
    toks = pair.prompt(n, seed=100 + n)
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(toks))
    _, caches = pair.model.prefill(pair.params, _tok(toks),
                                   pad_cache_to=MAX_LEN)
    tok = int(np.argmax(np.asarray(rl[0], np.float32)))
    for step in range(6):
        pos = n + step
        rl, rc = pair.ref_decode(pair.ref_params,
                                 jnp.asarray([[tok]], jnp.int32), rc,
                                 jnp.asarray([[pos]], jnp.int32))
        logits, caches = pair.model.decode_step(
            pair.params, torch.tensor([[tok]]), caches, torch.tensor([[pos]]))
        close(logits, rl, f"decode logits n={n} step={step}")
        tok = int(np.argmax(np.asarray(rl[0], np.float32)))


@pytest.mark.parametrize("n", [7, 31, 45])
def test_prefill_then_decode_equals_longer_prefill(pair, n):
    """Inside the port: prefill of n tokens, then one decode step of token
    n, gives the logits of a prefill of n + 1 tokens (the window of 32
    wraps the ring at n = 31 and 45)."""
    toks = pair.prompt(n + 1, seed=200 + n)
    _, caches = pair.model.prefill(pair.params, _tok(toks[:, :n]),
                                   pad_cache_to=MAX_LEN)
    logits, _ = pair.model.decode_step(pair.params, _tok(toks[:, n:]),
                                       caches, torch.tensor([[n]]))
    want, _ = pair.model.prefill(pair.params, _tok(toks))
    close(logits, want, f"decode after prefill n={n}")


def test_schema_matches_reference(pair):
    """Same leaves, shapes and parameter count as the reference (whose
    homogeneous layers are stacked)."""
    assert pair.model.param_count() == pair.ref.param_count()
    ref_params = jax.tree.map(np.asarray, pair.ref_params)
    port = dict(leaves(pair.model.schema))
    conv = convert.model_params(pair.cfg, ref_params, device="cpu")

    def walk(node, prefix=""):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    got = dict(walk(conv))
    assert sorted(got) == sorted(port)
    for path, leaf in port.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert got[path].dtype == leaf.dtype, path


def test_init_draws_from_the_generator():
    cfg = get("recurrentgemma-2b").reduced()
    model = build(cfg)
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    c = model.init(torch.Generator().manual_seed(4))
    w = "blocks.layer_00.rec.wx".split(".")
    pick = lambda p: p[w[0]][w[1]][w[2]][w[3]]
    assert torch.equal(pick(a), pick(b)) and not torch.equal(pick(a),
                                                              pick(c))
    # fan-in normal: std 1/sqrt(d_model); norms start at one, biases at 0
    assert abs(pick(a).std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.1
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert not a["blocks"]["layer_00"]["rec"]["conv_b"].any()
    assert abs(a["embedding"]["embed"].std().item() - 0.02) < 0.002


@pytest.mark.parametrize("arch", sorted(arch_ids()))
def test_configs_equal_reference(arch):
    want = dataclasses.asdict(ref_get(arch))
    assert dataclasses.asdict(get(arch)) == want
    assert get(arch).param_count() == ref_get(arch).param_count()
    assert dataclasses.asdict(get(arch).reduced()) == \
        dataclasses.asdict(ref_get(arch).reduced())


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "olmoe-1b-7b",
                                  "llama4-scout-17b-a16e",
                                  "seamless-m4t-large-v2", "internvl2-1b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(get(arch))


def test_padded_vocab_masked_like_reference():
    """A vocabulary that is not a multiple of 256 (no buildable arch has
    one): the padding columns of the logits are -1e9 (in bf16) in both
    packages and the rest agree."""
    ref_cfg = dataclasses.replace(ref_get("smollm-360m").reduced(),
                                  vocab_size=250)
    cfg = dataclasses.replace(get("smollm-360m").reduced(), vocab_size=250)
    ref_model = ref_build(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(1))
    params = convert.model_params(cfg, jax.tree.map(np.asarray, ref_params),
                                  device="cpu")
    toks = np.arange(9, dtype=np.int32)[None] * 7 % 250
    rl, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)}, CTX)
    logits, _ = build(cfg).prefill(params, _tok(toks))
    assert logits.shape == (1, 256)
    assert torch.all(logits[:, 250:] == torch.tensor(-1e9).bfloat16())
    np.testing.assert_array_equal(np.asarray(rl, np.float32)[:, 250:],
                                  logits[:, 250:].float().numpy())
    close(logits[:, :250], np.asarray(rl, np.float32)[:, :250],
          "logits of a padded vocabulary")


def test_dense_variants_build():
    """qkv bias (qwen1.5) and the plain GELU MLP (starcoder2) run."""
    for arch in ("qwen1.5-110b", "starcoder2-15b"):
        cfg = get(arch).reduced()
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        logits, _ = model.prefill(params, torch.tensor([[1, 2, 3]]))
        assert logits.shape == (1, cfg.padded_vocab)
        assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
