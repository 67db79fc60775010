"""The port's LM substrate (configs, schema, layers, attention, RG-LRU
block, Mamba2 block, transformer, model) on the CPU against the JAX
reference, for ``recurrentgemma-2b.reduced()`` (hybrid: rec, rec, attn
with a local window of 32), ``smollm-360m.reduced()`` (dense GQA),
``mamba2-2.7b.reduced()`` (ssm: 2 layers, 8 SSD heads, chunk 8) and
``internvl2-1b.reduced()`` (vlm: qkv bias, 8 projected patch embeddings
prepended to the text), with the reference's parameters carried across by
``convert.model_params``.  ``tests/test_torch_moe.py`` and
``tests/test_torch_encdec.py`` hold the moe and enc-dec families with the
helpers here.

The reference's mamba2 cannot prefill a prompt longer than its chunk
whose length is not a multiple of it (ROADMAP.md queue 3, R6), so its
prefill comparisons use lengths it takes, and the R6 test holds the
port's ragged prefill against the reference's prefill of a whole number
of chunks followed by teacher-forced decode steps.

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
from repro.models import layers as ref_layers
from repro_torch import convert
from repro_torch.configs import arch_ids, get
from repro_torch.models import build
from repro_torch.models import layers as port_layers
from repro_torch.models.schema import leaves

CTX = ShardingCtx()
BF16_EPS = 2.0 ** -7
TOL_EPS = 8
#: f32 compute in both packages: relative to the largest value (the SSD
#: kernel tests' rtol)
F32_REL = 1e-4
ARCHS = ("recurrentgemma-2b", "smollm-360m")
SSM_ARCH = "mamba2-2.7b"
VLM_ARCH = "internvl2-1b"
#: patch embeddings of the vlm's prefill (its reduced frontend_tokens)
VLM_PATCHES = 8
MAX_LEN = 96


def close(got, want, what, tol_eps=TOL_EPS):
    """Fail unless ``got`` is within ``tol_eps`` bf16 epsilons of the
    largest |want|."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    tol = tol_eps * BF16_EPS * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


def _flat_caches(c):
    if isinstance(c, dict):
        return [t for k in sorted(c) for t in _flat_caches(c[k])]
    if isinstance(c, (tuple, list)):
        return [t for x in c for t in _flat_caches(x)]
    return [c]


class Pair:
    """One config in both packages with the same parameters; ``replace``
    sets config fields in both."""

    def __init__(self, arch, **replace):
        self.ref_cfg = dataclasses.replace(ref_get(arch).reduced(), **replace)
        self.cfg = dataclasses.replace(get(arch).reduced(), **replace)
        self.ref = ref_build(self.ref_cfg)
        self.model = build(self.cfg)
        self.ref_params = self.ref.init(jax.random.PRNGKey(0))
        self.params = convert.model_params(
            self.cfg, jax.tree.map(np.asarray, self.ref_params),
            device="cpu")
        prefill = jax.jit(
            lambda p, inputs: self.ref.prefill(p, inputs, CTX,
                                               pad_cache_to=MAX_LEN))
        self.ref_prefill = lambda p, t, **extra: prefill(
            p, {"tokens": t, **{k: jnp.asarray(v) for k, v in extra.items()}})
        self.ref_decode = jax.jit(
            lambda p, t, c, pos: self.ref.decode_step(p, t, c, pos, CTX))

    def prompt(self, n, seed):
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.cfg.vocab_size, (1, n)).astype(np.int32)

    def embeds(self, n, seed):
        """[1, n, d] f32 patch embeddings or frames."""
        rng = np.random.default_rng(seed)
        return rng.standard_normal((1, n, self.cfg.d_model)).astype(
            np.float32)

    def prefill(self, toks, pad_cache_to=None, **extra):
        """The port's prefill of numpy tokens and inputs."""
        return self.model.prefill(
            self.params, _tok(toks), pad_cache_to=pad_cache_to,
            **{k: torch.from_numpy(v) for k, v in extra.items()})


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module")
def ssm_pair():
    return Pair(SSM_ARCH)


def _tok(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _prefill_matches(pair, n, **extra):
    toks = pair.prompt(n, seed=n)
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(toks), **extra)
    logits, caches = pair.prefill(toks, pad_cache_to=MAX_LEN, **extra)
    close(logits, rl, f"prefill logits n={n}")
    want = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc),
                                 device="cpu")
    assert sorted(caches) == sorted(want)
    for name in caches:
        for i, (g, w) in enumerate(zip(_flat_caches(caches[name]),
                                       _flat_caches(want[name]))):
            close(g, w, f"cache {name}[{i}] n={n}")


@pytest.mark.parametrize("n", [5, 40, 70])
def test_prefill_logits_and_caches_match_reference(pair, n):
    """Prompts below (5) and above (40, 70) the reduced window of 32."""
    _prefill_matches(pair, n)


@pytest.mark.parametrize("n", [5, 8, 40, 64])
def test_ssm_prefill_logits_and_caches_match_reference(ssm_pair, n,
                                                       monkeypatch):
    """mamba2: a prompt shorter than the chunk of 8 (one chunk of 5), one
    chunk, and several; the caches are the ``(conv, ssm)`` states.

    In bf16, as served, the logits and the conv states are held to the
    reference's bf16 values.  An SSM state sums S steps of bf16-rounded
    inputs over two layers, and the reference's own bf16 state moves from
    its f32-compute state by up to 9.0 epsilons (layer 1 at n = 64,
    measured), so the port's bf16 states are held, at the same 8
    epsilons, to the reference's f32-compute states, the function both
    round.  Then both packages compute in f32, and logits and states
    agree within ``F32_REL`` of the largest value: the algorithms are the
    same."""
    pair = ssm_pair
    toks = pair.prompt(n, seed=n)
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(toks))
    logits, caches = pair.model.prefill(pair.params, _tok(toks))
    close(logits, rl, f"prefill logits n={n}")
    with monkeypatch.context() as m:
        m.setattr(ref_layers, "COMPUTE_DTYPE", jnp.float32)
        m.setattr(port_layers, "COMPUTE_DTYPE", torch.float32)
        rl32, rc32 = pair.ref.prefill(pair.ref_params,
                                      {"tokens": jnp.asarray(toks)}, CTX)
        logits32, caches32 = pair.model.prefill(pair.params, _tok(toks))
    want = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc),
                                 device="cpu")
    want32 = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc32),
                                   device="cpu")
    assert sorted(caches) == sorted(want) == sorted(want32)
    for name in caches:
        close(caches[name][0], want[name][0], f"conv state {name} n={n}")
        close(caches[name][1], want32[name][1], f"ssm state {name} n={n}")
        for i in range(2):
            close(caches32[name][i], want32[name][i],
                  f"f32 state {name}[{i}] n={n}", tol_eps=F32_REL / BF16_EPS)
    close(logits32, rl32, f"f32 prefill logits n={n}",
          tol_eps=F32_REL / BF16_EPS)


def _offset(extra):
    """Positions taken by a prefill's patch embeddings (enc-dec frames
    take none of the decoder's)."""
    return extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0


def _decode_matches(pair, n, **extra):
    toks = pair.prompt(n, seed=100 + n)
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(toks), **extra)
    _, caches = pair.prefill(toks, pad_cache_to=MAX_LEN, **extra)
    tok = int(np.argmax(np.asarray(rl[0], np.float32)))
    for step in range(6):
        pos = _offset(extra) + n + step
        rl, rc = pair.ref_decode(pair.ref_params,
                                 jnp.asarray([[tok]], jnp.int32), rc,
                                 jnp.asarray([[pos]], jnp.int32))
        logits, caches = pair.model.decode_step(
            pair.params, torch.tensor([[tok]]), caches, torch.tensor([[pos]]))
        close(logits, rl, f"decode logits n={n} step={step}")
        tok = int(np.argmax(np.asarray(rl[0], np.float32)))


@pytest.mark.parametrize("n", [5, 40])
def test_decode_logits_match_reference_teacher_forced(pair, n):
    """Six decode steps from each package's own prefill caches, both fed
    the reference's greedy tokens."""
    _decode_matches(pair, n)


@pytest.mark.parametrize("n", [5, 40])
def test_ssm_decode_logits_match_reference_teacher_forced(ssm_pair, n):
    """mamba2: six decode steps carrying the conv and SSM states."""
    _decode_matches(ssm_pair, n)


def _decode_extends_prefill(pair, n, **extra):
    toks = pair.prompt(n + 1, seed=200 + n)
    _, caches = pair.prefill(toks[:, :n], pad_cache_to=MAX_LEN, **extra)
    logits, _ = pair.model.decode_step(
        pair.params, _tok(toks[:, n:]), caches,
        torch.tensor([[_offset(extra) + n]]))
    want, _ = pair.prefill(toks, **extra)
    close(logits, want, f"decode after prefill n={n}")


@pytest.mark.parametrize("n", [7, 31, 45])
def test_prefill_then_decode_equals_longer_prefill(pair, n):
    """Inside the port: prefill of n tokens, then one decode step of token
    n, gives the logits of a prefill of n + 1 tokens (the window of 32
    wraps the ring at n = 31 and 45)."""
    _decode_extends_prefill(pair, n)


@pytest.mark.parametrize("n", [7, 12, 45])
def test_ssm_prefill_then_decode_equals_longer_prefill(ssm_pair, n):
    """mamba2 inside the port, with ragged prefills of 13 and 46 tokens
    (chunk 8) that the reference cannot run (R6)."""
    _decode_extends_prefill(ssm_pair, n)


def test_ssm_ragged_prefill_where_reference_fails(ssm_pair):
    """R6: the reference's reduced mamba2 raises on a 12-token prefill
    (``ssd_chunked`` asserts S % chunk == 0 with chunk 8); the port
    prefills it, and its last logits and (conv, ssm) states equal the
    reference's prefill of the first 8 tokens followed by 4 teacher-forced
    decode steps."""
    pair = ssm_pair
    toks = pair.prompt(12, seed=12)
    with pytest.raises(AssertionError, match=r"\(12, 8\)"):
        pair.ref.prefill(pair.ref_params, {"tokens": jnp.asarray(toks)},
                         CTX)
    logits, caches = pair.model.prefill(pair.params, _tok(toks))
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(toks[:, :8]))
    for pos in range(8, 12):
        rl, rc = pair.ref_decode(pair.ref_params,
                                 jnp.asarray(toks[:, pos:pos + 1]), rc,
                                 jnp.asarray([[pos]], jnp.int32))
    close(logits, rl, "ragged prefill logits")
    want = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc),
                                 device="cpu")
    for name in caches:
        for i, (g, w) in enumerate(zip(_flat_caches(caches[name]),
                                       _flat_caches(want[name]))):
            close(g, w, f"ragged prefill state {name}[{i}]")


def test_ssm_block_prefill_starts_from_a_given_state(ssm_pair, monkeypatch):
    """A prefill given (conv, ssm) states, as a continued prompt would be,
    starts its scan from the SSM state, as the reference's ``ssm_block``
    does.  A = -0.05 so the given state reaches every one of the 16
    steps; both packages compute in f32 and agree within ``F32_REL`` of
    the largest value, and dropping the given state moves y by far more."""
    from repro.models.ssm import ssm_block as ref_ssm_block
    from repro_torch.models.ssm import ssm_block
    pair = ssm_pair
    cfg = pair.cfg
    lp = dict(pair.params["blocks"]["layer_00"]["ssm"])
    lp["a_log"] = torch.full_like(lp["a_log"], float(np.log(0.05)))
    rlp = {k: jnp.asarray(v.numpy()) for k, v in lp.items()}
    rng = np.random.default_rng(3)
    d_conv = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    x = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    state = (rng.standard_normal((1, cfg.conv_width - 1, d_conv)),
             rng.standard_normal((1, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state)))
    state = tuple(a.astype(np.float32) for a in state)
    with monkeypatch.context() as m:
        m.setattr(ref_layers, "COMPUTE_DTYPE", jnp.float32)
        m.setattr(port_layers, "COMPUTE_DTYPE", torch.float32)
        want = ref_ssm_block(rlp, jnp.asarray(x), pair.ref_cfg, CTX,
                             state=tuple(map(jnp.asarray, state)))
        got = ssm_block(lp, torch.from_numpy(x), cfg,
                        state=tuple(map(torch.from_numpy, state)))
        cold = ssm_block(lp, torch.from_numpy(x), cfg,
                         state=(torch.from_numpy(state[0]),
                                torch.zeros_like(torch.from_numpy(
                                    state[1]))))
    tol = F32_REL / BF16_EPS
    close(got[0], want[0], "block output", tol_eps=tol)
    close(got[1][0], want[1][0], "conv state", tol_eps=tol)
    close(got[1][1], want[1][1], "ssm state", tol_eps=tol)
    with pytest.raises(AssertionError):
        close(cold[0], want[0], "block output, state dropped", tol_eps=tol)


def _schema_matches(pair):
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


def test_schema_matches_reference(pair):
    """Same leaves, shapes and parameter count as the reference (whose
    homogeneous layers are stacked)."""
    _schema_matches(pair)


def test_ssm_schema_matches_reference(ssm_pair):
    """mamba2's blocks have ``ln1`` and ``ssm`` and no ``ln2`` or MLP."""
    _schema_matches(ssm_pair)
    assert sorted(ssm_pair.params["blocks"]["layer_00"]) == ["ln1", "ssm"]


def test_ssm_full_size_matches_reference_count():
    """mamba2-2.7b at full width and depth: 64 layers, the reference's
    2,832,074,240 parameters (counted from the schema, nothing drawn)."""
    model = build(get(SSM_ARCH))
    assert model.cfg.num_layers == 64
    assert model.param_count() == ref_build(ref_get(SSM_ARCH)).param_count() \
        == 2_832_074_240


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


FULL_ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "internvl2-1b",
              "seamless-m4t-large-v2")


def _ref_shapes(node, prefix=""):
    """``(dotted path, shape)`` of the reference's abstract parameters."""
    for key in sorted(node):
        if isinstance(node[key], dict):
            yield from _ref_shapes(node[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tuple(node[key].shape)


@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_full_size_schema_matches_reference(arch):
    """The families this slice adds at full width and depth: the same
    parameter count as the reference's schema, and each of the port's
    per-layer leaves is one layer of the reference's ``[L, ...]`` stack
    (counted from the schemas, nothing drawn)."""
    model, ref = build(get(arch)), ref_build(ref_get(arch))
    assert model.param_count() == ref.param_count()
    want = dict(_ref_shapes(ref.abstract_params()))
    got = {}
    for path, leaf in leaves(model.schema):
        parts = path.split(".")
        layer = [i for i, p in enumerate(parts) if p.startswith("layer_")]
        if layer:
            del parts[layer[0]]
        key = ".".join(parts)
        shape = leaf.shape
        if layer:
            n = got.get(key, (0,) + shape)[0] + 1
            shape = (n,) + shape
        got[key] = shape
    assert got == want


@pytest.fixture(scope="module")
def vlm_pair():
    return Pair(VLM_ARCH)


@pytest.mark.parametrize("n", [5, 40])
def test_vlm_prefill_logits_and_caches_match_reference(vlm_pair, n):
    """internvl2 with 8 patch embeddings projected and prepended: the
    caches hold 8 + n positions, all within the tolerance."""
    _prefill_matches(vlm_pair, n,
                     patch_embeds=vlm_pair.embeds(VLM_PATCHES, seed=n))


def test_vlm_text_only_prefill_matches_reference(vlm_pair):
    """Without patch embeddings (as both engines prefill) the model is
    the plain decoder."""
    _prefill_matches(vlm_pair, 12)


@pytest.mark.parametrize("n", [5, 40])
def test_vlm_decode_logits_match_reference_teacher_forced(vlm_pair, n):
    """Decode positions continue after the 8 patch positions."""
    _decode_matches(vlm_pair, n,
                    patch_embeds=vlm_pair.embeds(VLM_PATCHES, seed=50 + n))


@pytest.mark.parametrize("n", [7, 31])
def test_vlm_prefill_then_decode_equals_longer_prefill(vlm_pair, n):
    _decode_extends_prefill(vlm_pair, n, patch_embeds=vlm_pair.embeds(
        VLM_PATCHES, seed=70 + n))


def test_vlm_schema_matches_reference(vlm_pair):
    """The frontend's projection is a leaf of both, at [d, d]."""
    _schema_matches(vlm_pair)
    assert vlm_pair.params["frontend"]["proj"].shape == (64, 64)


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


def test_grouped_ssm_config_refused_by_build():
    """P1: a Mamba2 config with ``ssm_groups`` = 2 is refused by ``build``,
    before any prefill or decode, with a message naming the reference's
    grouped decode fault (R7)."""
    cfg = dataclasses.replace(get(SSM_ARCH).reduced(), ssm_groups=2)
    with pytest.raises(NotImplementedError, match="R7"):
        build(cfg)


def _decode_spread(prefill, decode, toks):
    """max |logits| difference between a prefill of 7 tokens followed by
    one decode step of token 8 and a prefill of all 8 tokens."""
    f32 = lambda a: np.asarray(a.float() if isinstance(a, torch.Tensor)
                               else a, np.float32)
    _, caches = prefill(toks[:, :7])
    stepped = decode(toks[:, 7:], caches)
    whole = prefill(toks)[0]
    return float(np.max(np.abs(f32(stepped) - f32(whole))))


def test_ssm_bf16_spread_at_full_depth_is_the_references():
    """P2: does the port part a prefill plus a decode step from the longer
    prefill by more than the reference does, at full depth in bf16?
    ``mamba2-2.7b.reduced()`` with ``num_layers=64`` in both packages from
    the same weights; for four token draws, a 7-token prefill and one decode
    step against an 8-token prefill (lengths the reference takes: R6).  The
    port's largest logit difference between the two orders must be at most
    twice the reference's (a factor fixed before any run).  Measured on the
    CPU (largest logit 2.2-3.1, so the 8-epsilon bound is 0.14-0.19): the
    reference 0.0234, 0.2012, 0 and 0; the port 0 at all four.  The spread
    is the reference's own (its worst, 0.2012, is 1.2x its bound), so
    chip_smoke.py keeps its full-width decode check in f32 compute."""
    ref_cfg = dataclasses.replace(ref_get(SSM_ARCH).reduced(), num_layers=64)
    cfg = dataclasses.replace(get(SSM_ARCH).reduced(), num_layers=64)
    ref, model = ref_build(ref_cfg), build(cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = convert.model_params(cfg, jax.tree.map(np.asarray, ref_params),
                                  device="cpu")
    ref_prefill = jax.jit(lambda t: ref.prefill(ref_params, {"tokens": t},
                                                CTX, pad_cache_to=16))
    ref_decode = jax.jit(lambda t, c: ref.decode_step(
        ref_params, t, c, jnp.asarray([[7]], jnp.int32), CTX)[0])
    ref_spread, port_spread = [], []
    for seed in range(4):
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, 8)).astype(np.int32)
        ref_spread.append(_decode_spread(
            lambda t: ref_prefill(jnp.asarray(t)),
            lambda t, c: ref_decode(jnp.asarray(t), c), toks))
        port_spread.append(_decode_spread(
            lambda t: model.prefill(params, _tok(t), pad_cache_to=16),
            lambda t, c: model.decode_step(params, _tok(t), c,
                                           torch.tensor([[7]]))[0], toks))
    assert np.all(np.isfinite(port_spread)) and max(ref_spread) > 0
    assert max(port_spread) <= 2 * max(ref_spread), (port_spread, ref_spread)
