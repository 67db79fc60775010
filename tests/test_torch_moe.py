"""The port's moe family on the CPU against the JAX reference:
``olmoe-1b-7b.reduced()`` (4 experts, top-2, gated) and
``llama4-scout-17b-a16e.reduced()`` (top-1).

The MoE block (``models/moe.py``) is held against the reference's
single-device ``_moe_local`` on the same bf16 tokens and f32 weights: the
reference's expert choices (the output of its ``jax.lax.top_k``) and its
slot of every (token, choice) pair (the indices of its combine
``jnp.take``, from which the kept mask follows) are recorded while it
runs, and the port's must equal them exactly, as must the dropped share.
The load-balancing loss ``aux`` sums f32 router probabilities: XLA's CPU
backend and PyTorch take the router's f32 product and softmax in other
orders and with other ``exp`` implementations (they differ by a few ulps
in the probabilities), so ``aux`` is held within ``AUX_REL`` (8 f32
ulps) while its count part, the share of choices per expert, is held
exactly.  The block's output is held at the model tolerance
(``TOL_EPS`` bf16 epsilons of its largest value).

The models' logits and caches are held as in ``tests/test_torch_models.py``
(prefill and teacher-forced decode), with the router input, probabilities
and expert choices of every layer recorded in both packages.  The
residual stream is bf16, and the two packages round it at other places,
so a token whose k-th and (k+1)-th probabilities nearly tie may pick
another expert in each (one such token moves its layer's output by a
whole expert's share).  Where the choices differ, the port's router, run
on the reference's router input, must pick the reference's experts (or,
at a tie of its f32 arithmetic, experts within a few f32 ulps of them:
``routes.parted``), and the port runs again on the reference's choices,
its outputs held there.  A prefill followed by a decode step
equals the longer prefill with ``moe_capacity_factor=8.0``, as the
reference's own test sets it (``tests/test_models_smoke.py``): at 1.25 the
capacity drops of a prefill differ from a decode step's by design."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import moe as ref_moe
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.models import moe, routes
from repro_torch.models.routes import Routes
from test_torch_models import (CTX, MAX_LEN, Pair,
                               _decode_extends_prefill, _schema_matches,
                               close)

ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
#: aux within 8 f32 ulps of the reference's (see the module docstring)
AUX_REL = 8 * 2.0 ** -23
#: router cases: random weights; one expert column copied into the next
#: (every token sees a tie at the copied pair); all zero (every
#: probability 1/E: the experts are 0..k-1); tokens that all prefer the
#: same experts, so that capacity binds
CASES = ("random", "duplicate expert", "zero router", "capacity binds")


def _inputs(cfg, case, t, seed=0):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (0.3 * rng.standard_normal((d, e))).astype(np.float32)
    if case == "duplicate expert":
        router[:, 2] = router[:, 1]
    elif case == "zero router":
        router[:] = 0.0
    elif case == "capacity binds":
        x = (rng.standard_normal((1, d)) + 0.1 * x).astype(np.float32)
    w = {"wi": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    # the tokens as the block receives them: bf16 from the norm
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return xb, router, w


def _reference(monkeypatch, ref_cfg, xb, router, w, cap):
    """Run the reference's ``_moe_local`` eagerly and record its expert
    choices and its combine's slot indices."""
    seen = {}
    top_k, take = jax.lax.top_k, jnp.take

    def rec_top_k(x, k):
        seen["top_e"] = np.asarray(top_k(x, k)[1])
        return top_k(x, k)

    def rec_take(a, idx, *args, **kw):
        seen.setdefault("take", []).append(np.asarray(idx))
        return take(a, idx, *args, **kw)
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(jnp, "take", rec_take)
        out, aux, dropped = ref_moe._moe_local(
            jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(router),
            jnp.asarray(w["wi"]), jnp.asarray(w["wg"]) if ref_cfg.mlp_gated
            else None, jnp.asarray(w["wo"]), ref_cfg, ref_cfg.num_experts, 0,
            cap)
    # the second take is the combine's: its indices are the slots
    return out, float(aux), float(dropped), seen["top_e"], seen["take"][1]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, case, monkeypatch):
    ref_cfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
    t = 40
    cap = moe.capacity(t, cfg)
    assert cap == ref_moe._capacity(t, ref_cfg)
    xb, router, w = _inputs(cfg, case, t)
    r_out, r_aux, r_dropped, r_top_e, r_dest = _reference(
        monkeypatch, ref_cfg, xb, router, w, cap)

    xt = torch.from_numpy(xb).bfloat16()
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    _, _, top_e = moe.route(xt, torch.from_numpy(router), cfg)
    dest, keep = moe.dispatch(top_e, cfg.num_experts, cap)
    out, aux, dropped = moe.moe_local(
        xt, torch.from_numpy(router), tw["wi"],
        tw["wg"] if cfg.mlp_gated else None, tw["wo"], cfg, cap)

    np.testing.assert_array_equal(top_e.numpy(), r_top_e)
    np.testing.assert_array_equal(dest.numpy(), r_dest)
    np.testing.assert_array_equal(keep.numpy(),
                                  r_dest < cfg.num_experts * cap)
    assert float(dropped) == r_dropped
    counts = np.bincount(r_top_e.reshape(-1), minlength=cfg.num_experts)
    np.testing.assert_array_equal(
        np.bincount(top_e.numpy().reshape(-1), minlength=cfg.num_experts),
        counts)
    assert abs(float(aux) - r_aux) <= AUX_REL * abs(r_aux), (aux, r_aux)
    close(out, r_out, f"{arch} {case} block output")
    k = cfg.experts_per_token
    if case == "zero router":
        assert np.all(r_top_e == np.arange(k))
    if case == "duplicate expert" and k > 1:
        # experts 1 and 2 tie for every token; when both are chosen the
        # lower comes first
        both = (r_top_e == 1).any(1) & (r_top_e == 2).any(1)
        assert both.any()
        first = [list(row).index(1) < list(row).index(2)
                 for row in r_top_e[both]]
        assert all(first)
    if case == "capacity binds":
        assert r_dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_shape_and_aux(arch):
    """``moe_block`` on [B, S, d] routes the B*S tokens together (one
    capacity for the batch) and returns the reference's aux."""
    from repro.models.moe import moe_block as ref_block
    ref_cfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
    xb, router, w = _inputs(cfg, "random", 24, seed=3)
    params = {"router": router, **w}
    if not cfg.mlp_gated:
        del params["wg"]
    r_out, r_aux = ref_block({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(xb.reshape(2, 12, -1)).astype(
                                 jnp.bfloat16), ref_cfg, CTX)
    out, aux = moe.moe_block({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(xb.reshape(2, 12, -1)).bfloat16(),
                             cfg)
    assert out.shape == (2, 12, cfg.d_model) and out.dtype == torch.bfloat16
    close(out, r_out, f"{arch} moe_block")
    assert abs(float(aux) - float(r_aux)) <= AUX_REL * abs(float(r_aux))


def test_top_k_order_is_jax_lax_top_k():
    """64 equal probabilities, top-8: ``jax.lax.top_k`` takes experts 0..7,
    and so does the port's router (``torch.topk`` need not)."""
    cfg = dataclasses.replace(get("olmoe-1b-7b"), d_model=16)
    xt = torch.ones((3, 16), dtype=torch.bfloat16)
    probs, top_w, top_e = moe.route(xt, torch.zeros((16, 64)), cfg)
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 8)[1])
    np.testing.assert_array_equal(top_e.numpy(), want)
    np.testing.assert_array_equal(top_e.numpy(), np.tile(np.arange(8),
                                                          (3, 1)))
    assert torch.allclose(top_w, torch.full((3, 8), 1 / 8))


class RefRoutes:
    """The reference's router input, probabilities and expert choices of
    every MoE layer, in call order, recorded by debug callbacks inside its
    jitted program into a :class:`routes.Routes` for :func:`routes.parted`.
    """

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.seen = Routes()

    def _input(self, xt):
        self.seen.xt.append(torch.from_numpy(np.asarray(xt, np.float32))
                            .bfloat16())

    def _choice(self, probs, e):
        self.seen.probs.append(torch.from_numpy(np.array(probs)))
        self.seen.own.append(torch.from_numpy(np.array(e)).long())

    def call(self, fn, *args):
        """``fn`` is jitted: its program, traced at its first call, keeps
        calling the callbacks at every later call, into ``self.seen`` as
        it then is."""
        top_k, local = jax.lax.top_k, ref_moe._moe_local

        def rec_top_k(x, k):
            w, e = top_k(x, k)
            jax.debug.callback(self._choice, x, e, ordered=True)
            return w, e

        def rec_local(xt, *rest):
            jax.debug.callback(self._input, xt, ordered=True)
            return local(xt, *rest)
        self.seen = Routes()
        with self.mp.context() as m:
            m.setattr(jax.lax, "top_k", rec_top_k)
            m.setattr(ref_moe, "_moe_local", rec_local)
            out = fn(*args)
            jax.effects_barrier()
        return out, self.seen


def _routed(ref, cfg, what, ref_fn, ref_args, port_fn, check):
    """Run the reference and the port, both routers recorded; where the
    port's expert choices differ from the reference's, they must part only
    because the router's input does (:func:`routes.parted`), and the port
    runs again on the reference's choices.  ``check`` compares the
    outputs."""
    want, ref_routes = ref.call(ref_fn, *ref_args)
    with Routes() as own:
        got = port_fn()
    reports = routes.parted(own, ref_routes, cfg, what)
    if not any(r["sets"] or r["order"] for r in reports):
        return check(got, want)
    with Routes(forced=ref_routes.own):
        got = port_fn()
    warnings.warn(f"{what}: the port's experts part from the reference's "
                  f"only where the router's input does (per layer: "
                  f"{reports}); held on the reference's choices")
    return check(got, want)


def _one_call(xt, w, cfg):
    """One router call on the CPU, recorded."""
    with Routes() as r:
        moe.route(xt, w, cfg)
    return r


@pytest.mark.parametrize("arch", ARCHS)
def test_parted_accepts_choices_that_follow_the_input(arch):
    """Side B's router input differs at two tokens (another token's row):
    its experts differ there, and A's router on B's input picks them."""
    cfg = get(arch).reduced()
    xb, router, _ = _inputs(cfg, "random", 40, seed=5)
    xt, w = torch.from_numpy(xb).bfloat16(), torch.from_numpy(router)
    a = _one_call(xt, w, cfg)
    moved = xt.clone()
    moved[[3, 17]] = xt[[30, 31]]
    b = _one_call(moved, w, cfg)
    differ = (a.own[0] != b.own[0]).any(1)
    assert bool(differ[[3, 17]].any()) and not bool(
        differ[[i for i in range(40) if i not in (3, 17)]].any())
    rep, = routes.parted(a, b, cfg, arch)
    assert rep["by_input"] == int(differ.sum()) and rep["ulps"] == 0.0
    assert rep["router_ulps"] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_parted_refuses_a_router_that_differs(arch):
    """Side B's router swaps two experts' columns: on one input the
    choices differ and A's router does not pick B's, so ``parted``
    fails."""
    cfg = get(arch).reduced()
    xb, router, _ = _inputs(cfg, "random", 40, seed=6)
    xt = torch.from_numpy(xb).bfloat16()
    a = _one_call(xt, torch.from_numpy(router), cfg)
    b = _one_call(xt, torch.from_numpy(router[:, [1, 0, 2, 3] + list(
        range(4, cfg.num_experts))].copy()), cfg)
    assert bool((a.own[0] != b.own[0]).any())
    with pytest.raises(AssertionError, match="take other experts"):
        routes.parted(a, b, cfg, arch)


def test_parted_allows_an_f32_tie():
    """Experts 1 and 2 tie exactly (a copied column): a router whose
    arithmetic broke the tie the other way (B's choices with 1 and 2
    swapped) parts from A's on one input within ``TIE_ULPS``."""
    cfg = get("olmoe-1b-7b").reduced()
    xb, router, _ = _inputs(cfg, "duplicate expert", 40, seed=7)
    xt = torch.from_numpy(xb).bfloat16()
    a = _one_call(xt, torch.from_numpy(router), cfg)
    b = _one_call(xt, torch.from_numpy(router), cfg)
    swap = torch.tensor([0, 2, 1, 3])
    b.own[0] = swap[b.own[0]]
    differ = (a.own[0] != b.own[0]).any(1)
    assert bool(differ.any())
    rep, = routes.parted(a, b, cfg, "f32 tie")
    assert rep["by_input"] == 0 and rep["ulps"] <= routes.TIE_ULPS
    assert rep["sets"] + rep["order"] == int(differ.sum())


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module", params=ARCHS)
def roomy_pair(request):
    """Capacity factor 8: no token is dropped at any batch."""
    return Pair(request.param, moe_capacity_factor=8.0)


@pytest.mark.parametrize("n", [5, 40, 70])
def test_prefill_logits_and_caches_match_reference(pair, n, monkeypatch):
    """At 40 and 70 tokens the reduced capacity (25 and 43 slots of 4
    experts at top-2, 12 and 21 at top-1) can drop tokens; both packages
    drop the same ones."""
    toks = pair.prompt(n, seed=n)
    ref_prefill = jax.jit(lambda p, t: pair.ref.prefill(
        p, {"tokens": t}, CTX, pad_cache_to=MAX_LEN))

    def check(got, want):
        (logits, caches), (rl, rc) = got, want
        close(logits, rl, f"prefill logits n={n}")
        want_c = convert.decode_caches(pair.cfg, jax.tree.map(np.asarray, rc),
                                       device="cpu")
        assert sorted(caches) == sorted(want_c)
        for name in caches:
            for kv in ("k", "v"):
                close(caches[name][kv], want_c[name][kv],
                      f"cache {name}.{kv} n={n}")
    _routed(RefRoutes(monkeypatch), pair.cfg,
            f"{pair.cfg.name} prefill n={n}",
            ref_prefill, (pair.ref_params, jnp.asarray(toks)),
            lambda: pair.prefill(toks, pad_cache_to=MAX_LEN), check)


@pytest.mark.parametrize("n", [5, 40])
def test_decode_logits_match_reference_teacher_forced(pair, n, monkeypatch):
    """Six decode steps (one token: 8 slots an expert, nothing dropped)
    from each package's own prefill caches, both fed the reference's
    greedy tokens; each step routed as the prefill is."""
    ref = RefRoutes(monkeypatch)
    toks = pair.prompt(n, seed=100 + n)
    ref_prefill = jax.jit(lambda p, t: pair.ref.prefill(
        p, {"tokens": t}, CTX, pad_cache_to=MAX_LEN))
    ref_decode = jax.jit(lambda p, t, c, pos: pair.ref.decode_step(
        p, t, c, pos, CTX))
    state = {}

    def keep(got, want):
        state["caches"], state["rc"] = got[1], want[1]
        state["tok"] = int(np.argmax(np.asarray(want[0][0], np.float32)))
    _routed(ref, pair.cfg, f"{pair.cfg.name} prefill n={n}", ref_prefill,
            (pair.ref_params, jnp.asarray(toks)),
            lambda: pair.prefill(toks, pad_cache_to=MAX_LEN), keep)
    for step in range(6):
        pos, tok = n + step, state["tok"]

        def check(got, want, step=step):
            close(got[0], want[0], f"decode logits n={n} step={step}")
            keep(got, want)
        _routed(ref, pair.cfg, f"{pair.cfg.name} decode n={n} step={step}",
                ref_decode, (pair.ref_params, jnp.asarray([[tok]], jnp.int32),
                             state["rc"], jnp.asarray([[pos]], jnp.int32)),
                lambda: pair.model.decode_step(
                    pair.params, torch.tensor([[tok]]), state["caches"],
                    torch.tensor([[pos]])), check)


@pytest.mark.parametrize("n", [7, 31, 45])
def test_prefill_then_decode_equals_longer_prefill(roomy_pair, n):
    _decode_extends_prefill(roomy_pair, n)


def test_schema_matches_reference(pair):
    """The stacked moe leaves (``router``, ``wi``, ``wg``, ``wo``) carry
    across one layer at a time, bit for bit, and no block has an
    ``mlp``."""
    _schema_matches(pair)
    blk = pair.params["blocks"]["layer_01"]
    assert sorted(blk) == ["attn", "ln1", "ln2", "moe"]
    want = ["router", "wg", "wi", "wo"] if pair.cfg.mlp_gated else \
        ["router", "wi", "wo"]
    assert sorted(blk["moe"]) == want
    for i in range(pair.cfg.num_layers):
        for name in want:
            np.testing.assert_array_equal(
                pair.params["blocks"][f"layer_{i:02d}"]["moe"][name].numpy(),
                np.asarray(pair.ref_params["blocks"]["moe"][name])[i])


def test_capacity_drops_change_with_the_batch():
    """Why the roomy config: at the reduced config's factor 1.25 a 45-token
    prefill drops (token, choice) pairs that a decode step (one token,
    8 slots an expert) never drops, so the two orders may part; at 8.0
    nothing is dropped in either."""
    for factor, dropped in ((1.25, True), (8.0, False)):
        cfg = dataclasses.replace(get("olmoe-1b-7b").reduced(),
                                  moe_capacity_factor=factor)
        xb, router, _ = _inputs(cfg, "capacity binds", 45)
        _, _, top_e = moe.route(torch.from_numpy(xb).bfloat16(),
                                torch.from_numpy(router), cfg)
        _, keep = moe.dispatch(top_e, cfg.num_experts,
                               moe.capacity(45, cfg))
        assert bool((~keep).any()) == dropped
        assert moe.capacity(1, cfg) == 8
