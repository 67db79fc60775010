"""The port's training path on the CPU against the JAX reference:
``SyntheticLM``, ``AdamW`` and its schedules, ``global_norm``,
``compress_tree``, ``Model.loss`` and its gradient for every family
(dense ``smollm-360m``, moe ``olmoe-1b-7b``, hybrid ``recurrentgemma-2b``,
ssm ``mamba2-2.7b``, vlm ``internvl2-1b``, enc-dec
``seamless-m4t-large-v2``, all ``.reduced()``), ``make_train_step``, the
three kernel wrappers' ``torch.autograd.Function``s (run here with their
plain forwards) and the launcher.  Inputs are made with numpy from a
seed, parameters are the reference's carried across by
``convert.model_params``.

Tolerances, each stated with its reason:

* optimizer, schedules, ``global_norm`` and ``compress_tree`` from the
  same f32 inputs: ``ULPS`` = 2 f32 ulps of the reference's value (the
  same operations in the same order; ``pow``, ``cos`` and the order of
  the norm's sums may each round once otherwise); int8 payloads exactly.
* the loss: ``TOL_EPS`` = 8 bf16 epsilons of |loss|, the bound
  ``tests/test_torch_models.py`` holds logits to (measured: at most 0.03).
* each gradient leaf: within ``GRAD_EPS`` = 16 bf16 epsilons of the
  leaf's largest reference magnitude.  The reference's own gradients move
  by 8.3 such epsilons when its compute dtype is switched from bf16 to
  f32 (recurrentgemma-2b on this file's batch, the largest of the
  families; ``test_reference_own_bf16_gradient_spread_fits_the_bound``),
  so 16 leaves about the same 2x margin over the reference's own bf16
  rounding as ``TOL_EPS`` does; the port's worst leaf measured 7.9 there
  (7.3 mamba2-2.7b, 1.3-2.7 the others).  MoE is held on the reference's
  experts where the two routers' bf16 inputs part
  (``tests/test_torch_moe.py``'s ``_routed``).
* one train step end to end: the reference's own bound for a first Adam
  step (``tests/test_train_substrate.py``: 5e-2 at lr 1e-2: Adam's first
  step divides each gradient by its own magnitude, so bf16 noise on a
  near-zero gradient moves a parameter by up to lr); 8 steps' losses
  within rel 2e-2 (the same file's loss bound).
* the ``Function``s' backwards in f32: ``F32`` (atol 1e-5, rtol 1e-4, the
  kernel tests' tolerance) against autograd of the plain version and
  ``jax.vjp`` of the reference's function.

The reference's mamba2 asserts ``S % ssm_chunk == 0`` in training (R6), so
its batches are whole chunks."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs.shapes import ShapeSpec as RefShape
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models import build as ref_build
from repro.models.rglru import lru_scan as jax_lru_scan
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.train import AdamW as RefAdamW
from repro.train import SyntheticLM as RefSyntheticLM
from repro.train import constant_schedule as ref_constant
from repro.train import cosine_schedule as ref_cosine
from repro.train import global_norm as ref_global_norm
from repro.train import grad_compress as ref_gc
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan.ref import lru_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.models import build
from repro_torch.models.routes import Routes
from repro_torch.train import (
    AdamW, AdamWState, SyntheticLM, constant_schedule, cosine_schedule,
    global_norm, grad_compress, init_state, make_train_step,
)
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.train_step import TrainState, value_and_grad
from test_torch_models import CTX, BF16_EPS, TOL_EPS
from test_torch_moe import RefRoutes, _routed

ULPS = 2
GRAD_EPS = 16
F32 = dict(atol=1e-5, rtol=1e-4)
#: (arch, seq_len) per family: mamba2 two whole chunks of 8, the hybrid
#: past its reduced window of 32, the vlm 8 patches + 16 tokens
FAMILIES = {"dense": ("smollm-360m", 16), "moe": ("olmoe-1b-7b", 16),
            "hybrid": ("recurrentgemma-2b", 40), "ssm": ("mamba2-2.7b", 16),
            "vlm": ("internvl2-1b", 24),
            "encdec": ("seamless-m4t-large-v2", 16)}


def within_ulps(got, want, what, ulps=ULPS):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = ulps * np.spacing(np.abs(want))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{what}: {int(bad.sum())} values beyond {ulps} "
                           f"f32 ulps, worst diff "
                           f"{float(np.abs(got - want).max())}")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "internvl2-1b",
                                  "seamless-m4t-large-v2"])
def test_synthetic_batches_byte_identical(arch):
    ref_src = RefSyntheticLM(ref_get(arch).reduced(), RefShape("t", 24, 3,
                                                                "train"))
    src = SyntheticLM(get(arch).reduced(), ShapeSpec("t", 24, 3, "train"))
    for step in (0, 7):
        want, got = ref_src.batch_for_step(step), src.batch_for_step(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (arch, step, k)
        placed, ref_placed = src.place(got, "cpu"), ref_src.place(want, CTX)
        for k in want:
            np.testing.assert_array_equal(
                placed[k].float().numpy(),
                np.asarray(ref_placed[k], np.float32))
        assert all(v.dtype in (torch.bfloat16, torch.int64)
                   for v in placed.values())


def test_prefetcher_yields_the_steps_in_order():
    from repro_torch.train import Prefetcher
    src = SyntheticLM(get("smollm-360m").reduced(),
                      ShapeSpec("t", 8, 2, "train"))
    pre = Prefetcher(src, "cpu", start_step=3)
    try:
        for want in (3, 4, 5):
            step, batch = next(pre)
            assert step == want
            assert torch.equal(batch["tokens"], src.place(
                src.batch_for_step(want), "cpu")["tokens"])
    finally:
        pre.stop()


# -- optimizer, schedules, compression ------------------------------------------

def _tree_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (13,), "d": (3, 4, 2)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    return draw(1.0), draw(0.3), draw(0.01), draw(1e-4)


@pytest.mark.parametrize("clip,step,lr", [
    (1.0, 0, "cosine"), (None, 3, "cosine"), (1.0, 40, "cosine"),
    (1e3, 5, "constant")])
def test_adamw_update_matches_reference(clip, step, lr):
    """From identical params, grads and moments (grads of norm ~5: clipped
    at 1.0, not at 1e3), at a step in the warmup, after it, and at a
    constant rate."""
    params, grads, mu, nu = _tree_inputs(step)
    nu = jax.tree.map(np.abs, nu)
    sched = (ref_cosine(1e-2, 10, 50), cosine_schedule(1e-2, 10, 50)) \
        if lr == "cosine" else (ref_constant(3e-3), constant_schedule(3e-3))
    ref_opt = RefAdamW(learning_rate=sched[0], grad_clip_norm=clip)
    opt = AdamW(learning_rate=sched[1], grad_clip_norm=clip)
    from repro.train import AdamWState as RefState
    rp, rs, rm = ref_opt.update(
        grads, RefState(jnp.asarray(step, jnp.int32), mu, nu), params)
    pp, ps, pm = opt.update(
        _tensors(grads), AdamWState(torch.tensor(step, dtype=torch.int32),
                                    _tensors(mu), _tensors(nu)),
        _tensors(params))
    assert int(ps.step) == int(rs.step) == step + 1
    for name, got, want in (("params", pp, rp), ("mu", ps.mu, rs.mu),
                            ("nu", ps.nu, rs.nu)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(_np(want))):
            within_ulps(g, w, name)
    within_ulps(pm["grad_norm"], rm["grad_norm"], "grad_norm")
    within_ulps(pm["lr"], rm["lr"], "lr")


def test_schedules_and_global_norm_match_reference():
    ref_lr, lr = ref_cosine(3e-3, 10, 110), cosine_schedule(3e-3, 10, 110)
    for s in list(range(0, 130, 3)) + [10, 110]:
        within_ulps(lr(torch.tensor(s, dtype=torch.int32)),
                    ref_lr(jnp.asarray(s, jnp.int32)), f"cosine step {s}")
        within_ulps(constant_schedule(0.1)(torch.tensor(s)),
                    ref_constant(0.1)(jnp.asarray(s)), "constant")
    tree = _tree_inputs(11)[0]
    within_ulps(global_norm(_tensors(tree)), ref_global_norm(tree),
                "global_norm")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_tree_matches_reference(seed):
    grads, err = _tree_inputs(seed)[1:3]
    for g in jax.tree.leaves(grads):
        q, scale = grad_compress._quantize(torch.from_numpy(g))
        rq, rscale = ref_gc._quantize(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        within_ulps(scale, rscale, "scale")
    deq, new_err = grad_compress.compress_tree(_tensors(grads),
                                               _tensors(err))
    rdeq, rerr = ref_gc.compress_tree(grads, err)
    for g, w in zip(tree_leaves(deq) + tree_leaves(new_err),
                    jax.tree.leaves(_np(rdeq)) + jax.tree.leaves(_np(rerr))):
        within_ulps(g, w, "compress_tree")
    assert grad_compress.compression_ratio() == ref_gc.compression_ratio()


# -- loss and gradient per family -----------------------------------------------

class TrainPair:
    """One reduced config in both packages, the reference's parameters
    carried across, and one ``SyntheticLM`` batch of 2 sequences."""

    def __init__(self, arch, seq, **replace):
        self.ref_cfg = dataclasses.replace(ref_get(arch).reduced(), **replace)
        self.cfg = dataclasses.replace(get(arch).reduced(), **replace)
        self.ref = ref_build(self.ref_cfg)
        self.model = build(self.cfg)
        self.ref_params = self.ref.init(jax.random.PRNGKey(0))
        self.params = convert.model_params(self.cfg, _np(self.ref_params),
                                           device="cpu")
        ref_src = RefSyntheticLM(self.ref_cfg, RefShape("t", seq, 2, "train"))
        src = SyntheticLM(self.cfg, ShapeSpec("t", seq, 2, "train"))
        self.ref_batch = ref_src.place(ref_src.batch_for_step(0), CTX)
        self.batch = src.place(src.batch_for_step(0), "cpu")

    def ref_value_and_grad(self):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: self.ref.loss(p, b, CTX), has_aux=True))(
                self.ref_params, self.ref_batch)
        return float(loss), convert.model_params(self.cfg, _np(grads),
                                                 device="cpu")


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_by_path(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def hold_grads(got, want, what):
    for (name, g), (_, w) in zip(_leaves_by_path(got),
                                 _leaves_by_path(want)):
        g, w = g.float().numpy(), w.float().numpy()
        assert g.shape == w.shape and np.all(np.isfinite(g)), (what, name)
        tol = GRAD_EPS * BF16_EPS * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} grad {name}: {err} > {tol}"


def hold_loss(got, want, what):
    assert abs(float(got) - want) <= TOL_EPS * BF16_EPS * abs(want), \
        (what, float(got), want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grad_match_reference(family, monkeypatch):
    """``Model.loss`` and its gradient from one converted state, against
    ``jax.value_and_grad(model.loss)``; remat on, as both configs say."""
    pair = TrainPair(*FAMILIES[family])
    assert pair.cfg.remat
    want_loss, want_grads = pair.ref_value_and_grad()

    def check(got, _):
        loss, metrics, grads = got
        hold_loss(loss, want_loss, family)
        assert set(metrics) == {"ce", "aux"}
        hold_grads(grads, want_grads, family)
    port = lambda: value_and_grad(pair.model, pair.params, pair.batch)
    if family == "moe":
        ref_loss = jax.jit(lambda p, b: pair.ref.loss(p, b, CTX)[0])
        _routed(RefRoutes(monkeypatch), pair.cfg, f"{family} train forward",
                ref_loss, (pair.ref_params, pair.ref_batch), port, check)
    else:
        check(port(), None)


def test_reference_own_bf16_gradient_spread_fits_the_bound(monkeypatch):
    """``GRAD_EPS``'s reason: the reference's own gradients, computed on
    bf16 and on f32 operands from one state and batch, differ leaf by leaf
    by less than the bound (the hybrid, the family with the largest such
    spread on these batches)."""
    from repro.models import layers as ref_layers
    pair = TrainPair(*FAMILIES["hybrid"])
    grads = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        monkeypatch.setattr(ref_layers, "COMPUTE_DTYPE", dtype)
        batch = {k: v.astype(dtype) if v.dtype == jnp.bfloat16 else v
                 for k, v in pair.ref_batch.items()}
        grads[dtype] = jax.jit(jax.grad(
            lambda p, b: pair.ref.loss(p, b, CTX)[0]))(pair.ref_params, batch)
    spread = max(
        float(jnp.max(jnp.abs(a - b))) / (BF16_EPS * float(jnp.max(jnp.abs(b))))
        for a, b in zip(jax.tree.leaves(grads[jnp.bfloat16]),
                        jax.tree.leaves(grads[jnp.float32])))
    assert 1.0 < spread < GRAD_EPS, spread


@pytest.mark.parametrize("family", ["moe", "hybrid", "encdec"])
def test_remat_changes_no_gradient(family):
    """Rematerialized layers give the gradient of the plain forward bit for
    bit, and an moe layer routes once a step (its recompute takes the
    forward's choices)."""
    arch, seq = FAMILIES[family]
    pair = TrainPair(arch, seq)
    plain = build(dataclasses.replace(pair.cfg, remat=False))
    with Routes() as r:
        loss, _, grads = value_and_grad(pair.model, pair.params, pair.batch)
    assert len(r.own) == (pair.cfg.num_layers if family == "moe" else 0)
    loss0, _, grads0 = value_and_grad(plain, pair.params, pair.batch)
    assert float(loss) == float(loss0)
    for (name, g), (_, w) in zip(_leaves_by_path(grads),
                                 _leaves_by_path(grads0)):
        assert torch.equal(g, w), name


def test_loss_masks_negative_labels():
    """Labels below 0 weigh nothing (the reference's ``labels >= 0``
    mask); the CE is over the rest."""
    pair = TrainPair("smollm-360m", 16)
    batch = dict(pair.batch, labels=pair.batch["labels"].clone())
    batch["labels"][:, 5:9] = -1
    ref_batch = dict(pair.ref_batch, labels=jnp.asarray(
        batch["labels"].numpy().astype(np.int32)))
    loss, _ = pair.model.loss(pair.params, batch)
    want = float(jax.jit(lambda p, b: pair.ref.loss(p, b, CTX)[0])(
        pair.ref_params, ref_batch))
    hold_loss(loss, want, "masked labels")


# -- train step --------------------------------------------------------------------

def _ref_state(pair, opt, compress=False):
    return ref_init_state(pair.ref, jax.random.PRNGKey(0), opt,
                          compress=compress)


def test_train_step_matches_reference():
    """One step from the same state: fed the reference's gradients, the
    port's optimizer gives the reference's optimizer's parameters (run op
    by op) within ``ULPS``;
    end to end (its own gradients) within the reference's first-Adam-step
    bound."""
    pair = TrainPair("smollm-360m", 8)
    ref_opt = RefAdamW(learning_rate=ref_constant(1e-2), weight_decay=0.0,
                       grad_clip_norm=None)
    opt = AdamW(learning_rate=constant_schedule(1e-2), weight_decay=0.0,
                grad_clip_norm=None)
    rs0 = _ref_state(pair, ref_opt)
    rs1, rm = jax.jit(ref_make_train_step(pair.ref, ref_opt, CTX))(
        rs0, pair.ref_batch)
    s0 = convert.train_state(pair.cfg, _np(rs0), device="cpu")
    want = convert.model_params(pair.cfg, _np(rs1.params), device="cpu")

    (_, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: pair.ref.loss(p, b, CTX), has_aux=True))(
            rs0.params, pair.ref_batch)
    # op by op, as the port computes it (XLA's fusion of the jitted update
    # moves a few results near zero by several ulps of their own size)
    ref_fed, _, _ = ref_opt.update(ref_grads, rs0.opt, rs0.params)
    fed, _, _ = opt.update(convert.model_params(pair.cfg, _np(ref_grads),
                                                device="cpu"),
                           s0.opt, s0.params)
    for (name, g), (_, w) in zip(
            _leaves_by_path(fed), _leaves_by_path(convert.model_params(
                pair.cfg, _np(ref_fed), device="cpu"))):
        within_ulps(g, w.numpy(), f"fed {name}")

    s1, m = make_train_step(pair.model, opt)(s0, pair.batch)
    hold_loss(m["loss"], float(rm["loss"]), "step loss")
    d = max(float((g - w).abs().max()) for (_, g), (_, w) in zip(
        _leaves_by_path(s1.params), _leaves_by_path(want)))
    assert d < 5e-2
    assert int(s1.opt.step) == 1 and int(s0.opt.step) == 0


def test_eight_steps_losses_match_reference():
    pair = TrainPair("smollm-360m", 16)
    ref_opt = RefAdamW(learning_rate=ref_constant(3e-3))
    opt = AdamW(learning_rate=constant_schedule(3e-3))
    rs = _ref_state(pair, ref_opt)
    state = convert.train_state(pair.cfg, _np(rs), device="cpu")
    ref_step = jax.jit(ref_make_train_step(pair.ref, ref_opt, CTX))
    step = make_train_step(pair.model, opt)
    ref_src = RefSyntheticLM(pair.ref_cfg, RefShape("t", 16, 8, "train"))
    src = SyntheticLM(pair.cfg, ShapeSpec("t", 16, 8, "train"))
    got, want = [], []
    for i in range(8):
        rs, rm = ref_step(rs, ref_src.place(ref_src.batch_for_step(i), CTX))
        state, m = step(state, src.place(src.batch_for_step(i), "cpu"))
        want.append(float(rm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]


def test_microbatched_equals_full_batch():
    """Gradient accumulation over microbatches == one big batch (the
    reference's test, on the port)."""
    cfg = get("smollm-360m").reduced()
    model = build(cfg)
    opt = AdamW(learning_rate=constant_schedule(1e-2), weight_decay=0.0,
                grad_clip_norm=None)
    state0 = init_state(model, torch.Generator().manual_seed(0), opt)
    src = SyntheticLM(cfg, ShapeSpec("t", 8, 16, "train"))
    batch = src.place(src.batch_for_step(0), "cpu")
    s1, m1 = make_train_step(model, opt, num_microbatches=1)(state0, batch)
    s4, m4 = make_train_step(model, opt, num_microbatches=4)(state0, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    d = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(s1.params), tree_leaves(s4.params)))
    assert d < 5e-2


def test_compressed_training_still_converges():
    cfg = get("smollm-360m").reduced()
    model = build(cfg)
    opt = AdamW(learning_rate=constant_schedule(3e-3))
    state = init_state(model, torch.Generator().manual_seed(0), opt,
                       compress=True)
    assert state.error_fb is not None
    step = make_train_step(model, opt, compress=True)
    src = SyntheticLM(cfg, ShapeSpec("t", 16, 8, "train"))
    losses = []
    for i in range(8):
        state, metrics = step(state, src.place(src.batch_for_step(i), "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]


def test_state_converts_both_ways():
    """A reference ``TrainState`` (with error feedback) into the port and
    back into the reference's stacked layout, leaf for leaf, bitwise."""
    pair = TrainPair("smollm-360m", 8)
    opt = RefAdamW(learning_rate=ref_constant(1e-2))
    rs = _np(_ref_state(pair, opt, compress=True))
    state = convert.train_state(pair.cfg, rs, device="cpu")
    assert isinstance(state, TrainState) and state.opt.step.dtype == \
        torch.int32
    back = convert.to_reference(pair.cfg, state)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(rs)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- the kernels' autograd Functions -------------------------------------------------

def _leafs(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _grads(fn, ins, cot):
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(outs, ins, cot[:len(outs)])


_jax_lru_vjp = jax.jit(lambda la, b, dh: jax.vjp(jax_lru_scan, la, b)[1](dh))


@pytest.mark.parametrize("shape", [(2, 40, 16), (1, 7, 5), (1, 1, 3)])
def test_lru_function_backward(shape):
    """The adjoint scan (:func:`lru_adjoint` through ``LRUScan`` on the
    plain forward) against autograd of ``lru_ref`` and ``jax.vjp`` of the
    reference's ``lru_scan``, the function its model differentiates."""
    rng = np.random.default_rng(shape[1])
    log_a = -rng.uniform(0.0, 2.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    cot = (torch.from_numpy(dh),)
    got = _grads(lambda la, bb: lru_ops.LRUScan.apply(la, bb, lru_ref),
                 _leafs(log_a, b), cot)
    plain = _grads(lru_ref, _leafs(log_a, b), cot)
    want = _jax_lru_vjp(jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(dh))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), **F32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("s,init", [(32, False), (24, True), (5, False)])
def test_ssd_function_backward(s, init):
    """``SSDScan`` on the sequential plain forward, backward through the
    chunked form at chunk 8, against autograd of ``ssd_chunked`` and
    ``jax.vjp`` of the reference's ``ssd_chunked`` (whole chunks only: R6);
    the final state's cotangent included where an initial state is
    given."""
    rng = np.random.default_rng(s)
    bsz, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)) - 1)).astype(
        np.float32)
    b, c = (rng.standard_normal((bsz, s, n)).astype(np.float32)
            for _ in range(2))
    a_log = rng.standard_normal(h).astype(np.float32) * 0.5
    h0 = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    gy = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    gfs = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    arrays = (x, dt, b, c, a_log) + ((h0,) if init else ())
    cot = (torch.from_numpy(gy), torch.from_numpy(gfs)) if init \
        else (torch.from_numpy(gy),)

    def fn(*t):
        out = ssd_ops.SSDScan.apply(*t[:5], t[5] if init else None, 8,
                                    ssd_ref)
        return out if init else out[0]

    def plain(*t):
        out = ssd_ops.chunked(*t[:5], 8, t[5] if init else None)
        return out if init else out[0]
    got = _grads(fn, _leafs(*arrays), cot)
    want = _grads(plain, _leafs(*arrays), cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)
    if s % 8 == 0:
        def ref(*t):
            y, fs = jax_ssd_chunked(t[0], t[1], t[2][:, :, None],
                                    t[3][:, :, None], t[4], 8,
                                    t[5] if init else None)
            return (y, fs) if init else y
        jcot = tuple(jnp.asarray(np.asarray(t)) for t in cot)
        jgot = jax.jit(lambda a, ct: jax.vjp(ref, *a)[1](ct))(
            tuple(map(jnp.asarray, arrays)), jcot if init else jcot[0])
        for g, w in zip(got, jgot):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("sq,skv,causal,window,off", [
    (16, 16, True, 0, 0), (12, 12, True, 5, 0), (5, 9, False, 0, 0),
    (4, 10, True, 0, 6)])
def test_flash_function_backward(sq, skv, causal, window, off):
    """``FlashAttention`` on the plain forward: its backward (the VJP of
    ``attention_ref`` by recompute) against autograd of the plain version
    and ``jax.vjp`` of the reference's ``attention_ref``, in f32."""
    rng = np.random.default_rng(sq * skv)
    q = rng.standard_normal((2, 2, 3, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, skv, 16)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off)
    cot = (torch.from_numpy(g),)
    got = _grads(lambda *t: fa_ops.FlashAttention.apply(
        *t, causal, window, off, attention_ref), _leafs(q, k, v), cot)
    plain = _grads(lambda *t: attention_ref(*t, **kw), _leafs(q, k, v), cot)
    want = jax.jit(lambda a, ct: jax.vjp(
        lambda *t: jax_attention(*t, **kw), *a)[1](ct))(
            tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    for a, p, w in zip(got, plain, want):
        assert torch.equal(a, p)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32)


def test_cpu_wrappers_differentiate_the_plain_versions():
    """On the CPU the wrappers return the plain versions' autograd graphs
    and launch nothing."""
    for ops in (fa_ops, lru_ops, ssd_ops):
        ops.reset_launches()
    q = torch.randn(1, 1, 2, 5, 8, requires_grad=True)
    k = torch.randn(1, 1, 5, 8, requires_grad=True)
    assert fa_ops.flash_attention(q, k, k).grad_fn is not None
    la = -torch.rand(1, 6, 4, requires_grad=True)
    assert lru_ops.lru(la, torch.randn(1, 6, 4)).grad_fn is not None
    x = torch.randn(1, 6, 2, 3, requires_grad=True)
    y, _ = ssd_ops.ssd(x, torch.rand(1, 6, 2), torch.randn(1, 6, 4),
                       torch.randn(1, 6, 4), torch.zeros(2), 4)
    assert y.grad_fn is not None
    assert all(n == 0 for ops in (fa_ops, lru_ops, ssd_ops)
               for n in ops.launches.values())


# -- the launcher ------------------------------------------------------------------

def test_launcher_trains_reduced_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "smollm-360m", "--reduced", "--steps", "3",
                      "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    rep = out["report"]
    assert rep.steps_run == 3 and rep.restarts == 0
    assert out["steps"] == [0, 1, 2] and out["peak_gib"] is None
    assert all(sum(n.values()) == 0 for n in out["launches"])
    text = capsys.readouterr().out
    assert "arch=smollm-360m-reduced" in text and "done: steps=3" in text
    assert os.path.isdir(tmp_path / "step_00000002")


def test_launcher_needs_a_card_or_cpu_and_validates_the_mesh(tmp_path):
    """Without a card the launcher raises unless given ``--device cpu``;
    a malformed ``--mesh``, or one whose data axis does not divide
    ``--global-batch``, raises before any rank starts."""
    from repro_torch.launch import train
    argv = ["--arch", "smollm-360m", "--reduced", "--steps", "1",
            "--ckpt-dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(argv)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(argv + ["--mesh", "2,1"])
    for bad in ("2", "2,x", "0,2", "2,2,2", "2,-1"):
        with pytest.raises(ValueError, match="two positive integers"):
            train.main(argv + ["--device", "cpu", "--mesh", bad])
    with pytest.raises(ValueError, match="does not divide --global-batch"):
        train.main(argv + ["--device", "cpu", "--global-batch", "6",
                           "--mesh", "4,1"])
