"""Tensor parallelism of the hybrid, ssm, vlm and enc-dec families on the
CPU under gloo, and the decode caches' specs, against the JAX reference.

  (a) one sharded training step of each family's reduced config at
      ``(2, 2)`` and ``(1, 4)`` (four ranks, one spawned world for every
      case) against the port's and the reference's single-device steps
      from one converted state, at ``tests/test_torch_distributed.py``'s
      bounds (the loss within 8 bf16 epsilons, each gradient leaf within
      ``GRAD_EPS`` = 16 of its largest magnitude, the parameters after one
      Adam step within 5e-2).  The cases cut what the layout cuts:
      ``recurrentgemma-2b`` at ``(1, 4)`` holds 16 LRU channels a rank
      and gate heads of 32, so its ranks cut a gate head; ``mamba2-2.7b``
      splits ``in_proj``'s 296 fused columns ``[z | x | B | C | dt]`` into
      148 or 74, cutting ``x``; a recurrentgemma with 3 heads at ``(1, 4)``
      takes the query-row attention branch, as the full config does.
  (b) ``Model.cache_specs`` equal, entry for entry, to the reference's
      ``Model.input_shardings(shape, ctx, specs)["caches"]`` for all ten
      configs on the five meshes of ``tests/test_torch_sharding.py`` at
      the reference's two decode shapes.  The reference builds
      ``NamedSharding``s, which need a concrete mesh; its ``ctx.sharding``
      is given back as its own ``ctx.spec`` of the same axes and shape, so
      the specs come from its code on an ``AbstractMesh``.  A stacked
      ``[L, ...]`` leaf's spec is compared less its leading ``"layers"``
      entry, which is replicated.

The sharded steps are also held, at the same bounds, against the
reference's own sharded step on the same mesh shapes of 4 host devices.
It runs only on a mesh whose axes are ``Auto``: on the ``Explicit`` meshes
that ``jax.make_mesh`` builds by default under the installed JAX, which the
reference's ``launch/mesh.py`` returns, its embedding gather raises
(ROADMAP.md, R2)."""
import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import pytest

from repro.configs import all_configs as ref_all_configs
from repro.configs.shapes import DECODE_32K, LONG_500K
from repro.models import build as ref_build
from repro.models.sharding import from_mesh as ref_from_mesh
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build, sharding
from test_torch_distributed import (STEP_BATCH, STEP_BODY, STEP_SEQ,
                                    hold_grads, hold_loss, hold_params,
                                    run_ranks, run_ref, single_device_steps)
from test_torch_sharding import MESHES

#: name -> (arch, config replacements, mesh)
STEP_CASES = {
    "hybrid_2x2": ("recurrentgemma-2b", {}, (2, 2)),
    "hybrid_1x4": ("recurrentgemma-2b", {}, (1, 4)),
    "hybrid_q_seq_1x4": ("recurrentgemma-2b", {"num_heads": 3}, (1, 4)),
    "ssm_2x2": ("mamba2-2.7b", {}, (2, 2)),
    "ssm_1x4": ("mamba2-2.7b", {}, (1, 4)),
    "vlm_2x2": ("internvl2-1b", {}, (2, 2)),
    "vlm_1x4": ("internvl2-1b", {}, (1, 4)),
    "encdec_2x2": ("seamless-m4t-large-v2", {}, (2, 2)),
    "encdec_1x4": ("seamless-m4t-large-v2", {}, (1, 4)),
}
#: the attention branch each case takes (mamba2 has no attention)
BRANCH = {"hybrid_2x2": "heads", "hybrid_1x4": "heads",
          "hybrid_q_seq_1x4": "q_seq", "vlm_2x2": "kv_heads",
          "vlm_1x4": "heads", "encdec_2x2": "kv_heads",
          "encdec_1x4": "heads"}


#: the reference's sharded step of every case on a mesh of 4 host devices
#: whose axes are ``Auto`` (on the default ``Explicit`` meshes its
#: embedding gather raises, R2)
REF_STEPS = """
import dataclasses, pickle
from jax.sharding import AxisType
from repro.configs import get
from repro.configs.shapes import ShapeSpec
from repro.models import build, from_mesh
from repro.train import (AdamW, SyntheticLM, constant_schedule, init_state,
                         make_train_step)
with open(D + "/cases.pkl", "rb") as f:
    cases = pickle.load(f)
out = {}
for name, (arch, rep, shape) in cases.items():
    ctx = from_mesh(jax.make_mesh(shape, ("data", "model"),
                                  axis_types=(AxisType.Auto,) * 2))
    model = build(dataclasses.replace(get(arch).reduced(), **rep))
    opt = AdamW(learning_rate=constant_schedule(1e-2), weight_decay=0.0)
    state = init_state(model, jax.random.PRNGKey(0), opt)
    src = SyntheticLM(model.cfg, ShapeSpec("t", %d, %d, "train"))
    batch = src.place(src.batch_for_step(0), ctx)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b, ctx), has_aux=True))(state.params,
                                                            batch)
    new, _ = jax.jit(make_train_step(model, opt, ctx))(state, batch)
    out[name] = dict(loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                     params=jax.tree.map(np.asarray, new.params))
with open(D + "/ref_steps.pkl", "wb") as f:
    pickle.dump(out, f)
""" % (STEP_SEQ, STEP_BATCH)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Each case's single-device results (port and reference), the
    reference's sharded step and the port's (the two multi-process runs
    side by side)."""
    d = tmp_path_factory.mktemp("tp_steps")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(STEP_CASES, f)
    with ThreadPoolExecutor(1) as pool:
        ref_job = pool.submit(run_ref, d, REF_STEPS, 4, 600)
        want = single_device_steps(STEP_CASES, d)
        run_ranks(d, 4, STEP_BODY, timeout=600)
        ref_job.result()
    ref = _load(d / "ref_steps.pkl")
    for name, (arch, rep, _) in STEP_CASES.items():
        cfg = dataclasses.replace(get(arch).reduced(), **rep)
        r = ref[name]
        want[name].update(
            sharded_loss=r["loss"],
            sharded_grads=convert.model_params(cfg, r["grads"],
                                               device="cpu"),
            sharded_params=convert.model_params(cfg, r["params"],
                                                device="cpu"))
    return {name: (want[name], _load(d / f"{name}_out.pkl"))
            for name in STEP_CASES}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_step_matches_single_device(name, step_runs):
    want, got = step_runs[name]
    arch, rep, mesh = STEP_CASES[name]
    assert got["placed"]
    if name in BRANCH:
        assert got["branch"] == BRANCH[name]
    assert got["loss"] == got["step_loss"]
    for side in ("", "ref_", "sharded_"):
        what = f"{name} {mesh} vs " + {
            "": "the port's single device", "ref_": "the reference's single "
            "device", "sharded_": "the reference's sharded step"}[side]
        hold_loss(got["loss"], want[side + "loss"], what)
        hold_grads(got["grads"], want[side + "grads"], what)
        hold_params(got["params"], want[side + "params"], what)


def test_cases_cut_what_the_layout_cuts():
    """The hybrid at ``(1, 4)`` holds part of a gate head on a rank (its
    gate weights are then replicated); the ssm's ``in_proj`` blocks end
    inside ``x``."""
    cfg = get("recurrentgemma-2b").reduced()
    ctx = sharding.from_mesh(Mesh((1, 4), ("data", "model")))
    specs = build(cfg).param_specs(ctx)["blocks"]["layer_00"]["rec"]
    bs = cfg.d_model // cfg.lru_heads
    assert specs["wx"][1] == "model" and "model" not in specs["gate_i_w"]
    assert (cfg.d_model // 4) % bs != 0
    cfg = get("mamba2-2.7b").reduced()
    di, n = cfg.d_inner, cfg.ssm_state
    d_proj = 2 * di + 2 * n + cfg.ssm_heads
    for tp in (2, 4):
        ctx = sharding.from_mesh(Mesh((4 // tp, tp), ("data", "model")))
        spec = build(cfg).param_specs(ctx)["blocks"]["layer_00"]["ssm"]
        assert spec["in_proj"][1] == "model"
        ends = [(r + 1) * d_proj // tp for r in range(tp - 1)]
        assert any(di < e < 2 * di for e in ends), (tp, ends)


# -- (b) cache specs ---------------------------------------------------------------

ARCHS = sorted(ref_all_configs())


def _ref_cache_specs(ref_model, shape, mesh_name):
    mesh_shape, names = MESHES[mesh_name]
    ctx = ref_from_mesh(jax.sharding.AbstractMesh(mesh_shape, names))

    class SpecCtx(type(ctx)):
        def sharding(self, axes, shape=None):
            return self.spec(axes, shape)

    sctx = SpecCtx(**{f.name: getattr(ctx, f.name)
                      for f in dataclasses.fields(ctx)})
    specs = ref_model.input_specs(shape)
    out = ref_model.input_shardings(shape, sctx, specs)["caches"]
    stacked = ref_model.cfg.is_encdec or (ref_model.cfg.scan_layers
                                          and ref_model.cfg.homogeneous())
    return out, stacked


def _walk(tree, specs, prefix=""):
    """``(path, spec)`` of every leaf of ``tree`` (tensors or arrays in
    dicts and tuples), its spec looked up at the same place."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], specs[k], f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _walk(t, specs[i], f"{prefix}{i}.")
    else:
        yield prefix[:-1], tuple(specs)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_name):
    ref_model, model = ref_build(ref_all_configs()[arch]), build(get(arch))
    ctx = sharding.from_mesh(Mesh(*MESHES[mesh_name]))
    for shape in (DECODE_32K, LONG_500K):
        want, stacked = _ref_cache_specs(ref_model, shape, mesh_name)
        ref_caches = jax.eval_shape(lambda: ref_model.init_decode_caches(
            shape.global_batch, shape.seq_len))
        port = model.cache_specs(ctx, shape.global_batch, shape.seq_len)
        caches = model._global_caches(shape.global_batch, shape.seq_len,
                                      "meta")
        got = dict(_walk(caches, port))
        assert got, arch
        if stacked:
            ref_leaves = dict(_walk(ref_caches, want))
            layer = {p.split(".", 1)[1] for p in got}
            assert layer == set(ref_leaves), (arch, layer, ref_leaves)
            for path, spec in got.items():
                w = ref_leaves[path.split(".", 1)[1]]
                assert not w or w[0] is None, (path, w)
                assert spec == w[1:], (arch, mesh_name, shape.name, path,
                                       spec, w)
        else:
            ref_leaves = dict(_walk(ref_caches, want))
            assert set(got) == set(ref_leaves), arch
            for path, spec in got.items():
                assert spec == ref_leaves[path], (arch, mesh_name,
                                                  shape.name, path, spec,
                                                  ref_leaves[path])
