"""The port's multi-device path on the CPU under gloo, against the port's
and the JAX reference's single-device results and the reference's own
sharded results.  Each multi-rank body runs in a fresh interpreter that
spawns its ranks (``repro_torch.launch.mesh.spawn``), with a timeout, as
``tests/test_distributed.py``'s ``run_sub`` does; the reference's sharded
side runs on 8 host CPU devices in a subprocess whose first line sets
``XLA_FLAGS``.  Data crosses between processes as files in ``tmp_path``.

  (ii)  one sharded training step (``smollm-360m`` reduced at ``(4, 2)``;
        ``olmoe-1b-7b`` reduced, capacity factor 8, and ``smollm-360m``
        with 6 heads / 3 KV heads and 3 / 1, the reference's "heads" and
        "q_seq" attention branches, at ``(2, 2)``) against the port's and
        the reference's single-device steps from the same converted state;
  (iii) the expert-parallel ``moe_block`` against the reference's sharded
        block at ``(2, 2)`` on identical bf16 inputs, capacity factor 8 and
        the default capacity (where drops bind, per shard);
  (iv)  checkpoints across meshes and packages;
  (v)   ``compressed_psum`` over 8 ranks against the reference's under
        ``shard_map``;
  (vi)  the global gradient norm and ``compress_tree``'s scales under
        ``(4, 2)`` against one device;
  (vii) the ``--mesh 2,2 --device cpu`` launcher with a failure and a
        restart.

Tolerances, each with its reason:

* the step's loss within ``TOL_EPS`` = 8 bf16 epsilons of the reference's
  and each gradient leaf within ``GRAD_EPS`` = 16 bf16 epsilons of the
  leaf's largest magnitude, and the parameters after one Adam step within
  5e-2: ``tests/test_torch_train.py``'s one-step bounds (the sharded step
  sums its row-parallel products in f32 in another order, a bf16
  rounding of its own);
* the expert-parallel block within 8 bf16 epsilons of the reference's
  largest output (the bound ``tests/test_torch_models.py`` holds logits
  to), its expert choices exactly, ``aux`` within 4 f32 ulps (a mean of
  the same per-shard values in another order);
* checkpoints, ``compress_tree`` and the restore paths bitwise;
* ``compressed_psum`` within one f32 ulp of the largest magnitude (the
  same int32 sums times one f32 scale);
* ``global_norm`` within 2 f32 ulps (its sums in another order);
* the launcher's replayed losses bitwise, its losses within rel 2e-2 of
  the one-device launcher's (``tests/test_torch_train.py``'s 8-step
  bound)."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs.shapes import ShapeSpec as RefShape
from repro.models import build as ref_build
from repro.train import AdamW as RefAdamW
from repro.train import SyntheticLM as RefSyntheticLM
from repro.train import constant_schedule as ref_constant
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import elastic
from repro_torch.configs import get
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import build
from repro_torch.train import (AdamW, SyntheticLM, constant_schedule,
                               init_state)
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.train_step import make_train_step, value_and_grad
from test_torch_models import BF16_EPS, CTX, TOL_EPS

ROOT = Path(__file__).resolve().parents[1]
GRAD_EPS = 16

#: the head of every rank script: ``body(rank, world, d)`` follows
RANKS_HEAD = '''
import dataclasses, os, pickle, sys
import numpy as np
import torch
from repro_torch import convert
from repro_torch.checkpoint import ckpt, elastic
from repro_torch.configs import get
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention, build, sharding
from repro_torch.train import (AdamW, SyntheticLM, constant_schedule,
                               grad_compress, make_train_step)
from repro_torch.train.optimizer import global_norm, tree_leaves, tree_map
from repro_torch.train.train_step import (shard_state, state_specs,
                                          unshard_state, value_and_grad)
torch.set_num_threads(1)


def save(obj, d, name):
    with open(os.path.join(d, name), "wb") as f:
        pickle.dump(obj, f)


def load(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return pickle.load(f)
'''


def run_ranks(tmp_path, world, body, timeout=300):
    """``body`` (defining ``body(rank, world, d)``) on ``world`` gloo ranks
    of a fresh interpreter; ``d`` is ``tmp_path``."""
    script = tmp_path / f"ranks_{len(list(tmp_path.glob('ranks_*')))}.py"
    script.write_text(RANKS_HEAD + textwrap.dedent(body) + f'''
if __name__ == "__main__":
    mesh_mod.spawn(body, {world}, (sys.argv[1],))
''')
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, \
        f"STDOUT:\n{out.stdout[-4000:]}\nSTDERR:\n{out.stderr[-8000:]}"
    return out.stdout


def run_ref(tmp_path, body, devices=8, timeout=300):
    """``body`` in the reference on ``devices`` host CPU devices; its
    ``D`` is ``tmp_path``."""
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = \\
            "--xla_force_host_platform_device_count={devices}"
        import sys
        import jax
        import jax.numpy as jnp
        import numpy as np
        D = sys.argv[1]
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", prog, str(tmp_path)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, \
        f"STDOUT:\n{out.stdout[-4000:]}\nSTDERR:\n{out.stderr[-8000:]}"
    return out.stdout


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _by_path(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def hold_loss(got, want, what):
    assert abs(float(got) - float(want)) <= \
        TOL_EPS * BF16_EPS * abs(float(want)), (what, float(got), want)


def hold_grads(got, want, what):
    for (name, g), (_, w) in zip(_by_path(got), _by_path(want)):
        g, w = g.float().numpy(), w.float().numpy()
        assert g.shape == w.shape and np.all(np.isfinite(g)), (what, name)
        tol = GRAD_EPS * BF16_EPS * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} grad {name}: {err} > {tol}"


def hold_params(got, want, what):
    d = max(float((g - w).abs().max()) for (_, g), (_, w) in zip(
        _by_path(got), _by_path(want)))
    assert d < 5e-2, (what, d)


# -- (ii) one sharded step -------------------------------------------------------

#: name -> (arch, config replacements, mesh)
STEP_CASES = {
    "dense_kv_heads": ("smollm-360m", {}, (4, 2)),
    "moe": ("olmoe-1b-7b", {"moe_capacity_factor": 8.0}, (2, 2)),
    "dense_heads": ("smollm-360m", {"num_heads": 6, "num_kv_heads": 3},
                    (2, 2)),
    "dense_q_seq": ("smollm-360m", {"num_heads": 3, "num_kv_heads": 1},
                    (2, 2)),
}
STEP_SEQ, STEP_BATCH = 16, 8

STEP_BODY = '''
def body(rank, world, d):
    cases = load(d, "cases.pkl")
    for name, (arch, rep, shape) in cases.items():
        if shape[0] * shape[1] != world:
            continue
        mesh = mesh_mod.init_mesh(shape, ("data", "model"))
        ctx = sharding.from_mesh(mesh)
        cfg = dataclasses.replace(get(arch).reduced(), **rep)
        model = build(cfg)
        state = load(d, f"{name}_state.pkl")
        local = shard_state(state, model, ctx)
        src = SyntheticLM(cfg, ShapeSpec("t", %d, %d, "train"))
        batch = src.place(src.batch_for_step(0), "cpu", ctx)
        opt = AdamW(learning_rate=constant_schedule(1e-2),
                    weight_decay=0.0)
        loss, _, grads = value_and_grad(model, local.params, batch, ctx)
        new, metrics = make_train_step(model, opt, ctx=ctx)(local, batch)
        specs = model.param_specs(ctx)
        grads = sharding.unshard_tree(grads, specs, ctx)
        params = sharding.unshard_tree(new.params, specs, ctx)
        ok = all(torch.equal(a, sharding.shard(b, s, ctx)) for a, b, s in
                 zip(tree_leaves(local.params), tree_leaves(state.params),
                     tree_leaves(specs)))
        if rank == 0:
            save(dict(loss=float(loss), step_loss=float(metrics["loss"]),
                      grads=grads, params=params, placed=ok,
                      branch=attention.tp_branch(cfg, %d, ctx)),
                 d, f"{name}_out.pkl")
''' % (STEP_SEQ, STEP_BATCH, STEP_SEQ)


def single_device_steps(cases, d):
    """Each case's reference and port single-device loss, gradients and
    parameters after one step, from one converted state; writes the
    states and ``cases`` into ``d`` for :data:`STEP_BODY`."""
    want, seen = {}, {}
    for name, (arch, rep, _) in cases.items():
        key = (arch, tuple(sorted(rep.items())))
        if key in seen:             # the same config on another mesh
            want[name] = dict(want[seen[key]])
            with open(d / f"{name}_state.pkl", "wb") as f, \
                    open(d / f"{seen[key]}_state.pkl", "rb") as g:
                f.write(g.read())
            continue
        seen[key] = name
        ref_cfg = dataclasses.replace(ref_get(arch).reduced(), **rep)
        cfg = dataclasses.replace(get(arch).reduced(), **rep)
        ref, model = ref_build(ref_cfg), build(cfg)
        ref_opt = RefAdamW(learning_rate=ref_constant(1e-2), weight_decay=0.0)
        rs0 = ref_init_state(ref, jax.random.PRNGKey(0), ref_opt)
        ref_src = RefSyntheticLM(ref_cfg, RefShape("t", STEP_SEQ, STEP_BATCH,
                                                   "train"))
        rb = ref_src.place(ref_src.batch_for_step(0), CTX)
        (rloss, _), rgrads = jax.jit(jax.value_and_grad(
            lambda p, b: ref.loss(p, b, CTX), has_aux=True))(rs0.params, rb)
        rs1, _ = jax.jit(ref_make_train_step(ref, ref_opt, CTX))(rs0, rb)
        state = convert.train_state(cfg, _np(rs0), device="cpu")
        src = SyntheticLM(cfg, ShapeSpec("t", STEP_SEQ, STEP_BATCH, "train"))
        batch = src.place(src.batch_for_step(0), "cpu")
        opt = AdamW(learning_rate=constant_schedule(1e-2), weight_decay=0.0)
        loss, _, grads = value_and_grad(model, state.params, batch)
        s1, _ = make_train_step(model, opt)(state, batch)
        want[name] = dict(
            ref_loss=float(rloss),
            ref_grads=convert.model_params(cfg, _np(rgrads), device="cpu"),
            ref_params=convert.model_params(cfg, _np(rs1.params),
                                            device="cpu"),
            loss=float(loss), grads=grads, params=s1.params)
        with open(d / f"{name}_state.pkl", "wb") as f:
            pickle.dump(state, f)
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    return want


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Every case's reference and port single-device results, and its
    sharded step (two worlds: 8 and 4 ranks)."""
    d = tmp_path_factory.mktemp("steps")
    want = single_device_steps(STEP_CASES, d)
    for world in (8, 4):
        run_ranks(d, world, STEP_BODY)
    return {name: (want[name], _load(d / f"{name}_out.pkl"))
            for name in STEP_CASES}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_step_matches_single_device(name, step_runs):
    """The sharded step's loss, gathered gradients and parameters against
    the port's single-device step and the reference's, from one converted
    state; each rank's blocks equal the specs' slices of the full
    state."""
    want, got = step_runs[name]
    arch, rep, mesh = STEP_CASES[name]
    assert got["placed"]
    assert got["branch"] == {"dense_kv_heads": "kv_heads", "moe": "kv_heads",
                             "dense_heads": "heads",
                             "dense_q_seq": "q_seq"}[name]
    assert got["loss"] == got["step_loss"]
    for side in ("", "ref_"):
        what = f"{name} {mesh} vs {side or 'port '}single device"
        hold_loss(got["loss"], want[side + "loss"], what)
        hold_grads(got["grads"], want[side + "grads"], what)
        hold_params(got["params"], want[side + "params"], what)


# -- (iii) the expert-parallel MoE block --------------------------------------------

MOE_REF = '''
import dataclasses
from repro.configs import get
from repro.models import ShardingCtx, from_mesh
from repro.models.moe import moe_block, moe_schema
from repro.models.schema import init_params
out = {}
for cf in (8.0, None):
    cfg = get("olmoe-1b-7b").reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    params = init_params(moe_schema(cfg), jax.random.PRNGKey(0))
    # a peaked router and inputs with a common part, so that most tokens
    # prefer the same experts and the default capacity drops pairs
    params["router"] = params["router"] * 40.0
    x = (jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
         + 1.0).astype(jnp.bfloat16)
    ctx = from_mesh(jax.make_mesh((2, 2), ("data", "model")))
    o, aux = jax.jit(lambda p, xx: moe_block(p, xx, cfg, ctx))(params, x)
    tag = "cf8" if cf else "default"
    out[tag] = dict(params={k: np.asarray(v) for k, v in params.items()},
                    x=np.asarray(x.astype(jnp.float32)),
                    out=np.asarray(o.astype(jnp.float32)),
                    aux=float(aux))
import pickle
with open(D + "/moe_ref.pkl", "wb") as f:
    pickle.dump(out, f)
'''

MOE_BODY = '''
def body(rank, world, d):
    from repro_torch.models import moe
    from repro_torch.models.routes import Routes
    ref = load(d, "moe_ref.pkl")
    ctx = sharding.from_mesh(mesh_mod.init_mesh((2, 2), ("data", "model")))
    res = {}
    for tag, r in ref.items():
        cfg = get("olmoe-1b-7b").reduced()
        if tag == "cf8":
            cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
        full = {k: torch.from_numpy(v) for k, v in r["params"].items()}
        specs = sharding.tree_specs(moe.moe_schema(cfg), ctx)
        local = sharding.fsdp(sharding.shard_tree(full, specs, ctx), specs,
                              ctx)
        x = torch.from_numpy(r["x"]).bfloat16()
        xl = sharding.shard(x, ("data",), ctx)
        with Routes() as seen:
            out, aux = moe.moe_block(local, xl, cfg, ctx=ctx)
        out = sharding.unshard(out, ("data",), ctx)
        aux = sharding.reduce_dp(aux, ctx) / ctx.dp_size()
        top = sharding.unshard(seen.own[0], ("data",), ctx)
        res[tag] = dict(out=out.float(), aux=float(aux), top=top)
    if rank == 0:
        save(res, d, "moe_out.pkl")
'''


def test_expert_parallel_moe_matches_reference_sharded(tmp_path):
    """The port's expert-parallel block and the reference's ``shard_map``
    block on the same bf16 inputs and parameters (skewed routing: the
    router scaled up, the inputs given a common part) at ``(2, 2)``: outputs, expert choices and the
    mesh-averaged ``aux``, with no drops (capacity factor 8) and with the
    default capacity, where each shard's capacity follows its local token
    count and drops bind."""
    run_ref(tmp_path, MOE_REF)
    run_ranks(tmp_path, 4, MOE_BODY)
    ref, got = _load(tmp_path / "moe_ref.pkl"), _load(tmp_path /
                                                      "moe_out.pkl")
    cfg = get("olmoe-1b-7b").reduced()
    for tag in ("cf8", "default"):
        r, g = ref[tag], got[tag]
        # the reference's experts, from its router on the same input
        probs = jax.nn.softmax(jnp.asarray(r["x"]).reshape(-1, cfg.d_model)
                               @ jnp.asarray(r["params"]["router"]))
        top = np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1])
        np.testing.assert_array_equal(g["top"].numpy(), top)
        tol = TOL_EPS * BF16_EPS * float(np.abs(r["out"]).max())
        err = float(np.abs(g["out"].numpy() - r["out"]).max())
        assert err <= tol, (tag, err, tol)
        assert abs(g["aux"] - r["aux"]) <= 4 * np.spacing(
            np.float32(r["aux"])), (tag, g["aux"], r["aux"])
    # drops bind at the default capacity: its output differs from cf 8's
    assert float(np.abs(ref["cf8"]["out"] - ref["default"]["out"]).max()) \
        > 0.0


# -- (iv) checkpoints across meshes and packages -------------------------------------

CKPT_REF_SAVE = '''
import pickle
from repro.checkpoint import ckpt
from repro.configs import get
from repro.models import build, from_mesh
from repro.train import (AdamW, constant_schedule, init_state,
                         state_shardings)
opt = AdamW(learning_rate=constant_schedule(1e-3))
ctx = from_mesh(jax.make_mesh((4, 2), ("data", "model")))
vals = {}
for arch in ("smollm-360m", "recurrentgemma-2b"):
    model = build(get(arch).reduced())
    st = state_shardings(model, ctx)
    state = jax.jit(lambda k: init_state(model, k, opt),
                    out_shardings=st)(jax.random.PRNGKey(0))
    ckpt.save(state, 0, f"{D}/ref42_{arch}")
    vals[arch] = jax.tree.map(np.asarray, state)
with open(D + "/ref42_values.pkl", "wb") as f:
    pickle.dump(vals, f)
'''

CKPT_REF_RESTORE = '''
import pickle
from repro.checkpoint import ckpt
from repro.configs import get
from repro.models import build, from_mesh
from repro.train import (AdamW, constant_schedule, init_state,
                         state_shardings)
opt = AdamW(learning_rate=constant_schedule(1e-3))
ctx = from_mesh(jax.make_mesh((4, 2), ("data", "model")))
with open(D + "/port22_values.pkl", "rb") as f:
    want = pickle.load(f)
for arch in ("smollm-360m", "recurrentgemma-2b"):
    model = build(get(arch).reduced())
    st = state_shardings(model, ctx)
    target = jax.eval_shape(lambda k: init_state(model, k, opt),
                            jax.random.PRNGKey(0))
    got, step = ckpt.restore(f"{D}/port22_{arch}", target=target,
                             shardings=st)
    assert step == 0
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want[arch])
    assert len(gl) == len(wl) and len(gl) > 0
    for g, s, w in zip(gl, jax.tree.leaves(st), wl):
        assert g.sharding == s
        np.testing.assert_array_equal(np.asarray(g), w)
    print("restored", arch, len(gl))
'''

CKPT_SAVE42 = '''
def body(rank, world, d):
    ctx = sharding.from_mesh(mesh_mod.init_mesh((4, 2), ("data", "model")))
    model = build(get("smollm-360m").reduced())
    state = load(d, "port_state.pkl")
    specs = state_specs(model, ctx, True)
    ckpt.save(shard_state(state, model, ctx), 7, os.path.join(d, "port42"),
              ctx=ctx, specs=specs)
'''

CKPT_22 = '''
def body(rank, world, d):
    ctx = sharding.from_mesh(elastic.mesh_for_devices(4, model_axis=2))
    assert ctx.mesh.shape == {"data": 2, "model": 2}
    ok = {}
    # (a) the port's (4, 2) checkpoint onto (2, 2)
    model = build(get("smollm-360m").reduced())
    state = load(d, "port_state.pkl")
    got, step = elastic.restore_elastic(os.path.join(d, "port42"), model,
                                        ctx, compress=True)
    want = shard_state(state, model, ctx)
    ok["port42"] = step == 7 and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(got.params) + tree_leaves(got.opt.mu)
            + tree_leaves(got.opt.nu) + tree_leaves(got.error_fb),
            tree_leaves(want.params) + tree_leaves(want.opt.mu)
            + tree_leaves(want.opt.nu) + tree_leaves(want.error_fb))) and \\
        int(got.opt.step) == int(want.opt.step)
    # (b) the reference's (4, 2) checkpoints onto (2, 2)
    vals = load(d, "ref42_values.pkl")
    port_vals = {}
    for arch in ("smollm-360m", "recurrentgemma-2b"):
        cfg = get(arch).reduced()
        model = build(cfg)
        got, _ = elastic.restore_elastic(os.path.join(d, f"ref42_{arch}"),
                                         model, ctx)
        full = convert.train_state(cfg, vals[arch], device="cpu")
        want = shard_state(full, model, ctx)
        ok[f"ref42_{arch}"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got.params) + tree_leaves(got.opt.nu),
            tree_leaves(want.params) + tree_leaves(want.opt.nu)))
        # (c) the port saves its (2, 2) blocks for the reference: blocks
        # as they are where the layouts agree, gathered otherwise
        specs = state_specs(model, ctx)
        out = os.path.join(d, f"port22_{arch}")
        if convert._stacked(cfg):
            ref_layout = convert.to_reference(cfg, want, ctx)
            if rank == 0:
                ckpt.save(ref_layout, 0, out)
            torch.distributed.barrier()
        else:
            ckpt.save(want, 0, out, ctx=ctx, specs=specs)
        port_vals[arch] = convert.to_reference(cfg, want, ctx)
    if rank == 0:
        save(ok, d, "ok22.pkl")
        save(port_vals, d, "port22_values.pkl")
'''


def test_checkpoints_cross_meshes_and_packages(tmp_path):
    """(a) the port saves at ``(4, 2)`` and restores onto ``(2, 2)`` and
    one device; (b) the reference's ``(4, 2)`` checkpoints (a stacked and
    a per-layer model) restore in the port onto ``(2, 2)``; (c) the
    port's ``(2, 2)`` checkpoints restore in the reference with
    shardings onto ``(4, 2)``: every leaf bitwise."""
    cfg = get("smollm-360m").reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(3)
    state = init_state(model, gen, AdamW(constant_schedule(1e-3)),
                       compress=True)

    def noise(t):
        return torch.randn(t.shape, generator=gen)
    state = state._replace(
        opt=state.opt._replace(step=torch.tensor(7, dtype=torch.int32),
                               mu=tree_map(noise, state.opt.mu),
                               nu=tree_map(noise, state.opt.nu)),
        error_fb=tree_map(noise, state.error_fb))
    with open(tmp_path / "port_state.pkl", "wb") as f:
        pickle.dump(state, f)
    run_ref(tmp_path, CKPT_REF_SAVE)
    run_ranks(tmp_path, 8, CKPT_SAVE42)
    run_ranks(tmp_path, 4, CKPT_22)
    ok = _load(tmp_path / "ok22.pkl")
    assert ok == {"port42": True, "ref42_smollm-360m": True,
                  "ref42_recurrentgemma-2b": True}, ok
    got, step = elastic.restore_elastic(str(tmp_path / "port42"), model,
                                        None, compress=True)
    assert step == 7 and int(got.opt.step) == 7
    for a, b in zip(tree_leaves(got.params) + tree_leaves(got.opt.mu)
                    + tree_leaves(got.opt.nu) + tree_leaves(got.error_fb),
                    tree_leaves(state.params) + tree_leaves(state.opt.mu)
                    + tree_leaves(state.opt.nu)
                    + tree_leaves(state.error_fb)):
        assert torch.equal(a, b)
    assert "restored recurrentgemma-2b" in run_ref(tmp_path,
                                                   CKPT_REF_RESTORE)


# -- (v), (vi) compressed all-reduce, global norm, compression scales ----------------

PSUM_REF = '''
import pickle
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.train.grad_compress import compressed_psum
mesh = jax.make_mesh((8,), ("pod",))
x = jax.random.normal(jax.random.PRNGKey(0), (8, 64))
y = jax.jit(shard_map(lambda xb: compressed_psum(xb, "pod"), mesh=mesh,
                      in_specs=P("pod", None), out_specs=P("pod", None)))(x)
with open(D + "/psum_ref.pkl", "wb") as f:
    pickle.dump(dict(x=np.asarray(x), y=np.asarray(y)), f)
'''

NORM_BODY = '''
def body(rank, world, d):
    res = {}
    ref = load(d, "psum_ref.pkl")
    pod = sharding.from_mesh(mesh_mod.init_mesh((8,), ("pod",)))
    y = grad_compress.compressed_psum(torch.from_numpy(ref["x"][rank]), pod,
                                      "pod")
    res["psum"] = sharding.all_gather(y[None], pod, "pod", 0)
    ctx = sharding.from_mesh(mesh_mod.init_mesh((4, 2), ("data", "model")))
    model = build(get("smollm-360m").reduced())
    gen = torch.Generator().manual_seed(11)
    full = tree_map(lambda p: torch.randn(p.shape, generator=gen),
                    model.init(torch.Generator().manual_seed(0)))
    err = tree_map(lambda p: 1e-3 * torch.randn(p.shape, generator=gen), full)
    specs = model.param_specs(ctx)
    local = sharding.shard_tree(full, specs, ctx)
    res["norm"] = float(global_norm(local, ctx, specs))
    res["norm_one"] = float(global_norm(full))
    deq, new_err = grad_compress.compress_tree(
        local, sharding.shard_tree(err, specs, ctx), ctx, specs)
    want, want_err = grad_compress.compress_tree(full, err)
    res["compress"] = all(
        torch.equal(a, sharding.shard(b, s, ctx)) for a, b, s in zip(
            tree_leaves(deq) + tree_leaves(new_err),
            tree_leaves(want) + tree_leaves(want_err),
            tree_leaves(specs) * 2))
    if rank == 0:
        save(res, d, "norm_out.pkl")
'''


@pytest.fixture(scope="module")
def norm_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("norms")
    run_ref(d, PSUM_REF)
    run_ranks(d, 8, NORM_BODY)
    return _load(d / "psum_ref.pkl"), _load(d / "norm_out.pkl")


def test_compressed_psum_matches_reference(norm_runs):
    """(v) the int8 all-reduce over 8 ranks against the reference's under
    ``shard_map`` over 8 host devices: every rank's result within one f32
    ulp of the largest magnitude."""
    ref, got = norm_runs
    y = got["psum"].numpy()
    tol = float(np.spacing(np.float32(np.abs(ref["y"]).max())))
    assert float(np.abs(y - ref["y"]).max()) <= tol
    # and the sum it approximates (the reference test's bound)
    rel = float(np.abs(y[0] - ref["x"].sum(0)).max()
                / np.abs(ref["x"].sum(0)).max())
    assert rel < 0.05


def test_global_norm_and_compression_scales_under_mesh(norm_runs):
    """(vi) under ``(4, 2)`` the clipping norm of sharded gradients equals
    one device's within 2 f32 ulps (a replicated leaf counted once), and
    ``compress_tree``'s blocks equal one device's bitwise (each leaf's
    scale its global ``max|x|``)."""
    _, got = norm_runs
    assert abs(got["norm"] - got["norm_one"]) <= 2 * np.spacing(
        np.float32(got["norm_one"]))
    assert got["compress"]


# -- (vii) the launcher ---------------------------------------------------------------

def test_mesh_launcher_trains_restarts_and_replays(tmp_path, capfd):
    """``--mesh 2,2 --device cpu``: one command spawns four gloo ranks;
    rank 0 prints; a failure at step 3 restarts every rank from the step-1
    checkpoint and the replayed step's loss is bitwise the first pass's;
    the losses follow the one-device launcher's from the same seed."""
    from repro_torch.launch import train
    argv = ["--arch", "smollm-360m", "--reduced", "--steps", "5",
            "--global-batch", "8", "--seq-len", "16", "--device", "cpu",
            "--ckpt-every", "2", "--lr", "3e-3"]
    out = train.main(argv + ["--mesh", "2,2", "--fail-at", "3",
                             "--ckpt-dir", str(tmp_path / "mesh")])
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    rep = out["report"]
    assert rep.restarts == 1 and rep.restored_steps == [1]
    assert out["losses"][2][0] == out["losses"][2][1]
    assert out["backend"] == "gloo" and out["transport"] == "device"
    assert out["mesh"] == {"data": 2, "model": 2}
    assert all(t["calls"] > 0 for t in out["traffic"])
    got = [out["losses"][s][0] for s in range(5)]
    want = [one["losses"][s][0] for s in range(5)]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    for r in range(4):
        assert (tmp_path / "mesh" / f"heartbeat.rank{r}").is_file()
    assert (tmp_path / "mesh" / "step_00000004" / "_COMMITTED").is_file()
    text = capfd.readouterr().out
    assert text.count("arch=smollm-360m-reduced") == 2
    assert "backend=gloo" in text and "done: steps=6 restarts=1" in text
