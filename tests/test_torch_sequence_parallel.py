"""Sequence parallelism (``ShardingCtx.sequence_parallel``) on the CPU under
gloo (four ranks, one spawned world for every case), against the JAX
reference's sharded step and prefill with ``sequence_parallel=True``.

Six families' reduced configs (``smollm-360m``, ``olmoe-1b-7b`` at
capacity factor 8, ``recurrentgemma-2b``, ``mamba2-2.7b``,
``internvl2-1b``, ``seamless-m4t-large-v2``) at ``(2, 2)`` and ``(1, 4)``:

  * one sharded training step with sequence parallelism from the
    reference's initial state, against the reference's own sharded step
    with ``sequence_parallel=True`` on the same mesh shape of 4 host
    devices (loss within 8 bf16 epsilons, each gradient leaf within 16 of
    its largest magnitude, the parameters after one Adam step within
    5e-2: ``tests/test_torch_distributed.py``'s bounds), and against the
    port's own sharded step without it at the same bounds;
  * a prefill of 4 rows and 16 positions with sequence parallelism against
    the reference's sharded prefill with it, and against the port's
    without it, within 8 bf16 epsilons of the largest logit (the serving
    bound of ``tests/test_torch_models.py``);
  * the residual stream holds ``S / tp`` positions a rank where they
    divide (the whole stream otherwise), and a decode step's single
    position stays replicated.

The reference's sharded paths run only on ``Auto`` mesh axes (ROADMAP.md,
R2), so its side builds its mesh with ``axis_types=(AxisType.Auto,) *
2``."""
import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.configs import get as ref_get
from repro.models import build as ref_build
from repro.train import AdamW as RefAdamW
from repro.train import constant_schedule as ref_constant
from repro.train import init_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import get
from test_torch_distributed import (STEP_BATCH, STEP_SEQ, hold_grads,
                                    hold_loss, hold_params, run_ranks,
                                    run_ref)
from test_torch_models import close

#: name -> (arch, config replacements)
CASES = {
    "dense": ("smollm-360m", {}),
    "moe": ("olmoe-1b-7b", {"moe_capacity_factor": 8.0}),
    "hybrid": ("recurrentgemma-2b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "vlm": ("internvl2-1b", {}),
    "encdec": ("seamless-m4t-large-v2", {}),
}
MESHES = ((2, 2), (1, 4))
ROWS, POSITIONS = 4, 16

BODY = '''
def step(model, cfg, state, batch, ctx):
    opt = AdamW(learning_rate=constant_schedule(1e-2), weight_decay=0.0)
    local = shard_state(state, model, ctx)
    loss, _, grads = value_and_grad(model, local.params, batch, ctx)
    stream = sharding.residual["shape"]
    new, _ = make_train_step(model, opt, ctx=ctx)(local, batch)
    specs = model.param_specs(ctx)
    return dict(loss=float(loss), stream=stream,
                grads=sharding.unshard_tree(grads, specs, ctx),
                params=sharding.unshard_tree(new.params, specs, ctx))


def body(rank, world, d):
    cases, inputs = load(d, "cases.pkl"), load(d, "inputs.pkl")
    out = {}
    for shape in %r:
        mesh = mesh_mod.init_mesh(shape, ("data", "model"))
        plain = sharding.from_mesh(mesh)
        sp = sharding.from_mesh(mesh, sequence_parallel=True)
        for name, (arch, rep) in cases.items():
            cfg = dataclasses.replace(get(arch).reduced(), **rep)
            model = build(cfg)
            model.check_mesh(sp)
            state = load(d, f"{name}_state.pkl")
            src = SyntheticLM(cfg, ShapeSpec("t", %d, %d, "train"))
            batch = src.place(src.batch_for_step(0), "cpu", plain)
            rec = dict(sp=step(model, cfg, state, batch, sp),
                       plain=step(model, cfg, state, batch, plain))
            params = model.shard_params(state.params, sp)
            inp = inputs[name]
            extra = {k: torch.from_numpy(v) for k, v in inp["extra"].items()}
            tokens = torch.from_numpy(inp["tokens"]).long()
            for tag, ctx in (("sp", sp), ("plain", plain)):
                logits, caches = model.prefill(params, tokens, ctx=ctx,
                                               **extra)
                rec[tag + "_prefill"] = logits.float()
                rec[tag + "_prefill_stream"] = sharding.residual["shape"]
            specs = model.cache_specs(sp, %d, %d)
            caches = model.init_decode_caches(%d, %d, "cpu", ctx=sp)
            model.decode_step(params, tokens[:, :1], caches,
                              torch.full((%d, 1), 3), ctx=sp)
            rec["decode_stream"] = sharding.residual["shape"]
            out[(name, shape)] = rec
    if rank == 0:
        save(out, d, "sp_out.pkl")
''' % (MESHES, STEP_SEQ, STEP_BATCH, ROWS, 32, ROWS, 32, ROWS)

#: the reference's sharded step and prefill with sequence parallelism on
#: meshes of 4 host devices whose axes are ``Auto``
REF_SP = """
import dataclasses, pickle
from jax.sharding import AxisType
from repro.configs import get
from repro.configs.shapes import ShapeSpec
from repro.models import build, from_mesh
from repro.train import (AdamW, SyntheticLM, constant_schedule, init_state,
                         make_train_step)
with open(D + "/cases.pkl", "rb") as f:
    cases = pickle.load(f)
with open(D + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
out = {}
for shape in %r:
    ctx = from_mesh(jax.make_mesh(shape, ("data", "model"),
                                  axis_types=(AxisType.Auto,) * 2),
                    sequence_parallel=True)
    for name, (arch, rep) in cases.items():
        model = build(dataclasses.replace(get(arch).reduced(), **rep))
        opt = AdamW(learning_rate=constant_schedule(1e-2), weight_decay=0.0)
        state = init_state(model, jax.random.PRNGKey(0), opt)
        src = SyntheticLM(model.cfg, ShapeSpec("t", %d, %d, "train"))
        batch = src.place(src.batch_for_step(0), ctx)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b, ctx), has_aux=True))(
                state.params, batch)
        new, _ = jax.jit(make_train_step(model, opt, ctx))(state, batch)
        inp = inputs[name]
        feed = {"tokens": jnp.asarray(inp["tokens"]),
                **{k: jnp.asarray(v) for k, v in inp["extra"].items()}}
        lg, _ = jax.jit(lambda p, i: model.prefill(p, i, ctx))(
            state.params, feed)
        out[(name, shape)] = dict(
            loss=float(loss), grads=jax.tree.map(np.asarray, grads),
            params=jax.tree.map(np.asarray, new.params),
            prefill=np.asarray(lg, np.float32))
with open(D + "/ref_sp.pkl", "wb") as f:
    pickle.dump(out, f)
""" % (MESHES, STEP_SEQ, STEP_BATCH)


def _inputs(cfg, seed=11):
    """A prefill's global tokens (and patch embeddings or frames)."""
    rng = np.random.default_rng(seed)
    extra, text = {}, POSITIONS
    if cfg.frontend == "vision":
        p = cfg.frontend_tokens
        extra["patch_embeds"] = rng.standard_normal(
            (ROWS, p, cfg.d_model)).astype(np.float32)
        text = POSITIONS - p
    if cfg.is_encdec:
        extra["frames"] = rng.standard_normal(
            (ROWS, 8, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (ROWS, text)).astype(np.int32)
    return dict(tokens=tokens, extra=extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks (with and without sequence parallelism) and the
    reference's sharded runs with it, side by side."""
    d = tmp_path_factory.mktemp("seq_parallel")
    inputs = {}
    for name, (arch, rep) in CASES.items():
        ref_cfg = dataclasses.replace(ref_get(arch).reduced(), **rep)
        cfg = dataclasses.replace(get(arch).reduced(), **rep)
        opt = RefAdamW(learning_rate=ref_constant(1e-2), weight_decay=0.0)
        rs0 = ref_init_state(ref_build(ref_cfg), jax.random.PRNGKey(0), opt)
        state = convert.train_state(cfg, jax.tree.map(np.asarray, rs0),
                                    device="cpu")
        with open(d / f"{name}_state.pkl", "wb") as f:
            pickle.dump(state, f)
        inputs[name] = _inputs(cfg)
    for what, obj in (("cases", CASES), ("inputs", inputs)):
        with open(d / f"{what}.pkl", "wb") as f:
            pickle.dump(obj, f)
    with ThreadPoolExecutor(1) as pool:
        ref_job = pool.submit(run_ref, d, REF_SP, 4, 600)
        run_ranks(d, 4, BODY, timeout=600)
        ref_job.result()
    with open(d / "sp_out.pkl", "rb") as f:
        got = pickle.load(f)
    with open(d / "ref_sp.pkl", "rb") as f:
        ref = pickle.load(f)
    for (name, shape), r in ref.items():
        arch, rep = CASES[name]
        cfg = dataclasses.replace(get(arch).reduced(), **rep)
        r["grads"] = convert.model_params(cfg, r["grads"], device="cpu")
        r["params"] = convert.model_params(cfg, r["params"], device="cpu")
    return got, ref


IDS = dict(ids=lambda s: f"{s[0]}x{s[1]}")


@pytest.mark.parametrize("shape", MESHES, **IDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference_and_plain(name, shape, runs):
    got, ref = runs
    g = got[(name, shape)]
    for what, want in (("the reference's sequence-parallel step", ref[
            (name, shape)]), ("the port's step without it", g["plain"])):
        what = f"{name} {shape} vs {what}"
        hold_loss(g["sp"]["loss"], want["loss"], what)
        hold_grads(g["sp"]["grads"], want["grads"], what)
        hold_params(g["sp"]["params"], want["params"], what)


@pytest.mark.parametrize("shape", MESHES, **IDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_matches_reference_and_plain(name, shape, runs):
    got, ref = runs
    g = got[(name, shape)]
    close(g["sp_prefill"], ref[(name, shape)]["prefill"],
          f"{name} {shape}: prefill vs the reference's sequence parallel")
    close(g["sp_prefill"], g["plain_prefill"],
          f"{name} {shape}: prefill vs the port's without it")


@pytest.mark.parametrize("shape", MESHES, **IDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_residual_stream_holds_its_positions(name, shape, runs):
    """S / tp positions a rank where S divides, every position elsewhere
    and without sequence parallelism; decode's one position whole."""
    got, _ = runs
    g = got[(name, shape)]
    tp = shape[1]
    for tag, batch_rows in (("", STEP_BATCH // shape[0]),
                            ("_prefill", ROWS // shape[0])):
        whole = g["plain"]["stream"] if not tag else g["plain_prefill_stream"]
        mine = g["sp"]["stream"] if not tag else g["sp_prefill_stream"]
        assert whole[0] == mine[0] == batch_rows, (tag, whole, mine)
        s = whole[1]
        want = s // tp if s % tp == 0 else s
        assert mine[1] == want, (tag, s, tp, mine)
        assert mine[2] == whole[2]
    assert s % tp == 0 and mine[1] < whole[1]
    assert g["decode_stream"][1] == 1
