"""Prefill, decode and the serving engine under a ``(data, model)`` mesh on
the CPU under gloo (four ranks, one spawned world for every case), against
the JAX reference's single-device functions.

  (c) a prefill of 4 rows (16 positions, a vision model's 8 patch rows
      among them; an encoder-decoder's 8 frames) and three teacher-forced
      decode steps of one reduced config of each family (``smollm-360m``,
      ``olmoe-1b-7b`` at capacity factor 8, ``recurrentgemma-2b``,
      ``mamba2-2.7b``, ``internvl2-1b``, ``seamless-m4t-large-v2``) under
      ``(2, 2)`` and ``(1, 4)``, the caches padded to 96 positions: every
      step's logits and the caches gathered back after the prefill and the
      last step within ``TOL_EPS`` = 8 bf16 epsilons of the reference's
      largest value (``tests/test_torch_models.py``'s serving bound; the
      split softmax of the context-parallel decode cannot round its
      weights to bf16 where one device does), and every cache leaf that
      the spec replicates over 'model' bitwise equal on every rank after
      every step;
  (d) ``ServingEngine(ctx=)`` at ``(2, 2)``: ``recurrentgemma-2b`` with 2
      slots (the reference's engine needs two, R5), 4 requests of 4-11
      tokens, 8 new tokens each; its tokens equal the port's
      single-device engine's wherever that engine's top-2 logit gap
      exceeds the bound, and its logits are within the bound of that
      engine's until their tokens part.

Both are also held, at the same bound, against the reference's own sharded
prefill and decode on the same mesh shapes of 4 host devices.  These run
only on a mesh whose axes are ``Auto``: on the ``Explicit`` meshes that
``jax.make_mesh`` builds by default under the installed JAX, which the
reference's ``launch/mesh.py`` returns, its first sharding constraint
raises (ROADMAP.md, R2)."""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get
from repro_torch.models import build
from repro_torch.serve.engine import Request, ServingEngine
from test_torch_distributed import run_ranks, run_ref
from test_torch_models import BF16_EPS, MAX_LEN, TOL_EPS, Pair, close
from test_torch_serve import Tap

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
ROWS, POSITIONS, STEPS = 4, 16, 3
#: the engine case
ENGINE_ARCH, ENGINE_SLOTS, ENGINE_MAX_LEN = "recurrentgemma-2b", 2, 64
ENGINE_LENS, ENGINE_NEW = (4, 11, 7, 9), 8

BODY = '''
def leaves(tree, specs):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t, s in zip(tree, specs) for x in leaves(t, s)]
    return [(tree, specs)]


def replicated_equal(caches, specs, ctx):
    """Every leaf the spec keeps whole over 'model' has the same bits on
    every 'model' rank."""
    ok = True
    for t, spec in leaves(caches, specs):
        if "model" in sharding.sharded_axes(spec):
            continue
        every = sharding.all_gather(t[None], ctx, "model", 0)
        ok &= all(torch.equal(every[0], every[i])
                  for i in range(every.shape[0]))
    return bool(ok)


class Tap:
    def __init__(self, model):
        self.model, self.prefills, self.rows, self.engine = model, [], {}, \\
            None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        logits, caches = self.model.prefill(*args, **kw)
        self.prefills.append(logits[0].float().numpy())
        return logits, caches

    def decode_step(self, *args, **kw):
        logits, caches = self.model.decode_step(*args, **kw)
        for i, req in enumerate(self.engine.active):
            if req is not None:
                self.rows.setdefault(req.rid, []).append(
                    logits[i].float().numpy())
        return logits, caches


def body(rank, world, d):
    from repro_torch.serve.engine import Request, ServingEngine
    cases, inputs = load(d, "cases.pkl"), load(d, "inputs.pkl")
    out = {}
    for shape in %r:
        ctx = sharding.from_mesh(mesh_mod.init_mesh(shape, ("data",
                                                            "model")))
        for name, (arch, rep) in cases.items():
            cfg = dataclasses.replace(get(arch).reduced(), **rep)
            model = build(cfg)
            params = model.shard_params(load(d, f"{name}_params.pkl"), ctx)
            inp = inputs[name]
            extra = {k: torch.from_numpy(v) for k, v in inp["extra"].items()}
            logits, caches = model.prefill(
                params, torch.from_numpy(inp["tokens"]).long(),
                pad_cache_to=%d, ctx=ctx, **extra)
            specs = model.cache_specs(ctx, %d, %d)
            rec = dict(logits=[logits.float()],
                       prefill_caches=sharding.unshard_tree(caches, specs,
                                                            ctx),
                       same=replicated_equal(caches, specs, ctx))
            for tok, pos in inp["steps"]:
                logits, caches = model.decode_step(
                    params, torch.from_numpy(tok).long(),
                    caches, torch.from_numpy(pos).long(), ctx=ctx)
                rec["logits"].append(logits.float())
                rec["same"] &= replicated_equal(caches, specs, ctx)
            rec["caches"] = sharding.unshard_tree(caches, specs, ctx)
            out[(name, shape)] = rec
    # (d) the engine at (2, 2)
    ctx = sharding.from_mesh(mesh_mod.init_mesh((2, 2), ("data", "model")))
    eng_in = load(d, "engine.pkl")
    model = build(get(eng_in["arch"]).reduced())
    tap = Tap(model)
    eng = ServingEngine(tap, model.shard_params(eng_in["params"], ctx),
                        batch_slots=eng_in["slots"],
                        max_len=eng_in["max_len"], device="cpu", ctx=ctx)
    tap.engine = eng
    for i, p in enumerate(eng_in["prompts"]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=eng_in["new"]))
    done = {r.rid: r.generated for r in eng.run_until_drained()}
    out["engine"] = dict(done=done, prefills=tap.prefills, rows=tap.rows,
                         traffic=dict(sharding.traffic))
    if rank == 0:
        save(out, d, "serve_out.pkl")
''' % (MESHES, MAX_LEN, ROWS, MAX_LEN)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(c):
    if isinstance(c, dict):
        return [t for k in sorted(c) for t in _flat(c[k])]
    if isinstance(c, (tuple, list)):
        return [t for x in c for t in _flat(x)]
    return [c]


def _reference(name, arch, rep, d):
    """The reference's single-device prefill and teacher-forced decode
    steps of one case (its tokens feed the port's ranks)."""
    pair = Pair(arch, **rep)
    cfg = pair.cfg
    rng = np.random.default_rng(11)
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
    rl, rc = pair.ref_prefill(pair.ref_params, jnp.asarray(tokens), **extra)
    want = dict(logits=[np.asarray(rl, np.float32)],
                prefill_caches=convert.decode_caches(cfg, _np(rc),
                                                     device="cpu"))
    steps = []
    offset = POSITIONS - text if cfg.frontend == "vision" else 0
    for step in range(STEPS):
        tok = np.argmax(np.asarray(want["logits"][-1]), axis=-1)[:, None]
        pos = np.full((ROWS, 1), offset + text + step, np.int32)
        steps.append((tok.astype(np.int32), pos))
        rl, rc = pair.ref_decode(pair.ref_params, jnp.asarray(tok, jnp.int32),
                                 rc, jnp.asarray(pos))
        want["logits"].append(np.asarray(rl, np.float32))
    want["caches"] = convert.decode_caches(cfg, _np(rc), device="cpu")
    with open(d / f"{name}_params.pkl", "wb") as f:
        pickle.dump(pair.params, f)
    with open(d / f"{name}_ref_params.pkl", "wb") as f:
        pickle.dump(_np(pair.ref_params), f)
    return want, dict(tokens=tokens, extra=extra, steps=steps)


#: the reference's sharded prefill and decode steps of every case on a
#: mesh of 4 host devices whose axes are ``Auto`` (on the ``Explicit``
#: meshes that ``jax.make_mesh`` builds by default they fail, R2)
REF_SHARDED = """
import dataclasses, pickle
from jax.sharding import AxisType
from repro.configs import get
from repro.models import build, from_mesh
with open(D + "/cases.pkl", "rb") as f:
    cases = pickle.load(f)
with open(D + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
out = {}
for shape in %r:
    ctx = from_mesh(jax.make_mesh(shape, ("data", "model"),
                                  axis_types=(AxisType.Auto,) * 2))
    for name, (arch, rep) in cases.items():
        model = build(dataclasses.replace(get(arch).reduced(), **rep))
        with open(D + f"/{name}_ref_params.pkl", "rb") as f:
            params = pickle.load(f)
        inp = inputs[name]
        feed = {"tokens": jnp.asarray(inp["tokens"]),
                **{k: jnp.asarray(v) for k, v in inp["extra"].items()}}
        lg, c = jax.jit(lambda p, i: model.prefill(
            p, i, ctx, pad_cache_to=%d))(params, feed)
        rec = dict(logits=[np.asarray(lg, np.float32)],
                   prefill_caches=jax.tree.map(np.asarray, c))
        decode = jax.jit(lambda p, t, c, pos: model.decode_step(
            p, t, c, pos, ctx))
        for tok, pos in inp["steps"]:
            lg, c = decode(params, jnp.asarray(tok), c, jnp.asarray(pos))
            rec["logits"].append(np.asarray(lg, np.float32))
        rec["caches"] = jax.tree.map(np.asarray, c)
        out[(name, shape)] = rec
with open(D + "/ref_sharded.pkl", "wb") as f:
    pickle.dump(out, f)
""" % (MESHES, MAX_LEN)


def _engine_single(d):
    """The port's single-device engine on the weights the ranks shard."""
    pair = Pair(ENGINE_ARCH)
    model, params = pair.model, pair.params
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in ENGINE_LENS]
    tap = Tap(model)
    eng = ServingEngine(tap, params, batch_slots=ENGINE_SLOTS,
                        max_len=ENGINE_MAX_LEN, device="cpu")
    tap.engine = eng
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=ENGINE_NEW))
    done = {r.rid: r.generated for r in eng.run_until_drained()}
    with open(d / "engine.pkl", "wb") as f:
        pickle.dump(dict(arch=ENGINE_ARCH, params=params, prompts=prompts,
                         slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                         new=ENGINE_NEW), f)
    return done, tap


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serving")
    want, inputs = {}, {}
    for name, (arch, rep) in CASES.items():
        want[name], inputs[name] = _reference(name, arch, rep, d)
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(CASES, f)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    single = _engine_single(d)
    run_ranks(d, 4, BODY, timeout=600)
    run_ref(d, REF_SHARDED, devices=4, timeout=600)
    with open(d / "serve_out.pkl", "rb") as f:
        got = pickle.load(f)
    with open(d / "ref_sharded.pkl", "rb") as f:
        ref_sharded = pickle.load(f)
    for (name, shape), rec in ref_sharded.items():
        arch, rep = CASES[name]
        cfg = build(dataclasses.replace(get(arch).reduced(), **rep)).cfg
        for tag in ("prefill_caches", "caches"):
            rec[tag] = convert.decode_caches(cfg, rec[tag], device="cpu")
    return want, single, got, ref_sharded


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_decode_match_reference(name, shape, served):
    """Against the reference's single-device run and its own sharded run
    on the same mesh shape."""
    want, _, got, ref_sharded = served
    g = got[(name, shape)]
    assert g["same"], f"{name} {shape}: a replicated cache leaf differs " \
        f"across 'model' ranks"
    for side, w in (("single device", want[name]),
                    ("sharded", ref_sharded[(name, shape)])):
        what = f"{name} {shape} vs the reference's {side}"
        assert len(g["logits"]) == len(w["logits"]) == STEPS + 1
        for step, (gl, wl) in enumerate(zip(g["logits"], w["logits"])):
            close(gl, wl, f"{what}: logits step {step}")
        for tag in ("prefill_caches", "caches"):
            assert sorted(g[tag]) == sorted(w[tag])
            for layer in w[tag]:
                for i, (gc, wc) in enumerate(zip(_flat(g[tag][layer]),
                                                 _flat(w[tag][layer]))):
                    close(gc, wc, f"{what}: {tag} {layer}[{i}]")


def test_engine_under_mesh_matches_single_device(served):
    _, (done, tap), got, _ = served
    eng = got["engine"]
    assert sorted(eng["done"]) == sorted(done) == list(range(len(ENGINE_LENS)))
    agreed = 0
    for rid in sorted(done):
        want, mine = done[rid], eng["done"][rid]
        assert len(mine) == len(want) == ENGINE_NEW
        ref_rows = tap.logits(rid)
        rows = [eng["prefills"][rid]] + eng["rows"].get(rid, [])
        for j, (w, g) in enumerate(zip(want, mine)):
            tol = TOL_EPS * BF16_EPS * float(np.abs(ref_rows[j]).max())
            err = float(np.abs(rows[j] - ref_rows[j]).max())
            assert err <= tol, (rid, j, err, tol)
            if g != w:
                gap = float(ref_rows[j][w] - ref_rows[j][g])
                assert gap <= tol, (rid, j, g, w, gap, tol)
                break
        else:
            agreed += 1
    assert agreed, "every request parted at a near tie"
    assert eng["traffic"]["calls"] > 0
