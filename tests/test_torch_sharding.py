"""The port's sharding rules and meshes against the JAX reference's, with no
process group: ``ShardingCtx.spec`` equal, entry for entry, to the
reference's ``PartitionSpec`` for every parameter leaf of all ten configs
(and the activation axes the reference constrains) on the production
meshes ``(16, 16)`` and ``(2, 16, 16)`` and the test meshes ``(4, 2)``,
``(2, 2)`` and ``(1, 1)``, with ``sequence_parallel`` off and on; the
meshes' shapes and rank coordinates; each rank's block of a leaf; and
``check_mesh``, which refuses only ``sequence_parallel``.

The reference's side needs no devices: ``from_mesh`` of a
``jax.sharding.AbstractMesh`` builds its specs.  Specs are compared
exactly (they are names, not numbers)."""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_configs as ref_all_configs
from repro.models import build as ref_build
from repro.models.sharding import from_mesh as ref_from_mesh
from repro_torch.configs import get
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import build, sharding
from repro_torch.models.schema import Leaf

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = sorted(ref_all_configs())
#: activation layouts the reference constrains (``ctx.constrain``)
ACTIVATIONS = [
    (("batch", "seq", "embed_act"), (256, 4096, 960)),
    (("batch", "seq", "vocab"), (256, 4096, 49152)),
    (("batch", "seq", "mlp"), (256, 4096, 2560)),
    (("batch", "seq", "kv_heads", None, None), (32, 4096, 8, 5, 128)),
    (("batch", "seq", "heads", None), (32, 4096, 15, 64)),
    (("batch", "attn_q_seq", None, None, None), (32, 4096, 5, 3, 64)),
    (("batch", None, None, None), (32, 4096, 5, 64)),
    (("batch", "seq_kv", "kv_heads", "head_dim"), (128, 32768, 8, 128)),
    (("batch", "seq", "lru"), (7, 4096, 2560)),
    (("batch", "seq", "ssm_inner"), (3, 4096, 5120)),
    (("layers", "embed", "heads", "head_dim"), (32, 960, 15, 64)),
]


def _ctxs(mesh_name, sequence_parallel):
    shape, names = MESHES[mesh_name]
    ref = ref_from_mesh(jax.sharding.AbstractMesh(shape, names),
                        sequence_parallel=sequence_parallel)
    port = sharding.from_mesh(Mesh(shape, names),
                              sequence_parallel=sequence_parallel)
    return ref, port


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _leaves(schema):
    return [leaf for leaf in _flat(schema).values()]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference(arch, mesh_name):
    """Every parameter leaf's spec of the port's model equals the
    reference's (a stacked ``[L, ...]`` leaf's spec less its leading
    ``layers`` entry, which is ``None``); and the two spec functions agree
    on every leaf of both schemas and on the activation layouts."""
    ref_model, model = ref_build(ref_all_configs()[arch]), build(get(arch))
    for sp in (False, True):
        ref_ctx, ctx = _ctxs(mesh_name, sp)
        ref_specs = {k: tuple(v) for k, v in _flat(jax.tree.map(
            lambda s: s, ref_model.param_specs(ref_ctx),
            is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))).items()}
        port_specs = _flat(model.param_specs(ctx))
        assert port_specs, arch
        for path, spec in port_specs.items():
            ref_path = re.sub(r"layer_\d\d\.", "", path)
            stacked = ref_path not in port_specs
            if path not in ref_specs and stacked:
                want = ref_specs[ref_path]
                assert not want or want[0] is None, (path, want)
                want = want[1:]
            else:
                want = ref_specs[path]
            assert spec == want, (arch, mesh_name, sp, path, spec, want)
        inputs = [(leaf.axes, leaf.shape) for leaf in
                  _leaves(ref_model.schema) + _leaves(model.schema)]
        for axes, shape in inputs + ACTIVATIONS:
            for s in (shape, None):
                assert ctx.spec(axes, s) == tuple(ref_ctx.spec(axes, s)), \
                    (axes, s, sp)


def test_ctx_sizes_match_reference():
    for name in MESHES:
        ref_ctx, ctx = _ctxs(name, False)
        assert ctx.dp_axes == ref_ctx.dp_axes
        assert (ctx.tp_axis, ctx.fsdp_axis) == (ref_ctx.tp_axis,
                                               ref_ctx.fsdp_axis)
        assert (ctx.dp_size(), ctx.tp_size()) == (ref_ctx.dp_size(),
                                                  ref_ctx.tp_size())
    off = sharding.ShardingCtx()
    assert not off.enabled and off.spec(("batch", "vocab"), (4, 8)) == ()


def test_production_and_test_meshes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m2 = make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_test_mesh(4, 2).shape == {"data": 4, "model": 2}
    assert not m.live
    with pytest.raises(RuntimeError, match="abstract"):
        m.group("data")
    with pytest.raises(ValueError):
        Mesh((2, 0), ("data", "model"))


def test_rank_coordinates_are_row_major():
    m = Mesh((2, 3, 4), ("pod", "data", "model"))
    seen = set()
    for r in range(m.size):
        c = m.coords(r)
        assert r == (c["pod"] * 3 + c["data"]) * 4 + c["model"]
        seen.add(tuple(c.values()))
    assert len(seen) == m.size


@pytest.mark.parametrize("rank", range(8))
def test_blocks_tile_the_leaf(rank):
    """Each rank's block (``sharding.block``) of a leaf sharded over
    ``('pod', 'data')`` and 'model': the blocks of all ranks tile the
    leaf, replicas hold the same block, and ``shard`` copies it."""
    shape, names = (2, 2, 2), ("pod", "data", "model")
    full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for spec, local, copies in (((("pod", "data"), "model"), (2, 3, 4), 1),
                                ((("pod", "data"),), (2, 6, 4), 2)):
        hits = torch.zeros_like(full)
        for r in range(8):
            ctx = sharding.from_mesh(Mesh(shape, names, rank=r))
            blk = sharding.block(tuple(full.shape), spec, ctx)
            hits[blk] += 1
            if r == rank:
                got = sharding.shard(full, spec, ctx)
                assert torch.equal(got, full[blk])
                assert tuple(got.shape) == sharding.local_shape(
                    tuple(full.shape), spec, ctx) == local
        assert torch.equal(hits, torch.full_like(full, float(copies)))
    # a leaf replicated over every axis is each rank's whole leaf
    ctx = sharding.from_mesh(Mesh(shape, names, rank=rank))
    assert torch.equal(sharding.shard(full, (), ctx), full)


@pytest.mark.parametrize("arch", [
    "smollm-360m", "olmoe-1b-7b", "llama4-scout-17b-a16e",
    "recurrentgemma-2b", "mamba2-2.7b", "internvl2-1b",
    "seamless-m4t-large-v2"])
def test_tensor_parallel_families(arch):
    """Every family runs tensor parallel: ``check_mesh`` passes under
    ``(2, 2)`` and ``(4, 1)``, and with ``sequence_parallel`` too, whose
    residual stream splits where the positions divide over 'model'."""
    model = build(get(arch).reduced())
    model.check_mesh(sharding.from_mesh(make_test_mesh(2, 2)))
    model.check_mesh(sharding.from_mesh(make_test_mesh(4, 1)))
    sp = sharding.from_mesh(make_test_mesh(1, 2), sequence_parallel=True)
    model.check_mesh(sp)
    assert sharding.seq_split(16, sp) and not sharding.seq_split(1, sp)
    assert not sharding.seq_split(16, sharding.from_mesh(
        make_test_mesh(1, 2)))


def test_leaf_specs_cover_every_logical_axis():
    """Each logical axis of the port's schemas resolves under the rules
    (a name missing from ``DEFAULT_RULES`` would stay replicated
    silently)."""
    ctx = sharding.from_mesh(make_test_mesh(2, 2))
    for arch in ARCHS:
        for leaf in _leaves(build(get(arch)).schema):
            assert isinstance(leaf, Leaf)
            for ax in leaf.axes:
                assert ax is None or ax in sharding.DEFAULT_RULES, ax
    assert np.prod(list(ctx.mesh.shape.values())) == 4
