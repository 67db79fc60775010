"""The dry run (``repro_torch.launch.dryrun``), its counts
(``repro_torch.roofline.counts``) and the roofline analysis against the JAX
reference's (``repro.launch.dryrun``, ``repro.roofline``).

  * the meta fields of every cell of the ten configs on both production
    meshes equal the reference's exactly, its side computed from its
    specs on a ``jax.sharding.AbstractMesh`` and ``jax.eval_shape`` (no
    compile);
  * on the same counts, ``analyze``, ``memsys_bridge``,
    ``is_cell_artifact`` and ``bridge_design_space`` give the reference's
    answers (labels and mix names exactly, numbers to rel 1e-6), the
    reference's ``ChipSpec`` built with the port's H100 constants and its
    HLO cost model replaced, in this process, by the same counts;
  * the traced per-chip dot FLOPs of each family's train, prefill and
    decode cell at two layers (one sequence-parallel cell, one multi-pod
    cell) against the reference's own ``run_cell`` on 512 host devices in
    a subprocess, on a production mesh with ``Auto`` axes (its
    ``Explicit`` mesh fails under the installed JAX: ROADMAP.md, R10):
    within 5% where the two do the same work, elsewhere within 2% of a
    pinned ratio whose cause the test names and checks; the read fraction
    (reads and writes counted apart) within 0.3 of the reference's (its
    total split by XLA's output fraction);
  * the counts of one linear layer, one attention, one SSD and one RG-LRU
    call equal their hand counts exactly, and each kernel operator's fake
    output has the shape and dtype of its plain version's;
  * a reduced cell traced on a 16 x 16 loopback mesh takes seconds."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import all_configs as ref_all_configs
from repro.configs import applicable as ref_applicable
from repro.configs import microbatches_for as ref_microbatches
from repro.models import build as ref_build
from repro.models.sharding import from_mesh as ref_from_mesh
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_parse as ref_hlo
from repro.roofline.hw import ChipSpec as RefChipSpec
from repro.train import AdamW as RefAdamW
from repro.train import constant_schedule as ref_constant
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import state_specs as ref_state_specs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan.ref import lru_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention, sharding
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.counts import Counter

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
REL = 1e-6


# -- meta fields -------------------------------------------------------------------

def _ref_bytes(avals, specs, mesh_shape):
    """The reference dry run's ``_tree_device_bytes`` on specs: each leaf's
    bytes floor-divided by its spec's shards."""
    total = 0
    for aval, spec in zip(jax.tree.leaves(avals), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        n = int(np.prod(aval.shape)) * aval.dtype.itemsize
        used = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        total += n // math.prod(mesh_shape[a] for a in used)
    return total


def _ref_meta(arch, shape_name, mesh_name):
    cfg = ref_all_configs()[arch]
    shape = REF_SHAPES[shape_name]
    mshape, names = MESHES[mesh_name]
    ctx = ref_from_mesh(jax.sharding.AbstractMesh(mshape, names))

    class SpecCtx(type(ctx)):
        def sharding(self, axes, shape=None):
            return self.spec(axes, shape)

    sctx = SpecCtx(**{f.name: getattr(ctx, f.name)
                      for f in dataclasses.fields(ctx)})
    model = ref_build(cfg)
    sizes = dict(zip(names, mshape))
    meta = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "chips": math.prod(mshape), "params": model.param_count(),
            "active_params": cfg.active_param_count()}
    if shape.kind == "train":
        meta["num_microbatches"] = ref_microbatches(cfg, shape,
                                                    ctx.dp_size())
        opt = RefAdamW(learning_rate=ref_constant(1e-4))
        state = jax.eval_shape(lambda k: ref_init_state(model, k, opt),
                               jax.random.PRNGKey(0))
        meta["state_bytes_per_chip"] = _ref_bytes(
            state, ref_state_specs(model, ctx), sizes)
        meta["model_flops"] = 6.0 * cfg.active_param_count() \
            * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        meta["model_flops"] = 2.0 * cfg.active_param_count() \
            * shape.global_batch * shape.seq_len
    else:
        meta["model_flops"] = 2.0 * cfg.active_param_count() \
            * shape.global_batch
        specs = model.input_specs(shape)
        meta["cache_bytes_per_chip"] = _ref_bytes(
            specs["caches"],
            model.input_shardings(shape, sctx, specs)["caches"], sizes)
    return meta


META_CELLS = [(a, s, m) for a in sorted(ref_all_configs())
              for s in REF_SHAPES if ref_applicable(
                  ref_all_configs()[a], REF_SHAPES[s])[0]
              for m in MESHES]


@pytest.mark.parametrize("arch,shape,mesh", META_CELLS)
def test_meta_fields_equal_reference(arch, shape, mesh):
    got = dryrun.cell_meta(arch, shape, multi_pod=mesh == "2x16x16")
    assert got == _ref_meta(arch, shape, mesh)


# -- same numbers in, same answers out ------------------------------------------

COUNTS = {"flops": 3.1e12, "read_bytes": 6.2e10, "write_bytes": 2.9e10,
          "collective_bytes": 4.4e9}
REF_CHIP = RefChipSpec(**dataclasses.asdict(hw.H100))


def _ref_report(monkeypatch, counts, name="smollm-360m", shape="train_4k"):
    metrics = ref_hlo.Metrics(
        flops=counts["flops"],
        bytes_accessed=counts["read_bytes"] + counts["write_bytes"],
        collective_bytes=counts["collective_bytes"])
    monkeypatch.setattr(ref_hlo, "loop_weighted_metrics", lambda h: metrics)
    cost = {"bytes accessed": counts["read_bytes"] + counts["write_bytes"],
            "bytes accessedout{}": counts["write_bytes"]}
    return ref_analysis.analyze(name, shape, "16x16", 256, cost, "",
                                4.2e14, chip=REF_CHIP,
                                peak_memory_bytes=1.5e9)


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, (path, got, want)
    else:
        w, g = float(want), float(got)
        assert (math.isinf(w) and g == w) or \
            abs(g - w) <= REL * max(abs(w), 1e-30), (path, g, w)


@pytest.mark.parametrize("counts", [
    COUNTS, dict(COUNTS, flops=1e9, collective_bytes=9e10),
    dict(COUNTS, flops=1e9, collective_bytes=0.0, write_bytes=1e7)],
    ids=["compute", "collective", "memory"])
def test_analyze_and_bridge_equal_reference(counts, monkeypatch):
    want = _ref_report(monkeypatch, counts)
    got = analysis.analyze("smollm-360m", "train_4k", "16x16", 256, counts,
                           4.2e14, peak_memory_bytes=1.5e9)
    _same(dataclasses.asdict(got), dataclasses.asdict(want))
    _same(analysis.memsys_bridge(got, device="cpu"),
          ref_analysis.memsys_bridge(want, chip=REF_CHIP))


def test_bridge_design_space_equals_reference(monkeypatch):
    mixes = {"a": COUNTS, "b": dict(COUNTS, read_bytes=1e9, write_bytes=8e9),
             "c": dict(COUNTS, write_bytes=1e6)}
    want = {n: _ref_report(monkeypatch, c, name=n) for n, c in mixes.items()}
    got = {n: analysis.analyze(n, "train_4k", "16x16", 256, c, 4.2e14,
                               peak_memory_bytes=1.5e9)
           for n, c in mixes.items()}
    _same(analysis.bridge_design_space(got, device="cpu"),
          ref_analysis.bridge_design_space(want))


@pytest.mark.parametrize("d", [
    {"arch": "a", "shape": "s", "mesh": "m", "roofline": {}},
    {"arch": "a", "shape": "s", "mesh": "m"},
    {"arch": "a", "shape": "s", "mesh": "m", "roofline": {},
     "axes": ["phy", "mix"]},
    {"arch": "a", "shape": "s", "mesh": "m", "roofline": {},
     "axes": {"catalog_param": 3}},
    {"arch": "a", "shape": "s", "mesh": "m", "roofline": {},
     "axes": ["mix"]},
    [1, 2], "design_space"])
def test_is_cell_artifact_equals_reference(d):
    assert analysis.is_cell_artifact(d) == ref_analysis.is_cell_artifact(d)


# -- counts against the reference's run_cell ----------------------------------------

QSEQ = ("the port's q_seq attention layout (heads do not divide 16) "
        "projects q, k and v whole on every 'model' rank where GSPMD splits "
        "the projections by rows, and its decode projects the new token "
        "with every head on every rank")
BWD = ("the port's attention backward recomputes the forward "
       "(attention_ref) before its VJP")
GATES = ("the port's RG-LRU gates compute the one 256-wide head block a "
         "rank's 160 channels fall in, where GSPMD's layout computes 5 of "
         "the 10 heads' blocks on every rank")
SP = ("the port's sequence parallelism keeps each region's compute "
      "replicated over 'model' (it shards the residual stream only), where "
      "GSPMD also shards the regions' row-wise work")
#: name -> (arch, shape, multi-pod, sequence parallel, pinned port /
#: reference dot-FLOP ratio or None (the same work: within 5%), causes)
REF_CELLS = {
    "smollm-360m__train_4k": ("smollm-360m", "train_4k", False, False,
                              1.6732, (QSEQ, BWD)),
    "smollm-360m__prefill_32k": ("smollm-360m", "prefill_32k", False, False,
                                 1.2022, (QSEQ,)),
    "smollm-360m__decode_32k": ("smollm-360m", "decode_32k", False, False,
                                1.2091, (QSEQ,)),
    "recurrentgemma-2b__train_4k": ("recurrentgemma-2b", "train_4k", False,
                                    False, None, ()),
    "recurrentgemma-2b__prefill_32k": ("recurrentgemma-2b", "prefill_32k",
                                       False, False, 0.9059, (GATES,)),
    "recurrentgemma-2b__decode_32k": ("recurrentgemma-2b", "decode_32k",
                                      False, False, None, ()),
    "mamba2-2.7b__train_4k": ("mamba2-2.7b", "train_4k", False, False, None,
                              ()),
    "mamba2-2.7b__prefill_32k": ("mamba2-2.7b", "prefill_32k", False, False,
                                 None, ()),
    "mamba2-2.7b__decode_32k": ("mamba2-2.7b", "decode_32k", False, False,
                                None, ()),
    "olmoe-1b-7b__train_4k": ("olmoe-1b-7b", "train_4k", False, False, None,
                              ()),
    "olmoe-1b-7b__prefill_32k": ("olmoe-1b-7b", "prefill_32k", False, False,
                                 None, ()),
    "olmoe-1b-7b__decode_32k": ("olmoe-1b-7b", "decode_32k", False, False,
                                None, ()),
    "internvl2-1b__train_4k": ("internvl2-1b", "train_4k", False, False,
                               1.3009, (QSEQ, BWD)),
    "internvl2-1b__prefill_32k": ("internvl2-1b", "prefill_32k", False,
                                  False, 1.1813, (QSEQ,)),
    "internvl2-1b__decode_32k": ("internvl2-1b", "decode_32k", False, False,
                                 1.1007, (QSEQ,)),
    "seamless-m4t-large-v2__train_4k": ("seamless-m4t-large-v2", "train_4k",
                                        False, False, 1.0670, (BWD,)),
    "seamless-m4t-large-v2__prefill_32k": ("seamless-m4t-large-v2",
                                           "prefill_32k", False, False, None,
                                           ()),
    "seamless-m4t-large-v2__decode_32k": ("seamless-m4t-large-v2",
                                          "decode_32k", False, False, None,
                                          ()),
    "smollm-360m__train_4k__sp": ("smollm-360m", "train_4k", False, True,
                                  1.9851, (QSEQ, BWD, SP)),
    "mamba2-2.7b__decode_32k__2x16x16": ("mamba2-2.7b", "decode_32k", True,
                                         False, None, ()),
}
LAYERS = 2

REF_RUN = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as dr


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


dr.make_production_mesh = auto_mesh
cells = json.loads(sys.argv[1])
out = {}
for name, (arch, shape, mp, sp) in cells.items():
    r = dr.run_cell(arch, shape, multi_pod=mp, sequence_parallel=sp,
                    verbose=False, cfg_overrides=dict(num_layers=%d))
    out[name] = r["roofline"]
print(json.dumps(out))
""" % LAYERS


def _reference_cells():
    cells = {n: c[:4] for n, c in REF_CELLS.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_RUN),
                          json.dumps(cells)], capture_output=True, text=True,
                         timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-8000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cell_counts():
    """The reference's rooflines (a subprocess) beside the port's traces."""
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(_reference_cells)
        got = {}
        for name, (arch, shape, mp, sp, _, _) in REF_CELLS.items():
            got[name] = dryrun.trace_cell(
                arch, shape, multi_pod=mp, sequence_parallel=sp,
                device="cpu", cfg_overrides=dict(num_layers=LAYERS))
        return got, job.result()


def _cause_holds(cause, arch, shape, sp):
    """Each named cause is checked, not only named."""
    from repro_torch.configs import get
    from repro_torch.configs.shapes import SHAPES
    cfg = get(arch)
    ctx = sharding.from_mesh(Mesh((16, 16), ("data", "model")),
                             sequence_parallel=sp)
    if cause is QSEQ:
        return attention.tp_branch(cfg, 1024, ctx) == "q_seq"
    if cause is BWD:
        return SHAPES[shape].kind == "train" and "attn" in \
            " ".join(cfg.layer_kinds())
    if cause is GATES:
        return cfg.d_model // 16 % (cfg.d_model // cfg.lru_heads) != 0
    if cause is SP:
        return sp
    raise AssertionError(cause)


@pytest.mark.parametrize("name", sorted(REF_CELLS))
def test_counts_against_reference_run_cell(name, cell_counts):
    got, ref = cell_counts
    arch, shape, mp, sp, pinned, causes = REF_CELLS[name]
    counts, meta = got[name]
    want = ref[name]
    assert meta["chips"] == want["chips"]
    ratio = counts.flops / want["hlo_flops_per_chip"]
    if pinned is None:
        assert 0.95 <= ratio <= 1.05, (name, ratio)
    else:
        assert abs(ratio / pinned - 1.0) <= 0.02, (name, ratio, pinned)
        assert causes and all(_cause_holds(c, arch, shape, sp)
                              for c in causes), (name, causes)
    for c in (counts.read_bytes, counts.write_bytes,
              counts.collective_bytes, counts.peak_live_bytes):
        assert math.isfinite(c) and c > 0, name
    # reads and writes counted apart against the reference's split of its
    # total by XLA's output fraction (of the unfused CPU HLO, loop bodies
    # once): the read fractions part by at most 0.3 (0.283 at
    # mamba2-2.7b's prefill, where the reference counts 0.779)
    rf = counts.read_bytes / (counts.read_bytes + counts.write_bytes)
    want_rf = want["read_bytes_per_chip"] / (want["read_bytes_per_chip"]
                                             + want["write_bytes_per_chip"])
    assert abs(rf - want_rf) <= 0.3, (name, rf, want_rf)
    assert counts.by_kind and set(counts.by_kind) <= {"all_reduce",
                                                      "all_gather"}


def test_every_kernel_operator_is_counted(cell_counts):
    """The LM kernels run as operators in the traced cells (nothing is
    launched, no scan unrolled) in the families that have them."""
    got, _ = cell_counts
    calls = lambda n: got[n][0].kernel_calls
    assert calls("smollm-360m__train_4k").get(
        "repro_torch::flash_attention_fwd", 0) > 0
    assert calls("mamba2-2.7b__prefill_32k").get("repro_torch::ssd_scan") \
        == LAYERS
    assert calls("recurrentgemma-2b__prefill_32k").get(
        "repro_torch::rglru_scan") == LAYERS


# -- hand counts and fake shapes ----------------------------------------------------

def _count(fn, *inputs):
    with FakeTensorMode():
        fake = [torch.empty(t.shape, dtype=t.dtype) for t in inputs]
        c = Counter(inputs=fake)
        with c:
            fn(*fake)
    return c.result()


def test_linear_layer_hand_count():
    x = torch.zeros(4, 8, 24, dtype=torch.bfloat16)
    w = torch.zeros(24, 16, dtype=torch.bfloat16)
    c = _count(lambda a, b: torch.matmul(a, b), x, w)
    assert c.flops == 2 * 32 * 24 * 16
    assert c.read_bytes == 2 * (32 * 24 + 24 * 16)
    assert c.write_bytes == 2 * 32 * 16


def test_attention_hand_count():
    b, kh, g, sq, skv, hd = 2, 3, 2, 8, 8, 16
    q = torch.zeros(b, kh, g, sq, hd, dtype=torch.bfloat16)
    kv = torch.zeros(b, kh, skv, hd, dtype=torch.bfloat16)
    c = _count(lambda q, k, v: fa_ops.flash_attention(q, k, v, True), q, kv,
               kv)
    assert c.kernel_calls == {"repro_torch::flash_attention_fwd": 1}
    assert c.flops == 4 * b * kh * g * sq * skv * hd
    assert c.read_bytes == 2 * (q.numel() + 2 * kv.numel())
    assert c.write_bytes == 2 * q.numel()


def test_ssd_hand_count():
    bsz, s, h, p, n, chunk = 2, 24, 3, 4, 5, 8
    f = torch.float32
    ins = (torch.zeros(bsz, s, h, p, dtype=f), torch.zeros(bsz, s, h, dtype=f),
           torch.zeros(bsz, s, n, dtype=f), torch.zeros(bsz, s, n, dtype=f),
           torch.zeros(h, dtype=f))
    c = _count(lambda *a: ssd_ops.ssd(*a, chunk=chunk), *ins)
    assert c.kernel_calls == {"repro_torch::ssd_scan": 1}
    nc = s // chunk
    assert c.flops == 2 * bsz * nc * chunk * (chunk * n + h * chunk * p
                                              + 2 * h * n * p)
    assert c.read_bytes == 4 * sum(t.numel() for t in ins)
    assert c.write_bytes == 4 * (bsz * s * h * p + bsz * h * p * n)


def test_rglru_hand_count():
    log_a = torch.zeros(2, 16, 12)
    c = _count(lru_ops.lru, log_a, log_a)
    assert c.kernel_calls == {"repro_torch::rglru_scan": 1}
    assert c.flops == 0
    assert c.read_bytes == 2 * 4 * log_a.numel()
    assert c.write_bytes == 4 * log_a.numel()


def test_fake_outputs_match_plain_versions():
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    q, kv = rnd(1, 2, 2, 8, 16).bfloat16(), rnd(1, 2, 8, 16).bfloat16()
    x, dt = rnd(1, 12, 2, 4), torch.rand(1, 12, 2, generator=gen)
    b, a_log = rnd(1, 12, 3), rnd(2)
    la, bb = -torch.rand(1, 9, 5, generator=gen), rnd(1, 9, 5)
    plain = {
        "flash": attention_ref(q, kv, kv, causal=True),
        "ssd": ssd_ops.chunked(x, dt, b, b, a_log, 8),
        "lru": lru_ref(la, bb),
    }
    with FakeTensorMode() as mode:
        f = lambda t: mode.from_tensor(t)
        fake = {
            "flash": fa_ops.flash_attention(f(q), f(kv), f(kv), True),
            "ssd": ssd_ops.ssd(f(x), f(dt), f(b), f(b), f(a_log), chunk=8),
            "lru": lru_ops.lru(f(la), f(bb)),
        }
    for name in plain:
        want = plain[name] if isinstance(plain[name], tuple) \
            else (plain[name],)
        got = fake[name] if isinstance(fake[name], tuple) else (fake[name],)
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in want], name


def test_reduced_cell_traces_in_seconds():
    t0 = time.perf_counter()
    counts, meta = dryrun.trace_cell(
        "smollm-360m", "train_4k", multi_pod=False, device="cpu",
        cfg_overrides=dict(num_layers=1))
    assert time.perf_counter() - t0 < 30
    assert meta["chips"] == 256 and counts.flops > 0
    assert counts.kernel_calls["repro_torch::flash_attention_fwd"] > 0


def test_entry_point_writes_cell_artifact(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k",
                 "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "dry-run OK: 1 cells" in out
    with open(tmp_path / "mamba2-2.7b__decode_32k__16x16.json") as f:
        d = json.load(f)
    assert analysis.is_cell_artifact(d)
    assert {"trace_s", "counts", "count_source", "memsys_bridge",
            "cache_bytes_per_chip"} <= set(d)
    assert not (tmp_path / analysis.DESIGN_SPACE_JSON).exists()


if __name__ == "__main__":
    # the table of port / reference ratios: dot FLOPs per chip, and the
    # read fraction of each (PERF.md); run as
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dryrun.py
    ref = _reference_cells()
    print("| Cell | FLOP ratio | Pinned | Read fraction, port | Reference |")
    print("|---|---|---|---|---|")
    for name, (arch, shape, mp, sp, pinned, _) in REF_CELLS.items():
        counts, _ = dryrun.trace_cell(
            arch, shape, multi_pod=mp, sequence_parallel=sp, device="cpu",
            cfg_overrides=dict(num_layers=LAYERS))
        r = ref[name]
        rf = counts.read_bytes / (counts.read_bytes + counts.write_bytes)
        want = r["read_bytes_per_chip"] / (r["read_bytes_per_chip"]
                                           + r["write_bytes_per_chip"])
        print(f"| {name} | {counts.flops / r['hlo_flops_per_chip']:.4f} | "
              f"{pinned or 'same work'} | {rf:.3f} | {want:.3f} |")
