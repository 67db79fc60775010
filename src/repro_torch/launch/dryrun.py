"""The dry run: each (arch x shape x mesh) cell's per-chip FLOPs, bytes and
collectives at the production mesh, with no weights and no devices beyond
one (port of :mod:`repro.launch.dryrun`).

    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k \
        [--multi-pod] [--sequence-parallel] [--device cpu]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

The reference lowers and compiles each cell for 256 (or 512) placeholder
devices and parses the HLO.  The port traces rank 0's program of the same
mesh in one process (:func:`trace_cell`): the mesh is a loopback mesh
(:func:`repro_torch.launch.mesh.loopback_mesh`) whose collectives give
their results' shapes, the parameters, optimizer state, batch and caches
are rank 0's blocks as fake tensors (shapes, no memory) on ``--device``
(default ``cuda``), and :class:`repro_torch.roofline.counts.Counter`
counts every operator.  The kernels' wrappers pass fake tensors to their
operators (counted by formula): nothing is launched and no scan is
unrolled.

A train cell counts one microbatch's forward, backward and gradient
accumulation and weights it by the number of microbatches (every
microbatch runs the same program on the same shapes, as the reference
weights its microbatch scan body by its trip count), then the
optimizer's update once.

Each cell writes ``{arch}__{shape}__{mesh}.json`` with the reference's
keys; in place of its compile-only ``lower_s``, ``compile_s``,
``cost_analysis``, ``memory_analysis`` and ``hlo_bytes`` it writes the
count source's ``trace_s``, ``counts`` and ``count_source``.  ``--all``
also writes ``design_space.json`` with the joint and serving frontiers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.configs import arch_ids, get
from repro_torch.configs.shapes import SHAPES, applicable, microbatches_for
from repro_torch.explorer import DEFAULT_OUT as RESULTS_DIR
from repro_torch.launch.mesh import loopback_mesh, make_production_mesh
from repro_torch.models import build, sharding
from repro_torch.models.model import device_bytes
from repro_torch.roofline import analysis
from repro_torch.roofline.counts import Counter, Counts

#: what the ``counts`` key of an artifact holds
COUNT_SOURCE = ("repro_torch.roofline.counts: fake-tensor trace of rank 0 "
                "of the production mesh (loopback collectives)")


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=False)


def _count(fn, inputs) -> Counts:
    counter = Counter(inputs=inputs)
    with counter:
        fn()
    return counter.result()


def _train_counts(model, params, batch, n_micro: int, ctx) -> Counts:
    """The train step of ``repro_torch.train.train_step.make_train_step``
    on rank 0's blocks: one microbatch's loss and gradients (with their
    f32 accumulation) weighted by ``n_micro``, then the average and the
    AdamW update once."""
    from repro_torch.train import AdamW, constant_schedule
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.train_step import value_and_grad
    opt = AdamW(learning_rate=constant_schedule(1e-4))
    state = opt.init(params)
    specs = model.param_specs(ctx)
    rows = next(iter(batch.values())).shape[0]
    mb = {k: v[:rows // n_micro] for k, v in batch.items()}
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    out = {}

    def micro():
        _, _, g = value_and_grad(model, params, mb, ctx)
        out["grads"] = g if n_micro == 1 else \
            tree_map(lambda a, gi: a + gi.float(), zeros, g)

    total = Counts()
    total.add(_count(micro, (params, state, batch, zeros)), n_micro)

    def update():
        grads = out["grads"]
        if n_micro > 1:
            grads = tree_map(lambda g: g / n_micro, grads)
        opt.update(grads, state, params, ctx, specs)

    total.add(_count(update, (params, state, out["grads"])))
    return total


def _cell(arch, shape_name, multi_pod, sequence_parallel, remat,
          cfg_overrides, device):
    cfg = get(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"skip {arch}/{shape_name}: {why}")
    prod = make_production_mesh(multi_pod=multi_pod)
    mesh = loopback_mesh(prod.devices_shape, prod.axis_names, 0, device)
    ctx = sharding.from_mesh(mesh, sequence_parallel=sequence_parallel)
    return build(cfg), shape, ctx


def cell_meta(arch: str, shape_name: str, *, multi_pod: bool,
              sequence_parallel: bool = False,
              num_microbatches: Optional[int] = None,
              remat: Optional[bool] = None,
              cfg_overrides: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """The reference dry run's meta fields of one cell, from the schema and
    the specs alone (no trace): ``params``, ``active_params``,
    ``model_flops``, ``chips``, ``mesh``, ``num_microbatches`` and
    ``state_bytes_per_chip`` (train), ``cache_bytes_per_chip`` (decode)."""
    model, shape, ctx = _cell(arch, shape_name, multi_pod, sequence_parallel,
                              remat, cfg_overrides, "cpu")
    cfg = model.cfg
    meta: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": ctx.mesh.size,
        "params": model.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if shape.kind == "train":
        meta["num_microbatches"] = (
            num_microbatches if num_microbatches is not None
            else microbatches_for(cfg, shape, ctx.dp_size()))
        # params, mu and nu (f32, the parameters' specs) and the
        # replicated int32 step
        meta["state_bytes_per_chip"] = 3 * device_bytes(
            model.abstract_params(), model.param_specs(ctx), ctx) + 4
        meta["model_flops"] = 6.0 * cfg.active_param_count() \
            * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        meta["model_flops"] = 2.0 * cfg.active_param_count() \
            * shape.global_batch * shape.seq_len
    else:
        meta["model_flops"] = 2.0 * cfg.active_param_count() \
            * shape.global_batch
        full = model.input_specs(shape)
        meta["cache_bytes_per_chip"] = device_bytes(
            full["caches"], model.input_shardings(shape, ctx, full)["caches"],
            ctx)
    return meta


def trace_cell(arch: str, shape_name: str, *, multi_pod: bool,
               sequence_parallel: bool = False,
               num_microbatches: Optional[int] = None,
               remat: Optional[bool] = None,
               cfg_overrides: Optional[Dict[str, Any]] = None,
               device=None) -> Tuple[Counts, Dict[str, Any]]:
    """Trace one (arch x shape x mesh) cell on ``device``: its per-chip
    counts and its meta fields (:func:`cell_meta`; the counterpart of the
    reference's ``lower_cell``)."""
    dev = device_mod.resolve(device)
    kw = dict(multi_pod=multi_pod, sequence_parallel=sequence_parallel,
              remat=remat, cfg_overrides=cfg_overrides)
    meta = cell_meta(arch, shape_name, num_microbatches=num_microbatches,
                     **kw)
    model, shape, ctx = _cell(arch, shape_name, multi_pod,
                              sequence_parallel, remat, cfg_overrides, dev)
    with _fake_mode():
        params = model.abstract_params(ctx, device=dev)
        inputs = model.local_inputs(shape, ctx, device=dev)
        if shape.kind == "train":
            counts = _train_counts(model, params, inputs,
                                   meta["num_microbatches"], ctx)
        elif shape.kind == "prefill":
            extra = {k: inputs[k] for k in ("patch_embeds", "frames")
                     if k in inputs}
            counts = _count(lambda: model.prefill(
                params, inputs["tokens"], ctx=ctx, **extra),
                (params, inputs))
        else:
            counts = _count(lambda: model.decode_step(
                params, inputs["tokens"], inputs["caches"],
                inputs["positions"], ctx), (params, inputs))
    return counts, meta


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: Optional[str] = None, verbose: bool = True,
             device=None, **kw) -> Dict[str, Any]:
    """Trace one cell, its roofline and its memory-system bridge (on
    ``device``); writes the artifact into ``out_dir`` where given."""
    dev = device_mod.resolve(device)
    t0 = time.perf_counter()
    counts, meta = trace_cell(arch, shape_name, multi_pod=multi_pod,
                              device=dev, **kw)
    t_trace = time.perf_counter() - t0
    report = analysis.analyze(
        arch, shape_name, meta["mesh"], meta["chips"],
        dataclasses.asdict(counts), meta["model_flops"],
        peak_memory_bytes=counts.peak_live_bytes,
        notes="peak_memory_bytes: high-water mark of live fake-tensor "
              "bytes over the trace")
    bridge = analysis.memsys_bridge(report, device=dev)
    result = {
        **meta,
        "trace_s": t_trace,
        "count_source": COUNT_SOURCE,
        "counts": counts.to_json(),
        "roofline": report.to_json(),
        "memsys_bridge": bridge,
    }
    if verbose:
        r = report
        print(f"== {arch} × {shape_name} × {meta['mesh']} "
              f"({meta['chips']} chips) ==")
        print(f"   trace {t_trace:.1f}s  ({counts.ops} operators, peak "
              f"live {counts.peak_live_bytes:.3e} B)")
        print(f"   counts: flops={counts.flops:.3e} "
              f"read={counts.read_bytes:.3e} write={counts.write_bytes:.3e}"
              f" collective={counts.collective_bytes:.3e}")
        print(f"   roofline: compute={r.compute_s*1e3:.2f}ms "
              f"memory={r.memory_s*1e3:.2f}ms "
              f"collective={r.collective_s*1e3:.2f}ms "
              f"-> dominant={r.dominant} "
              f"useful_flops={r.useful_flops_ratio:.2f} mix={bridge['mix']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{meta['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def design_space(results, *, with_frontiers: bool, device=None
                 ) -> Dict[str, Any]:
    """One batched ``[configs x catalog x mix-grid x shoreline]``
    evaluation over the cells' reports; ``with_frontiers``: the joint and
    serving-trace frontiers ride along.  The joint frontier runs the
    adaptive flit engine (the run and periodic kernels on the card), as
    the explorer's bridge does; the reference's dry run takes its fixed
    engine, whose winners the adaptive one keeps (the golden)."""
    dev = device_mod.resolve(device)
    reports = {
        f"{r['arch']}__{r['shape']}__{r['mesh']}":
            analysis.RooflineReport(**r["roofline"])
        for r in results}
    ds = analysis.bridge_design_space(reports, device=dev)
    if with_frontiers:
        from repro_torch.core.space import (ADAPTIVE_SIM, DesignSpace,
                                            joint_frontier)
        ds["joint_frontier"] = joint_frontier(sim=ADAPTIVE_SIM, device=dev)
        ds["serving_frontier"] = DesignSpace.serving_frontier(device=dev)
    return ds


def cells(all_cells: bool, arch: Optional[str], shape: Optional[str],
          say=print):
    if not all_cells:
        if not (arch and shape):
            raise SystemExit("--arch/--shape or --all")
        return [(arch, shape)]
    out = []
    for a in arch_ids():
        cfg = get(a)
        for name, spec in SHAPES.items():
            ok, why = applicable(cfg, spec)
            if ok:
                out.append((a, name))
            else:
                say(f"SKIP {a} × {name}: {why}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch × shape) cell")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--sequence-parallel", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors and the bridge "
                         "(default cuda)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    todo = cells(args.all, args.arch, args.shape)
    t0 = time.perf_counter()
    failures, results = [], []
    for arch, shape_name in todo:
        try:
            results.append(run_cell(
                arch, shape_name, multi_pod=args.multi_pod,
                out_dir=args.out, device=dev,
                num_microbatches=args.microbatches,
                sequence_parallel=args.sequence_parallel,
                remat=False if args.no_remat else None))
        except Exception:
            traceback.print_exc()
            failures.append((arch, shape_name))
    if results:
        ds = design_space(results, with_frontiers=args.all, device=dev)
        if args.all:
            # only full sweeps persist the aggregate: a later single-cell
            # refresh must not clobber the all-cells space
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, analysis.DESIGN_SPACE_JSON),
                      "w") as f:
                json.dump(ds, f, indent=1)
        for name, w in ds["workloads"].items():
            print(f"frontier {name}: best={w['best']} ({w['mix']}) "
                  f"shoreline_sensitive={w['shoreline_sensitive']}")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print(f"dry-run OK: {len(todo)} cells in "
          f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
