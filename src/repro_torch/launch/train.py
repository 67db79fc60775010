"""Training launcher (port of ``repro.launch.train``).

``python -m repro_torch.launch.train --arch <id> [--reduced] [--mesh d,m]``

Runs the fault-tolerant loop (checkpoint/restart, heartbeats, straggler
monitor, deterministic data): on the card unless ``--device cpu`` is
given, at full width unless ``--reduced`` is given.  The flags are the
reference's.  ``--mesh data,model`` trains on a mesh of ``data x model``
ranks: the command spawns them on this host (or, started by ``torchrun``
with that world size, runs as one of them), rank 0 prints the lines the
one-device run prints, and the result returned is rank 0's.  Every rank
draws the whole initial state from ``--seed`` and keeps its blocks, so a
mesh starts from the one-device run's state.  The checkpoint directory
defaults to one under the temporary directory; an existing one is resumed
from, as the reference does.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple

import torch

#: the kernels whose launches the launcher reports per step
_KERNELS = ("flash_attention_fwd", "rglru_scan", "ssd_scan")


def _launch_counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {**fa_ops.launches, **lru_ops.launches, **ssd_ops.launches}


def parse_mesh(text: str, global_batch: int) -> Tuple[int, int]:
    """``--mesh data,model`` as two positive integers whose data axis
    divides the global batch; raises ``ValueError`` otherwise."""
    parts = text.split(",")
    if len(parts) != 2 or not all(p.strip().isdigit() and int(p) > 0
                                  for p in parts):
        raise ValueError(f"--mesh {text!r}: want data,model, two positive "
                         f"integers")
    data, model = (int(p) for p in parts)
    if global_batch % data:
        raise ValueError(f"--mesh {text}: the data axis ({data}) does not "
                         f"divide --global-batch {global_batch}")
    return data, model


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (demo)")
    ap.add_argument("--mesh", default=None,
                    help="data,model mesh shape, e.g. 2,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _args(argv)
    from repro_torch import device as device_mod
    dev = device_mod.resolve(args.device)
    if not args.mesh:
        return _train(args, dev)
    shape = parse_mesh(args.mesh, args.global_batch)
    world = shape[0] * shape[1]
    from repro_torch.launch import mesh as mesh_mod
    if "RANK" in os.environ and int(os.environ.get("WORLD_SIZE", 0)) == \
            world:                                 # started by torchrun
        mesh_mod.init_world(int(os.environ["RANK"]), world, None, dev.type)
        try:
            return _rank_train(args, shape, None)
        finally:
            torch.distributed.destroy_process_group()
    if dev.type == "cuda":
        # build the kernels once here, not in every rank at once
        from repro_torch import _build
        _build.build(["flash_attention", "rglru_scan", "ssd_scan"])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        mesh_mod.spawn(_rank_entry, world, (argv, shape, out),
                       device=dev.type)
        with open(out, "rb") as f:
            return pickle.load(f)


def _rank_entry(rank: int, world: int, argv, shape, out: str) -> None:
    _rank_train(_args(argv), shape, out)


def _rank_train(args, shape, out: Optional[str]) -> dict:
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import sharding
    mesh = mesh_mod.init_mesh(shape, ("data", "model"))
    ctx = sharding.from_mesh(mesh)
    res = _train(args, mesh.device, ctx)
    if out is not None and mesh.rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    return res


def _train(args, dev: torch.device, ctx=None) -> dict:
    from repro_torch.configs import get
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models import build, sharding
    from repro_torch.runtime import DriverConfig, StragglerMonitor, run
    from repro_torch.train import (
        AdamW, SyntheticLM, cosine_schedule, init_state, make_train_step,
    )
    from repro_torch.train import grad_compress
    from repro_torch.train.train_step import TrainState, state_specs

    lead = not sharding.active(ctx) or ctx.mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    say(f"arch={cfg.name} params={model.param_count():,} device={dev}")

    opt = AdamW(learning_rate=cosine_schedule(args.lr, warmup=10,
                                              total=args.steps))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    specs = None
    if sharding.active(ctx):
        model.check_mesh(ctx)
        params = model.shard_params(model.init(gen), ctx)
        state = TrainState(params, opt.init(params),
                           grad_compress.init_error_state(params)
                           if args.compress_grads else None)
        specs = state_specs(model, ctx, args.compress_grads)
        say(f"mesh={dict(ctx.mesh.shape)} ranks={ctx.mesh.size} "
            f"backend={ctx.mesh.backend} "
            f"transport={sharding.transport(ctx, dev)}")
    else:
        state = init_state(model, gen, opt, compress=args.compress_grads)
    step_fn = make_train_step(model, opt,
                              num_microbatches=args.microbatches,
                              compress=args.compress_grads, ctx=ctx)

    shape = ShapeSpec("cli", args.seq_len, args.global_batch, "train")
    src = SyntheticLM(cfg, shape)
    mon = StragglerMonitor()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    t_last = [time.perf_counter()]
    seen = [_launch_counts(), dict(sharding.traffic)]
    steps, losses, walls, launches, traffic = [], {}, [], [], []

    def on_step(step, metrics):
        loss = float(metrics["loss"])           # waits for the step
        now = time.perf_counter()
        mon.observe(step, now - t_last[0])
        walls.append(now - t_last[0])
        t_last[0] = now
        counts = _launch_counts()
        launches.append({k: counts[k] - seen[0][k] for k in _KERNELS})
        traffic.append({k: v - seen[1][k]
                        for k, v in sharding.traffic.items()})
        seen[:] = [counts, dict(sharding.traffic)]
        steps.append(step)
        losses.setdefault(step, []).append(loss)
        if step % 10 == 0 or step < 3:
            say(f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f}")

    dcfg = DriverConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        heartbeat_path=os.path.join(args.ckpt_dir, "heartbeat"),
        fail_at_steps=tuple(args.fail_at))
    os.makedirs(args.ckpt_dir, exist_ok=True)
    t0 = time.perf_counter()
    report = run(step_fn, state,
                 lambda s: src.place(src.batch_for_step(s), dev, ctx),
                 dcfg, on_step=on_step, ctx=ctx, specs=specs)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    if report.losses:
        say(f"done: steps={report.steps_run} restarts={report.restarts} "
            f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f} "
            f"straggler_events={len(mon.events)}")
    else:
        say(f"done: steps=0 (resumed at step {args.steps} from "
            f"{args.ckpt_dir}) restarts={report.restarts}")
    tokens = args.global_batch * args.seq_len
    med = sorted(walls)[len(walls) // 2] if walls else None
    if med is not None:
        say(f"step wall median {med * 1e3:.1f} ms "
            f"({tokens / med:.0f} tokens/s)"
            + (f", peak {peak:.2f} GiB" if peak is not None else ""))
    out = {"report": report, "steps": steps, "losses": losses,
           "step_s": walls, "launches": launches, "wall_s": wall,
           "median_step_s": med, "tokens_per_step": tokens,
           "peak_gib": peak}
    if sharding.active(ctx):
        out.update(mesh=dict(ctx.mesh.shape), backend=ctx.mesh.backend,
                   transport=sharding.transport(ctx, dev), traffic=traffic)
    return out


if __name__ == "__main__":
    main()
