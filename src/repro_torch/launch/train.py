"""Training launcher (port of ``repro.launch.train``).

``python -m repro_torch.launch.train --arch <id> [--reduced] ...``

Runs the fault-tolerant loop (checkpoint/restart, heartbeats, straggler
monitor, deterministic data) on one device: the card unless ``--device
cpu`` is given, at full width unless ``--reduced`` is given.  The flags
are the reference's; ``--mesh`` is refused: a data,model mesh waits for
the port's multi-card slice (``models/sharding.py``, ``launch/mesh.py``).
The checkpoint directory defaults to one under the temporary directory;
an existing one is resumed from, as the reference does.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

#: the kernels whose launches the launcher reports per step
_KERNELS = ("flash_attention_fwd", "rglru_scan", "ssd_scan")


def _launch_counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {**fa_ops.launches, **lru_ops.launches, **ssd_ops.launches}


def main(argv: Optional[Sequence[str]] = None) -> dict:
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
                    help="data,model mesh shape (not in the port yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise ValueError(
            f"--mesh {args.mesh}: the port trains on one device; a "
            f"data,model mesh waits for its multi-card slice (the port of "
            f"models/sharding.py and launch/mesh.py)")

    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models import build
    from repro_torch.runtime import DriverConfig, StragglerMonitor, run
    from repro_torch.train import (
        AdamW, SyntheticLM, cosine_schedule, init_state, make_train_step,
    )

    dev = device_mod.resolve(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    print(f"arch={cfg.name} params={model.param_count():,} device={dev}")

    opt = AdamW(learning_rate=cosine_schedule(args.lr, warmup=10,
                                              total=args.steps))
    state = init_state(model, torch.Generator(device=dev).manual_seed(
        args.seed), opt, compress=args.compress_grads)
    step_fn = make_train_step(model, opt,
                              num_microbatches=args.microbatches,
                              compress=args.compress_grads)

    shape = ShapeSpec("cli", args.seq_len, args.global_batch, "train")
    src = SyntheticLM(cfg, shape)
    mon = StragglerMonitor()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    t_last = [time.perf_counter()]
    seen = [_launch_counts()]
    steps, losses, walls, launches = [], {}, [], []

    def on_step(step, metrics):
        loss = float(metrics["loss"])           # waits for the step
        now = time.perf_counter()
        mon.observe(step, now - t_last[0])
        walls.append(now - t_last[0])
        t_last[0] = now
        counts = _launch_counts()
        launches.append({k: counts[k] - seen[0][k] for k in _KERNELS})
        seen[0] = counts
        steps.append(step)
        losses.setdefault(step, []).append(loss)
        if step % 10 == 0 or step < 3:
            print(f"step {step:5d} loss {loss:.4f} "
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
                 lambda s: src.place(src.batch_for_step(s), dev),
                 dcfg, on_step=on_step)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    if report.losses:
        print(f"done: steps={report.steps_run} restarts={report.restarts} "
              f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f} "
              f"straggler_events={len(mon.events)}")
    else:
        print(f"done: steps=0 (resumed at step {args.steps} from "
              f"{args.ckpt_dir}) restarts={report.restarts}")
    tokens = args.global_batch * args.seq_len
    med = sorted(walls)[len(walls) // 2] if walls else None
    if med is not None:
        print(f"step wall median {med * 1e3:.1f} ms "
              f"({tokens / med:.0f} tokens/s)"
              + (f", peak {peak:.2f} GiB" if peak is not None else ""))
    return {"report": report, "steps": steps, "losses": losses,
            "step_s": walls, "launches": launches, "wall_s": wall,
            "median_step_s": med, "tokens_per_step": tokens,
            "peak_gib": peak}


if __name__ == "__main__":
    main()
