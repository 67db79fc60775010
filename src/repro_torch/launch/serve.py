"""Serving launcher: batched continuous-batching engine on a model (port of
``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch smollm-360m --reduced --requests 16``

Runs on the card unless ``--device cpu`` is given, at full width unless
``--reduced`` is given.  Every decoder-only family is served; an
encoder-decoder model (seamless-m4t-large-v2) is refused, as its prefill
needs frames that token requests do not carry.  Models with local
attention need ``--max-len`` at least their window (2048 for
recurrentgemma-2b); the default 128 is the reference's.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.models import build
    from repro_torch.serve import Request, ServingEngine
    from repro_torch.serve.engine import check_servable

    dev = device_mod.resolve(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    check_servable(cfg, args.max_len)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    print(f"serving {cfg.name}: params={model.param_count():,} "
          f"slots={args.batch_slots}")

    eng = ServingEngine(model, params, batch_slots=args.batch_slots,
                        max_len=args.max_len, device=dev)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, cfg.vocab_size,
                                               plen).astype(np.int32),
                           max_new_tokens=args.max_new_tokens))
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in done)
    for r in done[: min(4, len(done))]:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} "
              f"generated={r.generated[:8]}...")
    print(f"done: {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    return {"requests": done, "tokens": total, "seconds": dt}


if __name__ == "__main__":
    main()
