"""Where serving's time goes on the card: one prefill per prompt length and
a few decode ticks of a model at full width, timed on the host clock and
traced with ``torch.profiler``, with the device's kernel time split by
kind.

``python -m repro_torch.launch.profile_serve --arch recurrentgemma-2b``

``python -m repro_torch.launch.profile_serve --arch mamba2-2.7b
--prompt-lens 10,2048``

Every registered model at full width; an encoder-decoder model's prefill
takes as many frames as prompt tokens (random, from ``SEED``).

Kinds: ``flash_attention_fwd``, ``rglru_scan`` and ``ssd_scan`` (this
repo's kernels), ``matmul`` (cuBLAS), ``cast/copy`` (PyTorch's copy
kernels: the f32 -> bf16 casts of the weights at every call, the K/V
layout copies and the cache splices) and ``other`` (elementwise,
reductions, softmax, indexing).  Each phase reports two walls: one
without the profiler (the phase's own cost; the profiler slows the host)
and one of the profiled run itself; ``idle`` is the share of the
profiled run's wall in which no kernel ran, so kernel time and wall come
from the same run (the idle share without the profiler is lower).  A fixed batch of ``SLOTS`` slots
and ``TICKS`` decode ticks, weights and prompts drawn from ``SEED``.
Needs the card: device times are not measured on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

KINDS = ("flash_attention_fwd", "rglru_scan", "ssd_scan", "matmul",
         "cast/copy", "other")
SLOTS = 4
TICKS = 4
SEED = 0


def kind_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if "rglru_scan_kernel" in name:
        return "rglru_scan"
    if "ssd_scan_" in name:               # every stage of the SSD scan
        return "ssd_scan"
    if any(s in name for s in ("gemm", "xmma", "nvjet", "cutlass",
                               "cublas")):
        return "matmul"
    if "copy_kernel" in name or name.startswith("memcpy"):
        return "cast/copy"
    return "other"


def device_ms(prof) -> Dict[str, float]:
    """Summed kernel time (ms) of a finished profile, by kernel name (a
    ``record_function`` range's span on the device timeline is no
    kernel, and is left out)."""
    out: Dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(evt, "is_user_annotation", False):
            out[evt.name] = out.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    return out


def _timed(fn, dev) -> float:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def _phase(name, fn, dev) -> dict:
    """Host wall (ms) of ``fn`` without the profiler, then a profiled
    repeat: its wall, its kernel time by kind and its idle share."""
    wall = _timed(fn, dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = _timed(fn, dev)
    by_name = device_ms(prof)
    kinds = {k: 0.0 for k in KINDS}
    for kname, ms in by_name.items():
        kinds[kind_of(kname)] += ms
    busy = sum(kinds.values())
    if busy <= 0.0:
        raise RuntimeError(f"{name}: the profile holds no device kernel "
                           f"time (the profiler does not trace the card "
                           f"here)")
    rec = dict(wall_ms=wall, profiled_wall_ms=prof_wall, device_ms=busy,
               idle=1.0 - busy / prof_wall, kinds=kinds)
    parts = ", ".join(f"{k} {v:.2f}" for k, v in kinds.items())
    print(f"{name}: wall {wall:.2f} ms; profiled run: wall {prof_wall:.2f} "
          f"ms, kernels {busy:.2f} ms (idle {100 * rec['idle']:.1f}%): "
          f"{parts}", flush=True)
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {ms:8.3f} ms  {kname[:110]}", flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt-lens", default="10,2300",
                    help="comma-separated prompt lengths to prefill")
    args = ap.parse_args(argv)

    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.models import build

    dev = device_mod.resolve("cuda")
    cfg = get(args.arch)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    lens = [int(n) for n in args.prompt_lens.split(",")]
    max_len = max([cfg.window] + [n + TICKS + 1 for n in lens])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"profiling {cfg.name}: params={model.param_count():,} "
          f"prompts {lens} slots={SLOTS} max_len={max_len}", flush=True)
    out = {}
    for n in lens:
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device=dev)
        extra = {"frames": torch.randn((1, n, cfg.d_model), generator=gen,
                                       device=dev)} if cfg.is_encdec else {}
        prefill = lambda: model.prefill(params, toks, pad_cache_to=max_len,
                                        **extra)
        prefill()                                          # warm up
        out[f"prefill {n}"] = _phase(f"prefill of {n} tokens", prefill, dev)

    caches = model.init_decode_caches(SLOTS, max_len, dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SLOTS, 1), max(lens), dtype=torch.long, device=dev)

    def ticks():
        for _ in range(TICKS):
            model.decode_step(params, tok, caches, pos)
    ticks()                                                # warm up
    rec = _phase(f"{TICKS} decode ticks of {SLOTS} slots", ticks, dev)
    rec["per_tick_ms"] = rec["wall_ms"] / TICKS
    out["decode"] = rec
    return out


if __name__ == "__main__":
    main()
