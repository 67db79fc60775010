"""Probe builds of the RG-LRU scan kernel (``csrc/rglru_scan.cu``): the
A/B of its block width and ring depth, and what holds it on the card.

``python -m repro_torch.launch.probe_rglru``

Each variant is the kernel's source with some text replaced: another block
width (8 or 32 channels) or ring depth (3 or 6 stages); no stores; no
recurrence, the loads alone; no exp; each step's operands read as the step
runs instead of 16 steps ahead; an independent add in place of the
recurrence; streaming stores; one or four exp warps.  Each is compiled
with the library's own flags into ``build/repro_torch/probe/`` and timed
back to back (20 calls / 20, three rounds, in turns) beside the unchanged
kernel at [1, 2304, 2560] and [4, 4096, 2560]; the width and depth
variants, which compute the same function, are held bitwise against the
unchanged kernel.  A variant whose text is no longer in the source is
reported and left out.  Then the host's side of the serving launcher's
call ([1, 7, 2560]): microseconds a call through ``ops.lru``, the binding,
``torch.empty_like`` and the plan, enqueued without a synchronise.  Needs
the card.
"""
from __future__ import annotations

import ctypes
import subprocess
import time
from typing import Dict, Tuple

import torch

from repro_torch import _build
from repro_torch.kernels.rglru_scan import kernel as k
from repro_torch.kernels.rglru_scan import ops

SOURCE = _build.PACKAGE_DIR / _build.SOURCES["rglru_scan"]
_W = "constexpr int W = 16;"
_ST = "constexpr int STAGES = 4;"
_STORE = "          if (live) y[(long)(g + u) * ch] = hv;"
_CHAIN = "          hv = __fadd_rn(__fmul_rn(av[u], hv), xv[u]);"
_EXP = "a[i] = expf(la[i]);"
_WARPS = "constexpr int EXP_WARPS = 2;"
#: name -> the (text of the source, its replacement) pairs of the variant
VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "width 8": ((_W, "constexpr int W = 8;"),),
    "width 32": ((_W, "constexpr int W = 32;"),),
    "3 stages": ((_ST, "constexpr int STAGES = 3;"),),
    "6 stages": ((_ST, "constexpr int STAGES = 6;"),),
    "width 32, 3 stages": ((_W, "constexpr int W = 32;"),
                           (_ST, "constexpr int STAGES = 3;")),
    "no stores": ((_STORE, ""),),
    "no recurrence": (("    const int steps = min(T, seq - k * T);",
                       "    if (live && k == ntiles - 1) y[0] = a[0] + x[0];"
                       "\n    const int steps = 0;"),),
    "no exp": ((_EXP, "a[i] = la[i];"),),
    "operands read as each step runs": (("    if (steps == T) {",
                                         "    if (false) {"),),
    "independent add": ((_CHAIN,
                         "          hv = __fadd_rn(av[u], xv[u]);"),),
    "streaming stores": ((_STORE, "          if (live) __stcs(y + (long)(g"
                                  " + u) * ch, hv);"),),
    "one exp warp": ((_WARPS, "constexpr int EXP_WARPS = 1;"),),
    "four exp warps": ((_WARPS, "constexpr int EXP_WARPS = 4;"),),
}
#: the variants that compute the kernel's function, held bitwise
SAME_FUNCTION = ("width 8", "width 32", "3 stages", "6 stages",
                 "width 32, 3 stages")
SHAPES = ((1, 2304, 2560), (4, 4096, 2560))


def variant_sources() -> Dict[str, str]:
    """The unchanged source and each variant's; a variant whose text is no
    longer in the source is reported and left out."""
    src = SOURCE.read_text()
    out = {"unchanged": src}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                print(f"probe {name!r} left out: {old!r} is not in "
                      f"{SOURCE.name} once")
                break
            text = text.replace(old, new)
        else:
            out[name] = text
    return out


def _build_all(sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.rglru_scan.argtypes = ([ctypes.c_void_p] * 3
                                   + [ctypes.c_long] * 3
                                   + [ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
    return libs


def _per_call_us(fn, n: int = 5000) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_rglru: needs a CUDA card")
    dev = torch.device("cuda")
    libs = _build_all(variant_sources())
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    for shape in SHAPES:
        log_a = -torch.rand(shape, device=dev) * 2.0
        b = torch.randn(shape, device=dev)
        out = torch.empty_like(b)
        tma = int(k.plan(shape, (log_a.data_ptr(), b.data_ptr())).route
                  == "tma")

        def call(lib):
            err = lib.rglru_scan(log_a.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), *shape, tma, stream)
            if err != 0:
                raise RuntimeError(f"probe launch failed: CUDA error {err}")

        call(libs["unchanged"])
        want = out.clone()
        for name in SAME_FUNCTION:
            if name in libs:
                call(libs[name])
                if not torch.equal(out, want):
                    raise AssertionError(f"probe {name!r} differs from the "
                                         f"kernel at {list(shape)}")
        times: Dict[str, list] = {}
        for _ in range(3):
            for name, lib in libs.items():
                call(lib)
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(20):
                    call(lib)
                e1.record()
                e1.synchronize()
                times.setdefault(name, []).append(
                    round(e0.elapsed_time(e1) / 20, 4))
        print(f"{list(shape)} ms a call back to back, three rounds:")
        for name, ts in times.items():
            print(f"  {name}: {ts}")
    a = torch.randn((1, 7, 2560), device=dev)
    b = torch.randn((1, 7, 2560), device=dev)
    ptrs = (a.data_ptr(), b.data_ptr())
    host = {"ops.lru": lambda: ops.lru(a, b),
            "binding": lambda: k.rglru_scan(a, b),
            "torch.empty_like": lambda: torch.empty_like(b),
            "plan": lambda: k.plan(b.shape, ptrs)}
    print("[1, 7, 2560] host µs a call: " + ", ".join(
        f"{name} {_per_call_us(fn):.2f}" for name, fn in host.items()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(f"card: {card.stdout.strip().splitlines()[0]}")


if __name__ == "__main__":
    main()
