"""Build and load the port's CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the repository root (listed in ``.gitignore``).
The library name carries a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused.  Libraries are loaded
with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "repro_torch"

#: library name -> CUDA source (relative to the package)
SOURCES: Dict[str, str] = {"flit_sim": "csrc/flit_sim.cu",
                            "flit_pack": "csrc/flit_pack.cu",
                            "flash_attention": "csrc/flash_attention.cu",
                            "rglru_scan": "csrc/rglru_scan.cu",
                            "ssd_scan": "csrc/ssd_scan.cu",
                            "decode_attention": "csrc/decode_attention.cu"}

#: exact f32 semantics: no FMA contraction, IEEE division (no fast math)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, local memory, spills) of the last build
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (PACKAGE_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the wall
    seconds of each compile (0.0 for a library already built)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(PACKAGE_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LOADED[name] = lib
    return lib
