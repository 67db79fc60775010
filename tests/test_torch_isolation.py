"""The PyTorch port stands alone: no module under ``src/repro_torch``
imports JAX or the JAX package, importing the port pulls in no JAX, and
its entry points refuse to fall back to the CPU on a machine with no
card."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in PORT_FILES}
    for want in ("core/ucie.py", "core/flitsim.py", "core/space.py",
                 "kernels/flit_sim/ref.py", "kernels/flit_sim/ops.py",
                 "kernels/flit_pack/ref.py", "kernels/flit_pack/ops.py",
                 "kernels/flit_pack/kernel.py", "quickstart.py",
                 "explorer.py", "convert.py", "_build.py",
                 "configs/base.py", "configs/registry.py",
                 "configs/recurrentgemma_2b.py", "configs/smollm_360m.py",
                 "models/schema.py", "models/layers.py",
                 "models/attention.py", "models/rglru.py",
                 "models/transformer.py", "models/model.py",
                 "kernels/flash_attention/ref.py",
                 "kernels/flash_attention/kernel.py",
                 "kernels/flash_attention/ops.py",
                 "kernels/rglru_scan/ref.py", "kernels/rglru_scan/kernel.py",
                 "kernels/rglru_scan/ops.py", "serve/engine.py",
                 "launch/serve.py", "launch/profile_serve.py",
                 "configs/mamba2_2_7b.py", "models/ssm.py",
                 "kernels/ssd_scan/ref.py", "kernels/ssd_scan/kernel.py",
                 "kernels/ssd_scan/ops.py", "traces/trace.py",
                 "traces/frontier.py", "traces/recorder.py",
                 "core/streaming.py", "models/moe.py", "models/encdec.py",
                 "configs/shapes.py", "train/optimizer.py",
                 "train/grad_compress.py", "train/data.py",
                 "train/train_step.py", "checkpoint/ckpt.py",
                 "runtime/fault.py", "runtime/straggler.py",
                 "launch/train.py"):
        assert want in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_no_jax_or_reference_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def _entry_points():
    from repro_torch import convert, explorer, quickstart
    from repro_torch.core import flitsim, report, selector, space, traffic
    from repro_torch.configs import get
    from repro_torch.kernels.flit_pack import ops as pack_ops
    from repro_torch.launch import profile_serve, serve, train
    from repro_torch.models import build
    from repro_torch.roofline import analysis
    from repro_torch.serve import ServingEngine
    small = build(get("smollm-360m").reduced())
    return {
        "simulate_grid": lambda: flitsim.simulate_grid(
            ["chi"], [1.0], [1.0], [4.0]),
        "sweep": lambda: flitsim._sweep_impl(),
        "DesignSpace": lambda: space.DesignSpace(
            [space.axis("read_fraction", [0.5])]),
        "joint_frontier": lambda: space.joint_frontier(n_fracs=3),
        "build_report": lambda: report.build_report(),
        "bridge_design_space": lambda: analysis.bridge_design_space(
            explorer.representative_reports()),
        "bridge_mode": lambda: explorer.bridge_mode(verbose=False),
        "explorer_cli": lambda: explorer.main(["--bridge"]),
        "explorer_cli_serving": lambda: explorer.main(["--serving"]),
        "serving_frontier": lambda: space.DesignSpace.serving_frontier(),
        "simulate_trace_grid": lambda: flitsim.simulate_trace_grid(
            ["chi"], [[1.0]], [[1.0]], [[4.0]]),
        "sweep_perturbed": lambda: flitsim.sweep_perturbed([{}]),
        "stream_evaluate": lambda: space.DesignSpace(
            [space.axis("read_fraction", [0.5])]).evaluate(
                metrics=("bandwidth_gbs",), stream=space.StreamConfig()),
        "mix_grid": lambda: traffic.mix_grid(5),
        "rank": lambda: selector.rank(traffic.TrafficMix(2, 1)),
        "best": lambda: selector.best(traffic.TrafficMix(2, 1)),
        "sweep_mode": lambda: explorer.sweep_mode(verbose=False),
        "explorer_cli_sweep": lambda: explorer.main(["--sweep"]),
        "quickstart": lambda: quickstart.collect(),
        "quickstart_cli": lambda: quickstart.main([]),
        "simulate_lpddr6_pipelining":
            lambda: flitsim.simulate_lpddr6_pipelining(4),
        "sweep_pipelining": lambda: flitsim._sweep_pipelining_impl((1, 4)),
        "simulators": lambda: flitsim.SIMULATORS["chi"](2, 1),
        "pack": lambda: pack_ops.pack(*[
            convert.byte_rows(np.zeros(shape, np.int32))
            for shape in ((15, 64), (4, 10), (4, 4))]),
        "model_params": lambda: convert.model_params(
            small.cfg, {"blocks": {}}),
        "serving_engine": lambda: ServingEngine(small, {}, max_len=32),
        "serve_cli": lambda: serve.main(["--arch", "smollm-360m",
                                         "--reduced"]),
        "serve_cli_ssm": lambda: serve.main(["--arch", "mamba2-2.7b",
                                             "--reduced"]),
        "profile_serve": lambda: profile_serve.main(["--arch",
                                                     "smollm-360m"]),
        "train_cli": lambda: train.main(["--arch", "smollm-360m",
                                         "--reduced", "--steps", "1"]),
        "train_state": lambda: convert.train_state(
            small.cfg, {".params": {"blocks": {}}, ".opt": {
                ".step": 0, ".mu": {"blocks": {}}, ".nu": {"blocks": {}}}}),
    }


@pytest.mark.parametrize("name", sorted([
    "simulate_grid", "sweep", "DesignSpace", "joint_frontier",
    "build_report", "bridge_design_space", "bridge_mode", "explorer_cli",
    "explorer_cli_serving", "serving_frontier", "simulate_trace_grid",
    "sweep_perturbed", "stream_evaluate",
    "mix_grid", "rank", "best", "sweep_mode", "explorer_cli_sweep",
    "quickstart", "quickstart_cli", "simulate_lpddr6_pipelining",
    "sweep_pipelining", "simulators", "pack", "model_params",
    "serving_engine", "serve_cli", "serve_cli_ssm", "profile_serve",
    "train_cli", "train_state"]))
def test_entry_points_need_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_ops_route_cpu_to_plain_and_reject_other_devices():
    from repro_torch.kernels.flit_sim import ops, ref
    ops.reset_launches()
    params = torch.zeros((ref.ASYM_ROWS, 4))
    params[0:6] = torch.tensor([74.0, 36, 24, 10, 96, 576])[:, None]
    params[6], params[7] = 2.0, 1.0
    out = ops.asymmetric_periodic(params, n_accesses=4096)
    assert out.shape == (ref.ASYM_ROWS, 4)
    assert ops.launches == {k: 0 for k in ops.launches}
    with pytest.raises(ValueError, match="no kernel"):
        ops.asymmetric_periodic(params.to("meta"), n_accesses=4096)


def test_build_without_nvcc_raises():
    from repro_torch import _build
    if any(pathlib.Path(h, "bin", "nvcc").is_file()
           for h in (os.environ.get("CUDA_HOME") or "/nonexistent",
                     "/usr/local/cuda")):
        pytest.skip("nvcc is installed here")
    import shutil
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_nvcc_flags_keep_exact_f32():
    from repro_torch import _build
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "sm_90a" in flags


def test_cuda_source_constants_match_ref():
    """The CUDA source repeats ref.py's layout constants."""
    from repro_torch.kernels.flit_sim import ref
    src = (PORT / "csrc" / "flit_sim.cu").read_text()
    for name in ("SYM_ROWS", "ASYM_ROWS", "SYM_PERIODIC_ROWS",
                 "PERIOD_MAX", "PIPE_ROWS", "PIPE_MAX_K"):
        assert f"constexpr int {name} = {getattr(ref, name)};" in src
    eps = src.split("constexpr float PERIOD_EPS = ")[1].split("f;")[0]
    assert np.float32(float(eps)) == np.float32(ref.PERIOD_EPS)
    assert np.isclose(ref.DRIFT_SPAN, 3.0) and "(1.0f / 3.0f)" in src
    # the adaptive schedule the run kernels repeat
    from repro_torch.core import flitsim
    assert f"constexpr int DRIFT_SPAN = {int(ref.DRIFT_SPAN)};" in src
    assert f"constexpr int MIN_EXIT_CHUNKS = {flitsim._MIN_EXIT_CHUNKS};" \
        in src
    tol = src.split("constexpr float DRIFT_TOL_SLOTS = ")[1].split("f;")[0]
    assert float(tol) == flitsim._DRIFT_TOL_SLOTS


def test_flit_pack_source_constants_match_ref():
    """The packer's CUDA source repeats ref.py's flit layout."""
    from repro_torch.kernels.flit_pack import ref
    src = (PORT / "csrc" / "flit_pack.cu").read_text()
    for name in ("FLIT_BYTES", "DATA_BYTES", "HS_BYTES", "META_BYTES",
                 "LINE_BYTES"):
        assert f"constexpr int {name} = {getattr(ref, name)};" in src
    assert ref.BODY_BYTES == ref.FLIT_BYTES - 2
    assert "constexpr int BODY_BYTES = DATA_BYTES + HS_BYTES + " \
        "META_BYTES;" in src


def test_flash_attention_source_constants_match_ref():
    """The attention kernel's CUDA source repeats ref.py's mask value and
    head-dim limit."""
    from repro_torch.kernels.flash_attention import ref
    src = (PORT / "csrc" / "flash_attention.cu").read_text()
    assert f"constexpr int MAX_HEAD_DIM = {ref.MAX_HEAD_DIM};" in src
    neg = src.split("constexpr float NEG_INF = ")[1].split("f;")[0]
    assert float(neg) == ref.NEG_INF
    assert "fmaxf(l[p], 1e-30f)" in src


def test_decode_attention_source_constants_match_ref():
    """The decode-attention kernel's CUDA source repeats ref.py's limits
    on the head dim and the group."""
    from repro_torch.kernels.decode_attention import ref
    src = (PORT / "csrc" / "decode_attention.cu").read_text()
    assert "constexpr int VEC = 8;" in src
    assert ref.HEAD_DIMS == tuple(2 ** i for i in range(3, 9))
    assert f"constexpr int MAX_HEAD_DIM = {ref.HEAD_DIMS[-1]};" in src
    assert f"constexpr int MAX_GROUP = {ref.MAX_GROUP};" in src


def test_build_lists_every_source():
    from repro_torch import _build
    assert _build.SOURCES == {"flit_sim": "csrc/flit_sim.cu",
                              "flit_pack": "csrc/flit_pack.cu",
                              "flash_attention": "csrc/flash_attention.cu",
                              "rglru_scan": "csrc/rglru_scan.cu",
                              "ssd_scan": "csrc/ssd_scan.cu",
                              "decode_attention":
                                  "csrc/decode_attention.cu"}
    for rel in _build.SOURCES.values():
        assert (PORT / rel).is_file()
