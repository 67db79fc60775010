"""The benchmark measures the port alone: nothing a run loads is JAX or
the JAX package (``repro``), compared by whole top-level names, and the
references import nothing of the port."""
import ast
import json
import subprocess
import sys

from bench_port import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
                 if not p.name.startswith("test_"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_sources_import_no_jax():
    for path in SOURCES:
        assert not set(_imports(path)) & FORBIDDEN, path
        assert "benchmarks/" not in path.read_text(), path


def test_references_import_nothing_of_the_port():
    refs = sorted((spec.BENCH_DIR / "reference").glob("*.py"))
    assert {p.stem for p in refs} >= {"plain", "moe", "ssm"}
    for path in refs:
        roots = set(_imports(path))
        assert "repro_torch" not in roots, path
        assert roots <= {"__future__", "contextlib", "math", "torch",
                         "bench_port"}, (path, roots)


def test_loading_every_module_loads_no_jax():
    code = f"""
import importlib.util, json, sys
sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / 'src')!r}]
import bench_port.run, bench_port.calibrate, bench_port.session
from bench_port.reference import moe, plain, ssm
from bench_port import session, spec
import repro_torch.serve.engine, repro_torch.models.model
for p in sorted((spec.BENCH_DIR / "metrics").glob("*.py")):
    s = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr
    roots = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in roots and "bench_port" in roots
    assert not roots & FORBIDDEN, roots & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert run.forbidden_modules() == \
        sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
