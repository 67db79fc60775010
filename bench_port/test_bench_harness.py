"""The harness end to end on the CPU at the reduced sizes: a whole run
(set-up, window, metrics, the check against the reference) gives a
well-formed result.  The card's look is skipped (``device="cpu"``)."""
import json
import subprocess
import sys

import pytest

from bench_port import session, spec
from bench_port.conftest import reduced

SEED = 2 ** 31 + 11


def _well_formed(out, cell, trace):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    json.loads(json.dumps(out))
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = {m["name"]: m["unit"] for m in cell.metrics(trace)}
    for name, m in out["metrics"].items():
        assert m["unit"] == want[name] and m["value"] == m["value"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", ["olmoe-1b-7b.code_long_prompt",
                                  "olmoe-1b-7b.chat_decode"])
def test_untraced_run(name):
    cell = reduced(name)
    out = session.execute(cell, SEED, 3.0, False, device="cpu")
    _well_formed(out, cell, False)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert out["metrics"]["output_tok_s"]["value"] > 0


def test_traced_run():
    cell = reduced("mamba2-2.7b.code_long_prompt", trace_slice_s=1.0)
    out = session.execute(cell, SEED, 3.0, True, device="cpu")
    _well_formed(out, cell, True)
    m = out["metrics"]
    # no device on the CPU: the trace's readers find nothing to read
    for name in ("decode_batch_mean", "prefill_tok_s", "decode_tick_ms",
                 "mfu"):
        assert m[name]["value"] > 0
    for name in ("ssd_scan_roofline", "cast_share", "idle_share"):
        assert name not in m
    assert 0 < m["mfu"]["value"] < 100
    assert m["decode_batch_mean"]["value"] <= cell.batch_slots
    assert 0.5 <= out["device"]["window_s"] <= 3.5
    assert out["breakdown"]["device_ops"] == []


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         "olmoe-1b-7b.code_long_prompt", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True,
        cwd=spec.ROOT, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
