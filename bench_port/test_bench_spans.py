"""The readers of the port's spans and counters on a hand-made run: a
profiled slice with known device operations (so known idle gaps) and a
snapshot of known spans, marks and counters, each reader's exact figure;
the idle split adding up to ``idle_share``; ``None`` with no slice, no
span in it, or a port without the span module; and a traced run at the
reduced sizes reporting them."""
import sys

import pytest

from bench_port import devtrace, session, spanview
from bench_port.conftest import reduced
from bench_port.loop import Track, Window
from repro_torch import runtime
from repro_torch.runtime import spans

SEED = 2 ** 31 + 29
NEW = ("idle_in_model_share", "idle_in_engine_share", "decode_dispatch_ms",
       "decode_syncs_per_tick", "queue_wait_p50_ms", "moe_drop_share",
       "weight_cast_mb_tok", "kv_copy_mb_tok")

#: device operations of the slice [10, 20] s: idle [11, 12], [12.5, 15],
#: [16, 18], [19, 20], 6.5 s
OPS = [("k", 10.0, 11.0), ("k", 12.0, 12.5), ("k", 15.0, 16.0),
       ("k", 18.0, 19.0)]

#: (name, t0, t1, parent, rid, n), times in s; the first and the last two
#: lie outside the slice or across its end
RECORDS = [
    ("engine.submit", 9.0, 9.0, -1, 0, None),                    # 0
    ("engine.submit", 10.2, 10.2, -1, 1, None),                  # 1
    ("engine.submit", 10.4, 10.4, -1, 2, None),                  # 2
    ("engine.step", 10.5, 14.0, -1, None, None),                 # 3
    ("engine.admit", 10.6, 11.0, 3, 0, None),                    # 4
    ("engine.admit", 11.1, 13.0, 3, 1, None),                    # 5
    ("model.prefill", 11.2, 13.0, 5, None, None),                # 6
    ("sync", 12.0, 12.0, 6, None, None),                         # 7
    ("engine.decode", 13.0, 13.9, 3, None, 2),                   # 8
    ("model.decode_step", 13.1, 13.8, 8, None, None),            # 9
    ("block.attn", 13.2, 13.3, 9, None, 0),                      # 10
    ("sync", 13.25, 13.25, 10, None, None),                      # 11
    ("sync", 13.28, 13.28, 10, None, None),                      # 12
    ("engine.read_tokens", 13.8, 13.9, 8, None, None),           # 13
    ("sync", 13.89, 13.89, 13, None, None),                      # 14
    ("engine.submit", 15.5, 15.5, -1, 3, None),                  # 15
    ("engine.step", 16.5, 19.5, -1, None, None),                 # 16
    ("engine.admit", 16.6, 16.65, 16, 3, None),                  # 17
    ("engine.admit", 16.7, 16.75, 16, 2, None),                  # 18
    ("engine.decode", 16.8, 18.9, 16, None, 1),                  # 19
    ("model.decode_step", 17.0, 18.5, 19, None, None),           # 20
    ("engine.read_tokens", 18.5, 18.9, 19, None, None),          # 21
    ("sync", 18.88, 18.88, 21, None, None),                      # 22
    ("model.prefill", 19.6, 20.4, -1, None, None),               # 23
    ("sync", 20.2, 20.2, 23, None, None),                        # 24
]
COUNTERS = {"moe.pairs": 4000, "moe.dropped_pairs": 30.0,
            "copy.weight_cast": 3e8, "copy.kv_upcast": 1e8,
            "copy.cache_pad": 2e7, "copy.splice": 2e7,
            "sync.engine.read_tokens": 3}
#: host times of output tokens: four inside the slice
TOKENS = [5.0, 12.0, 13.9, 18.9, 18.9, 25.0]

WANT = {
    # idle inside a model call: [11.2, 12] + [12.5, 13] + [13.1, 13.8]
    # + [17, 18] = 3.0 s of 10
    "idle_in_model_share": 30.0,
    # in engine.step outside the model calls: [11, 11.2] + [13, 13.1]
    # + [13.8, 14] + [16.5, 17] + [19, 19.5] = 1.5 s
    "idle_in_engine_share": 15.0,
    "decode_dispatch_ms": 1e3 * (0.7 + 1.5) / 2,
    # syncs under engine.decode: 11, 12, 14, 22; two ticks
    "decode_syncs_per_tick": 2.0,
    # rid 1: 11.1 - 10.2, rid 2: 16.7 - 10.4, rid 3: 16.6 - 15.5 (rid 0's
    # submission lies before the slice)
    "queue_wait_p50_ms": 1e3 * 1.1,
    "moe_drop_share": 0.75,
    "weight_cast_mb_tok": 3e8 / 1e6 / 4,
    "kv_copy_mb_tok": 1.4e8 / 1e6 / 4,
}


def _snapshot(records=RECORDS, counters=COUNTERS):
    return spans.Snapshot(
        [spans.Span(name, round(a * 1e9), round(b * 1e9), p, rid, n)
         for name, a, b, p, rid, n in records], dict(counters), 0)


def _run(sl=True):
    track = Track(spec=None, req=None, t_submit=0.0, times=list(TOKENS))
    window = Window(0.0, 30.0, [], [track])
    return session.RunView(None, None, 1.0, window,
                           devtrace.Slice(10.0, 20.0, OPS) if sl else None,
                           [])


@pytest.fixture
def snapshot(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot)


@pytest.mark.parametrize("name", NEW)
def test_reader_exact_figure(snapshot, name):
    got = session.read_metric(name, _run())
    assert got == pytest.approx(WANT[name], rel=1e-9, abs=1e-9)


def test_idle_split_adds_up_to_idle_share(snapshot):
    run = _run()
    idle = session.read_metric("idle_share", run)
    assert idle == pytest.approx(65.0)
    split = spanview.idle_split(run, spanview.load(run))
    assert split["outside"] == pytest.approx(2.0)
    total = (session.read_metric("idle_in_model_share", run)
             + session.read_metric("idle_in_engine_share", run)
             + 100.0 * split["outside"] / run.slice.seconds)
    assert total == pytest.approx(idle)


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing(monkeypatch, name):
    monkeypatch.setattr(spans, "snapshot", _snapshot)
    assert session.read_metric(name, _run(sl=False)) is None
    outside = [r for r in RECORDS if r[2] < 10.0 or r[2] > 20.0]
    monkeypatch.setattr(spans, "snapshot", lambda: _snapshot(outside))
    assert session.read_metric(name, _run()) is None
    # an older port, without the span module: nothing to read, no error
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    monkeypatch.delattr(runtime, "spans")
    assert session.read_metric(name, _run()) is None


def test_counter_readers_need_their_counters(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: _snapshot(
        counters={"copy.weight_cast": 1e6}))
    run = _run()
    assert session.read_metric("moe_drop_share", run) is None
    assert session.read_metric("kv_copy_mb_tok", run) is None
    assert session.read_metric("weight_cast_mb_tok", run) == 0.25


def test_interval_arithmetic():
    xs = spanview.union([(3, 4), (0, 1), (0.5, 2), (5, 5)])
    assert xs == [(0, 2), (3, 4)]
    assert spanview.intersect(xs, [(1, 3.5)]) == [(1, 2), (3, 3.5)]
    assert spanview.subtract(xs, [(0.5, 1), (3.5, 9)]) == \
        [(0, 0.5), (1, 2), (3, 3.5)]
    assert spanview.length(xs) == 3


def test_traced_run_reports_the_span_metrics():
    """At the reduced sizes on the CPU the slice holds no device
    operation, so the idle split is left out, as ``idle_share`` is; the
    span and counter readers give numbers."""
    cell = reduced("olmoe-1b-7b.chat_decode", trace_slice_s=1.0)
    out = session.execute(cell, SEED, 2.5, True, device="cpu")
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert "idle_in_model_share" not in m and "idle_in_engine_share" not in m
    assert m["decode_dispatch_ms"] > 0
    assert m["decode_syncs_per_tick"] == 0          # no card, no sync
    assert m["queue_wait_p50_ms"] >= 0
    assert 0 <= m["moe_drop_share"] < 100
    assert m["weight_cast_mb_tok"] > 0 and m["kv_copy_mb_tok"] > 0
    assert not spans.on()
