"""The port's spans and counters (``repro_torch.runtime.spans``) on the
CPU: off, an engine run gives the same tokens as on and records nothing
(no span, no counter, no device counter); on, one engine step's span tree
(parents, request ids, one ``block.*`` span a layer a model call); the
MoE's dropped pairs and the four copy counters against hand counts from
the shapes; spans under ``torch.profiler`` as ``record_function`` ranges;
the optimizer's range of a training step; the buffer's bound, ``clear``
with a span open, and the sync-warning hook.  One ``cuda``-marked test
counts a traced decode tick's syncs on the card.

This file imports no JAX: the machine with the card has none."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.models import build
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import cast
from repro_torch.runtime import spans
from repro_torch.serve import Request, ServingEngine

ARCHS = ("olmoe-1b-7b", "mamba2-2.7b")
PROMPTS = (5, 9, 3)


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


def _model(arch, device="cpu", **cfg_kw):
    cfg = dataclasses.replace(get(arch).reduced(), **cfg_kw)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    if device != "cpu":
        params = _to(params, device)
    return cfg, model, params


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _serve(model, params, prompts=PROMPTS, slots=2, max_len=32, new=4,
           device="cpu"):
    eng = ServingEngine(model, params, batch_slots=slots, max_len=max_len,
                        device=device)
    for i, n in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=(np.arange(n) * 7 + i) % 200,
                           max_new_tokens=new))
    return eng


def _tokens(eng):
    return {r.rid: list(r.generated) for r in eng.run_until_drained()}


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_on_gives_the_same_tokens(arch):
    _, model, params = _model(arch)
    off = _tokens(_serve(model, params))
    snap = spans.snapshot()
    assert snap.spans == [] and snap.counters == {} and snap.dropped == 0
    assert spans._device == {} and not spans._live
    assert spans.span("engine.step") is spans.span("model.prefill")
    with spans.recording():
        on = _tokens(_serve(model, params))
    assert on == off
    snap = spans.snapshot()
    assert snap.spans and snap.counters
    assert not spans.on() and not spans._live


def _children(snap, i):
    return [j for j, s in enumerate(snap.spans) if s.parent == i]


def _names(snap, idx):
    return [snap.spans[j].name for j in idx]


@pytest.mark.parametrize("arch", ARCHS + ("smollm-360m",
                                          "recurrentgemma-2b"))
def test_span_tree_of_one_step(arch):
    cfg, model, params = _model(arch)
    kinds = cfg.layer_kinds()
    per_layer = {"moe": ["block.attn", "block.moe"],
                 "attn": ["block.attn", "block.mlp"],
                 "ssm": ["block.ssm"], "rec": ["block.rec"]}
    layers = [(name, i) for i, k in enumerate(kinds)
              for name in per_layer[k]]
    with spans.recording():
        eng = _serve(model, params, prompts=(5, 9, 3))
        eng.step()
    snap = spans.snapshot()
    top = [i for i, s in enumerate(snap.spans) if s.parent == -1]
    assert _names(snap, top) == ["engine.submit"] * 3 + ["engine.step"]
    assert [snap.spans[i].rid for i in top[:3]] == [0, 1, 2]
    step = top[-1]
    kids = _children(snap, step)
    assert _names(snap, kids) == ["engine.admit", "engine.admit",
                                  "engine.decode"]
    for rid, (admit, n) in enumerate(zip(kids[:2], (5, 9))):
        assert snap.spans[admit].rid == rid
        prefill, splice = _children(snap, admit)
        assert (snap.spans[prefill].name, snap.spans[prefill].rid,
                snap.spans[prefill].n) == ("engine.prefill", rid, n)
        assert (snap.spans[splice].name, snap.spans[splice].rid) == \
            ("engine.splice", rid)
        call, read = _children(snap, prefill)
        assert (snap.spans[call].name, snap.spans[read].name,
                snap.spans[read].rid) == ("model.prefill",
                                          "engine.read_first_token", rid)
        blocks = _children(snap, call)
        assert _names(snap, blocks) == ["model.embed"] + \
            [name for name, _ in layers] + ["model.head"]
        assert [snap.spans[j].n for j in blocks[1:-1]] == \
            [i for _, i in layers]
    tick = kids[2]
    assert snap.spans[tick].n == 2
    inputs, call, read = _children(snap, tick)
    assert _names(snap, [inputs, call, read]) == [
        "engine.decode_inputs", "model.decode_step", "engine.read_tokens"]
    blocks = _children(snap, call)
    assert _names(snap, blocks[1:-1]) == [name for name, _ in layers]
    for j, s in enumerate(snap.spans):
        assert s.t1_ns >= s.t0_ns
        if s.parent >= 0:
            p = snap.spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns


def test_moe_dropped_pairs_counter():
    """``moe.dropped_pairs`` is ``moe_local``'s share times its pairs, and
    ``moe.pairs`` the tokens times k, summed over the calls."""
    cfg, model, params = _model("olmoe-1b-7b", moe_capacity_factor=0.5)
    lp = params["blocks"]["layer_00"]["moe"]
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn((2, t, cfg.d_model), generator=gen).to(torch.bfloat16)
          for t in (7, 16)]
    want_drop, want_pairs = 0.0, 0
    for x in xs:
        b, s, d = x.shape
        _, _, dropped = moe_mod.moe_local(
            x.reshape(b * s, d), lp["router"], lp["wi"], lp.get("wg"),
            lp["wo"], cfg, moe_mod.capacity(b * s, cfg))
        want_drop += float(dropped.double() * (b * s * cfg.experts_per_token))
        want_pairs += b * s * cfg.experts_per_token
    assert want_drop > 0
    with spans.recording():
        for x in xs:
            moe_mod.moe_block(lp, x, cfg)
    got = spans.snapshot().counters
    assert got["moe.pairs"] == want_pairs
    assert got["moe.dropped_pairs"] == pytest.approx(want_drop, rel=1e-6)
    moe_mod.moe_block(lp, xs[0], cfg)           # off: counted no more
    assert spans.snapshot().counters["moe.pairs"] == want_pairs


def _cast_elements(cfg, params, tokens):
    """Elements one model call casts to bf16: every attention and
    MoE / MLP weight but the router, the LM head's table, and the
    embedding rows of its tokens."""
    n = tokens * cfg.d_model
    for lp in params["blocks"].values():
        n += sum(t.numel() for t in lp["attn"].values())
        n += sum(t.numel() for k, t in lp["moe"].items() if k != "router")
    emb = params["embedding"]
    return n + (emb["unembed"] if "unembed" in emb else emb["embed"]).numel()


def test_copy_counters_equal_a_hand_count():
    """One request of 5 tokens, one slot, ``max_len`` 32, two tokens: one
    prefill and one decode tick, each counter from the shapes."""
    cfg, model, params = _model("olmoe-1b-7b")
    prompt, max_len, slots = 5, 32, 1
    with spans.recording():
        eng = _serve(model, params, prompts=(prompt,), slots=slots,
                     max_len=max_len, new=2)
        assert len(_tokens(eng)[0]) == 2
    got = spans.snapshot().counters
    layers = cfg.num_layers
    kv = cfg.num_kv_heads * cfg.head_dim             # elements a position
    bf16, f32 = 2, 4
    assert got["copy.weight_cast"] == (f32 + bf16) * (
        _cast_elements(cfg, params, prompt)
        + _cast_elements(cfg, params, slots))
    # each layer's k and v: the cat reads and writes max_len positions
    assert got["copy.cache_pad"] == layers * 2 * 2 * max_len * kv * bf16
    # into the slot: read and write max_len positions
    assert got["copy.splice"] == layers * 2 * max_len * kv * (bf16 + bf16)
    # the tick: both caches of every slot read in bf16, written in f32
    assert got["copy.kv_upcast"] == \
        layers * 2 * slots * max_len * kv * (bf16 + f32)


def test_cast_counts_only_real_casts():
    x = torch.ones((3, 5))
    with spans.recording():
        cast(x)
        cast(x.to(torch.bfloat16))
    assert spans.snapshot().counters == {"copy.weight_cast": 15 * 6}


def test_spans_under_the_profiler():
    _, model, params = _model("olmoe-1b-7b")
    eng = _serve(model, params, prompts=(5, 6))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.step()
    assert not spans.on()
    snap = spans.snapshot()
    names = {s.name for s in snap.spans}
    want = {"engine.step", "engine.admit", "engine.prefill",
            "model.prefill", "block.attn", "block.moe", "engine.splice",
            "engine.decode", "model.decode_step", "engine.read_tokens"}
    assert want <= names
    assert want <= {e.name for e in prof.events()}
    # the submissions came before the profile: not in this period
    assert "engine.submit" not in names


def test_optimizer_range_is_a_span():
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.train import (AdamW, SyntheticLM, constant_schedule,
                                   init_state, make_train_step)
    from repro_torch.train.train_step import OPTIMIZER_RANGE
    cfg = get("smollm-360m").reduced()
    model = build(cfg)
    opt = AdamW(learning_rate=constant_schedule(1e-3))
    state = init_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt)
    src = SyntheticLM(cfg, ShapeSpec("t", 16, 2, "train"))
    batch = src.place(src.batch_for_step(0), "cpu")
    state, _ = step(state, batch)                 # off: nothing recorded
    assert spans.snapshot().spans == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    assert OPTIMIZER_RANGE in {e.name for e in prof.events()}
    assert OPTIMIZER_RANGE in {s.name for s in spans.snapshot().spans}


def test_buffer_bound_and_clear_with_a_span_open(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    with spans.recording():
        with spans.span("a"):
            with spans.span("b", rid=7, n=2):
                spans.mark("m", 7)
                spans.mark("dropped")
            with spans.span("dropped too"):
                pass
        snap = spans.snapshot()
        assert [tuple(s)[3:] for s in snap.spans] == [
            (-1, None, None), (0, 7, 2), (1, 7, None)]
        assert snap.dropped == 2
        with spans.span("open"):
            spans.clear()
        assert spans.snapshot().spans == []


def test_sync_warnings_are_counted_under_the_innermost_span():
    msg = spans.SYNC_WARNING + " (Triggered internally at x.cpp:1.)"
    with spans.recording():
        warnings.warn(msg)
        with spans.span("engine.decode"):
            with spans.span("engine.read_tokens"):
                warnings.warn(msg)
                warnings.warn(msg)
        with pytest.warns(UserWarning, match="unrelated"):
            warnings.warn("unrelated")
    snap = spans.snapshot()
    assert snap.counters == {"sync.outside": 1, "sync.engine.read_tokens": 2}
    syncs = [s for s in snap.spans if s.name == spans.SYNC]
    assert [s.parent for s in syncs] == [-1, 2, 2]
    assert warnings.showwarning is not spans._on_warning
    assert not any(f[1] is not None and f[1].pattern == spans.SYNC_WARNING
                   for f in warnings.filters)


@pytest.mark.cuda
def test_traced_decode_tick_syncs_once_reading_its_tokens():
    """On the card, a profiled tick that admits nothing: exactly one sync
    under ``engine.read_tokens`` (the tokens' copy to the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    _, model, params = _model("olmoe-1b-7b", device=dev)
    eng = _serve(model, params, prompts=(5, 9), new=8, device=dev)
    eng.step()                                   # both admitted
    eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        eng.step()
    snap = spans.snapshot()
    names = [s.name for s in snap.spans]
    assert "engine.admit" not in names and names.count("engine.decode") == 1
    read = names.index("engine.read_tokens")
    assert [s.parent for s in snap.spans if s.name == spans.SYNC].count(
        read) == 1
    assert snap.counters["sync.engine.read_tokens"] == 1
    assert torch.cuda.get_sync_debug_mode() == 0
