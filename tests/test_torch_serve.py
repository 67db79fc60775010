"""The port's serving engine and launcher on the CPU: the reference's
engine behaviours (``tests/test_serve.py``), one engine run against the
reference's engine on the same requests for each of
``recurrentgemma-2b.reduced()``, ``smollm-360m.reduced()`` and
``mamba2-2.7b.reduced()`` (``tests/test_serve.py``'s ssm engine round: 2
slots, ``max_len`` 32, prompts of 4-6 tokens) and ``olmoe-1b-7b.reduced()``
(moe: 4 experts, top-2; 2 slots for R5), the engine's refusal of an
encoder-decoder model, and the
reference faults R4 (``max_len`` below the local window) and R5 (one slot
with per-layer caches) that the port refuses or does not share.

Tolerance: the engines' logits are compared at the bf16 tolerance of
``tests/test_torch_models.py`` (``TOL_EPS`` bf16 epsilons of the largest
reference logit).  Generated tokens must be equal, except at a step where
the port's token scores within that tolerance of the reference's top
logit (a near tie that bf16 rounding may break either way); the request is then compared no
further, since its contexts differ from there on, and the test reports
the step as a warning."""
import re
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import ShardingCtx
from repro.models import build as ref_build
from repro.serve import Request as RefRequest
from repro.serve import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.launch import serve as launcher
from repro_torch.models import build
from repro_torch.serve import Request, ServingEngine

CTX = ShardingCtx()
BF16_EPS = 2.0 ** -7
TOL_EPS = 8
#: the engine-vs-reference run of each config: prompt lengths (the
#: recurrentgemma ones straddle its reduced window of 32), slots, max_len
RUNS = {"recurrentgemma-2b": ((5, 40, 70), 2, 96),
        "smollm-360m": ((4, 9, 20), 2, 64),
        "mamba2-2.7b": ((4, 5, 6), 2, 32),
        "olmoe-1b-7b": ((4, 9, 20), 2, 64)}
NEW_TOKENS = 6


def _setup(arch):
    cfg = get(arch).reduced()
    ref_model = ref_build(ref_get(arch).reduced())
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = convert.model_params(cfg, jax.tree.map(np.asarray, ref_params),
                                  device="cpu")
    return cfg, build(cfg), params, ref_model, ref_params


@pytest.fixture(scope="module")
def smollm():
    cfg, model, params, _, _ = _setup("smollm-360m")
    return cfg, model, params


def _engine(model, params, **kw):
    return ServingEngine(model, params, device="cpu", **kw)


class TestServingEngine:
    """``tests/test_serve.py``'s behaviours on the port (smollm reduced)."""

    def test_drains_all_requests(self, smollm):
        cfg, model, params = smollm
        eng = _engine(model, params, batch_slots=3, max_len=64)
        for i in range(7):
            eng.submit(Request(rid=i, prompt=np.arange(3 + i) % 50,
                               max_new_tokens=5))
        done = eng.run_until_drained()
        assert sorted(r.rid for r in done) == list(range(7))
        assert all(len(r.generated) == 5 for r in done)

    def test_batched_matches_single_request(self, smollm):
        """Continuous batching must not change any request's tokens."""
        cfg, model, params = smollm
        prompts = [np.arange(4) % 50, (np.arange(6) * 3) % 50,
                   (np.arange(5) * 7) % 50]
        ref_gens = []
        for i, p in enumerate(prompts):
            eng = _engine(model, params, batch_slots=1, max_len=64)
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
            ref_gens.append(eng.run_until_drained()[0].generated)
        eng = _engine(model, params, batch_slots=3, max_len=64)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        done = {r.rid: r.generated for r in eng.run_until_drained()}
        for i in range(3):
            assert done[i] == ref_gens[i], (i, done[i], ref_gens[i])

    def test_eos_frees_slot_early(self, smollm):
        cfg, model, params = smollm
        eng = _engine(model, params, batch_slots=1, max_len=64)
        probe = _engine(model, params, batch_slots=1, max_len=64)
        probe.submit(Request(rid=0, prompt=np.arange(4) % 50,
                             max_new_tokens=3))
        first = probe.run_until_drained()[0].generated[1]
        eng.submit(Request(rid=1, prompt=np.arange(4) % 50,
                           max_new_tokens=50, eos_id=int(first)))
        done = eng.run_until_drained()
        assert len(done[0].generated) < 50

    def test_rejects_prompt_longer_than_max_len(self, smollm):
        cfg, model, params = smollm
        eng = _engine(model, params, batch_slots=2, max_len=16)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(Request(rid=0, prompt=np.arange(16) % 50,
                               max_new_tokens=2))
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(Request(rid=1, prompt=np.arange(40) % 50,
                               max_new_tokens=2))
        assert not eng.queue
        eng.submit(Request(rid=2, prompt=np.arange(8) % 50,
                           max_new_tokens=3))
        assert [r.rid for r in eng.run_until_drained()] == [2]

    def test_freed_slot_state_fully_reset(self, smollm):
        cfg, model, params = smollm
        eng = _engine(model, params, batch_slots=1, max_len=64)
        eng.submit(Request(rid=0, prompt=(np.arange(9) * 5) % 50,
                           max_new_tokens=7))
        eng.run_until_drained()
        assert eng.positions[0] == 0
        assert eng.last_token[0] == 0
        probe = np.arange(4) % 50
        ref = _engine(model, params, batch_slots=1, max_len=64)
        ref.submit(Request(rid=1, prompt=probe, max_new_tokens=6))
        expect = ref.run_until_drained()[0].generated
        eng.submit(Request(rid=2, prompt=probe, max_new_tokens=6))
        assert eng.run_until_drained()[-1].generated == expect

    def test_recorder_hooks(self, smollm):
        cfg, model, params = smollm

        class Rec:
            def __init__(self):
                self.events = []

            def on_prefill(self, n):
                self.events.append(("prefill", n))

            def on_decode(self, positions):
                self.events.append(("decode", tuple(positions)))

            def on_tick(self, queued, active):
                self.events.append(("tick", queued, active))
        rec = Rec()
        eng = ServingEngine(model, params, batch_slots=2, max_len=32,
                            recorder=rec, device="cpu")
        for i, n in enumerate((3, 5, 4)):
            eng.submit(Request(rid=i, prompt=np.arange(n), max_new_tokens=2))
        eng.run_until_drained()
        assert rec.events[:5] == [("prefill", 3), ("prefill", 5),
                                  ("decode", (3, 5)), ("tick", 1, 0),
                                  ("prefill", 4)]


class Tap:
    """Wraps a model and records each request's logits: its prefill's
    (prefills run in submission order), then one row per decode tick
    while the request holds a slot.  The reference's engine traces
    ``decode_step`` under ``jax.jit``, so its decode rows are recorded
    around the compiled call instead (``tap_decode=False``)."""

    def __init__(self, model, tap_decode=True):
        self.model = model
        self.tap_decode = tap_decode
        self.prefills = []
        self.rows = {}
        self.engine = None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        logits, caches = self.model.prefill(*args, **kw)
        self.prefills.append(_np(logits)[0])
        return logits, caches

    def decode_step(self, *args, **kw):
        logits, caches = self.model.decode_step(*args, **kw)
        if self.tap_decode:
            self.record(logits)
        return logits, caches

    def record(self, logits):
        logits = _np(logits)
        for i, req in enumerate(self.engine.active):
            if req is not None:
                self.rows.setdefault(req.rid, []).append(logits[i])

    def logits(self, rid):
        return [self.prefills[rid]] + self.rows.get(rid, [])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _serve_both(arch):
    lens, slots, max_len = RUNS[arch]
    cfg, model, params, ref_model, ref_params = _setup(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]

    ref_tap = Tap(ref_model, tap_decode=False)
    ref_eng = RefEngine(ref_tap, ref_params, CTX, batch_slots=slots,
                        max_len=max_len)
    ref_tap.engine = ref_eng
    decode = ref_eng._decode

    def tapped(*args):
        logits, caches = decode(*args)
        ref_tap.record(logits)
        return logits, caches
    ref_eng._decode = tapped

    tap = Tap(model)
    eng = ServingEngine(tap, params, batch_slots=slots, max_len=max_len,
                        device="cpu")
    tap.engine = eng
    for e, req in ((ref_eng, RefRequest), (eng, Request)):
        for i, p in enumerate(prompts):
            e.submit(req(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    ref_done = {r.rid: r.generated for r in ref_eng.run_until_drained()}
    done = {r.rid: r.generated for r in eng.run_until_drained()}
    return ref_done, done, ref_tap, tap


@pytest.fixture(scope="module", params=sorted(RUNS))
def served(request):
    return request.param, _serve_both(request.param)


def test_engine_matches_reference_engine(served):
    arch, (ref_done, done, ref_tap, tap) = served
    assert sorted(done) == sorted(ref_done) == list(range(len(RUNS[arch][0])))
    ties = []
    for rid in sorted(done):
        want, got = ref_done[rid], done[rid]
        assert len(got) == len(want) == NEW_TOKENS
        ref_logits, logits = ref_tap.logits(rid), tap.logits(rid)
        for j, (w, g) in enumerate(zip(want, got)):
            scale = float(np.abs(ref_logits[j]).max())
            tol = TOL_EPS * BF16_EPS * scale
            err = float(np.abs(logits[j] - ref_logits[j]).max())
            assert err <= tol, (arch, rid, j, err, tol)
            assert int(np.argmax(ref_logits[j])) == w
            assert int(np.argmax(logits[j])) == g
            if g != w:
                gap = float(ref_logits[j][w] - ref_logits[j][g])
                assert gap <= tol, (arch, rid, j, g, w, gap, tol)
                ties.append((rid, j, gap))
                break
    if ties:
        warnings.warn(f"{arch}: the engines part at near ties (rid, step, "
                      f"port's token below the reference's top logit by): {ties}")
    assert len(ties) < len(done), "every request parted at a near tie"


def test_port_refuses_max_len_below_window_where_reference_fails():
    """R4: with max_len 24 below the reduced window 32, the reference's
    engine fails on its first request (the prefill's ring of 32 slots does
    not fit the 24-slot buffer); the port refuses at construction, naming
    both numbers."""
    cfg, model, params, ref_model, ref_params = _setup("recurrentgemma-2b")
    with pytest.raises(ValueError, match=r"max_len=24.*window=32"):
        ServingEngine(model, params, batch_slots=2, max_len=24,
                      device="cpu")
    ref_eng = RefEngine(ref_model, ref_params, CTX, batch_slots=2,
                        max_len=24)
    ref_eng.submit(RefRequest(rid=0, prompt=np.arange(5), max_new_tokens=2))
    with pytest.raises(ValueError, match="[Ii]ncompatible shapes"):
        ref_eng.run_until_drained()
    # at max_len == window the port serves
    eng = ServingEngine(model, params, batch_slots=2, max_len=32,
                        device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(5), max_new_tokens=2))
    assert len(eng.run_until_drained()[0].generated) == 2


def test_one_slot_hybrid_serves_where_reference_fails():
    """R5: the reference's splice takes axis 1 as the batch axis whenever
    a buffer's leading dim equals the prefill's, which per-layer caches
    with one slot do, so its one-slot hybrid engine fails; the port's
    per-layer buffers always splice on axis 0, and one slot gives the
    tokens of two."""
    cfg, model, params, ref_model, ref_params = _setup("recurrentgemma-2b")
    ref_eng = RefEngine(ref_model, ref_params, CTX, batch_slots=1,
                        max_len=64)
    ref_eng.submit(RefRequest(rid=0, prompt=np.arange(5), max_new_tokens=2))
    with pytest.raises(ValueError, match="[Ii]ncompatible shapes"):
        ref_eng.run_until_drained()
    gens = []
    for slots in (1, 2):
        eng = ServingEngine(model, params, batch_slots=slots, max_len=64,
                            device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(40) % 50,
                           max_new_tokens=4))
        gens.append(eng.run_until_drained()[0].generated)
    assert gens[0] == gens[1]


def test_launcher_reduced_on_cpu(capsys):
    out = launcher.main(["--arch", "recurrentgemma-2b", "--reduced",
                         "--device", "cpu", "--requests", "3",
                         "--max-new-tokens", "3", "--max-len", "32"])
    text = capsys.readouterr().out
    assert out["tokens"] == 9 and len(out["requests"]) == 3
    assert re.search(r"^serving recurrentgemma-2b-reduced: params=[\d,]+ "
                     r"slots=4$", text, re.M)
    assert re.search(r"^  rid=\d+ prompt_len=\d+ generated=\[.*\]\.\.\.$",
                     text, re.M)
    assert re.search(r"^done: 3 requests, 9 tokens in [\d.]+s "
                     r"\([\d.]+ tok/s\)$", text, re.M)


def test_launcher_serves_mamba2_reduced_on_cpu(capsys):
    """The ssm family through the launcher, at its default --max-len 128
    (no window), with prompts of 4-11 tokens: above the reduced chunk of
    8 and not multiples of it, which the reference cannot prefill (R6)."""
    out = launcher.main(["--arch", "mamba2-2.7b", "--reduced", "--device",
                         "cpu", "--requests", "4", "--max-new-tokens", "3"])
    text = capsys.readouterr().out
    assert out["tokens"] == 12 and len(out["requests"]) == 4
    assert any(len(r.prompt) > 8 and len(r.prompt) % 8
               for r in out["requests"])
    assert re.search(r"^serving mamba2-2.7b-reduced: params=89,136 "
                     r"slots=4$", text, re.M)


def test_launcher_serves_olmoe_reduced_on_cpu(capsys):
    """The moe family through the launcher (4 experts, top-2)."""
    out = launcher.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                         "cpu", "--requests", "3", "--max-new-tokens", "4"])
    text = capsys.readouterr().out
    assert out["tokens"] == 12 and len(out["requests"]) == 3
    assert re.search(r"^serving olmoe-1b-7b-reduced: params=254,784 "
                     r"slots=4$", text, re.M)


def test_engine_refuses_encdec_model():
    """An encoder-decoder prefill needs frames, which a request does not
    carry: the engine refuses the model at construction, saying why (the
    reference's engine builds and then fails at its first prefill, for
    want of ``frames``), and so does the launcher, before drawing any
    weights."""
    cfg = get("seamless-m4t-large-v2").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder-decoder.*frames"):
        ServingEngine(model, params, batch_slots=2, max_len=32,
                      device="cpu")
    ref_model = ref_build(ref_get("seamless-m4t-large-v2").reduced())
    ref_eng = RefEngine(ref_model, ref_model.init(jax.random.PRNGKey(0)),
                        CTX, batch_slots=2, max_len=32)
    ref_eng.submit(RefRequest(rid=0, prompt=np.arange(5), max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        ref_eng.run_until_drained()
    with pytest.raises(ValueError, match="encoder-decoder.*frames"):
        launcher.main(["--arch", "seamless-m4t-large-v2", "--device", "cpu"])


def test_launcher_refuses_max_len_below_window_before_init():
    """The launcher's default --max-len 128 is below recurrentgemma-2b's
    window of 2048: it raises the R4 error before drawing any of the
    3.3 B parameters."""
    with pytest.raises(ValueError, match=r"max_len=128.*window=2048"):
        launcher.main(["--arch", "recurrentgemma-2b", "--device", "cpu"])


def test_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "smollm-360m", "--reduced"])


def test_profile_kinds():
    """The serving profile's kernel kinds, from kernel names as the CUDA
    profiler reports them."""
    from repro_torch.launch.profile_serve import kind_of
    assert kind_of("void (anonymous namespace)::flash_fwd_kernel<"
                   "__nv_bfloat16, 8>(...)") == "flash_attention_fwd"
    assert kind_of("void (anonymous namespace)::flash_fwd_kernel_bf16<256, "
                   "2>(CUtensorMap, ...)") == "flash_attention_fwd"
    assert kind_of("void (anonymous namespace)::flash_fwd_kernel_f32<8>("
                   "float const*, ...)") == "flash_attention_fwd"
    assert kind_of("void (anonymous namespace)::rglru_scan_kernel("
                   "float const*, ...)") == "rglru_scan"
    assert kind_of("(anonymous namespace)::ssd_scan_kernel(float const*, "
                   "...)") == "ssd_scan"
    for stage in ("prep", "states", "out", "short"):
        assert kind_of(f"void (anonymous namespace)::ssd_scan_{stage}_kernel"
                       f"<true>(float const*, ...)") == "ssd_scan"
    assert kind_of("void (anonymous namespace)::ssd_scan_pass_kernel<4>("
                   "float const*, ...)") == "ssd_scan"
    assert kind_of("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT") == "matmul"
    assert kind_of("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") == "matmul"
    assert kind_of("void at::native::vectorized_elementwise_kernel<4, "
                   "at::native::bfloat16_copy_kernel_cuda(...)") == \
        "cast/copy"
    assert kind_of("Memcpy DtoD (Device -> Device)") == "cast/copy"
    assert kind_of("void at::native::reduce_kernel<512, 1, ...>") == "other"
