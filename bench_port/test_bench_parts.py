"""Model FLOPs by layer parts (``parts/<part>.py``): the counts of both
configurations pinned, a kind of layer that mixes parts, a local window,
and the roofline readers finding layers by their parts."""
import dataclasses
import itertools
from types import SimpleNamespace

import pytest

from bench_port import counts, session
from bench_port.spec import BENCH_DIR, model_config, read_json


def _file(name):
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


def _cfg(name):
    return model_config(_file(name))


#: the counts of the parent commit of the change to layer parts (its
#: ``token_flops`` summed layer by layer), at the configurations' full
#: sizes: token_flops at contexts 0 and 1, prefill_flops(., 1500),
#: decode_flops(., 2047); each is a whole number, so equal to the bit
PINNED_FLOPS = {
    "olmoe-1b-7b": (2151677952.0, 2151809024.0, 3375277277184.0,
                    2626158592.0),
    "mamba2-2.7b": (5355732992.0, 5355732992.0, 8033856962560.0,
                    5613207552.0),
}


@pytest.mark.parametrize("name", sorted(PINNED_FLOPS))
def test_token_prefill_decode_flops_pinned(name):
    cfg, config = _cfg(name), _file(name)
    t0, t1, prefill, decode = PINNED_FLOPS[name]
    assert counts.token_flops(cfg, 0, config) == t0
    assert counts.token_flops(cfg, 1, config) == t1
    assert counts.prefill_flops(cfg, 1500, config) == prefill
    assert counts.decode_flops(cfg, 2047, config) == decode
    assert counts.prefill_flops(cfg, 1500) == prefill    # the default map


#: the parent commit's bounds at the cells' prompt lengths (the mixes'
#: clips and medians): flash at olmoe's 16 heads of 128, the SSD scan at
#: mamba2's 80 heads of 64, state 128
PINNED_FLASH_S = {128: 6.260155223880597e-07, 256: 1.2520310447761193e-06,
                  1020: 4.988561194029851e-06, 1500: 9.324715874620829e-06,
                  2048: 1.737943153892821e-05, 4096: 6.950076233771487e-05}
PINNED_SSD_S = {256: 4.015398208955224e-06, 1500: 1.972470447761194e-05,
                4096: 5.250714746268657e-05}


@pytest.mark.parametrize("s", sorted(PINNED_FLASH_S))
def test_flash_attn_bound_pinned(s):
    assert counts.flash_attn_bound_s(s, 16, 16, 128) == PINNED_FLASH_S[s]


@pytest.mark.parametrize("s", sorted(PINNED_SSD_S))
def test_ssd_scan_bound_pinned(s):
    assert counts.ssd_scan_bound_s(s, 80, 64, 128) == PINNED_SSD_S[s]


def _run(name, prefills, positions):
    """A run view of one step: ``prefills`` prompt lengths, a decode tick
    of ``positions``, a 1 s window, 1 ms of flash and of the SSD scan."""
    step = SimpleNamespace(prefills=[(0.0, 0.0, n) for n in prefills],
                           decode=(0.0, 0.0, tuple(positions)))
    kinds = {"flash_attention_fwd": 1e-3, "ssd_scan": 1e-3}
    return SimpleNamespace(
        cell=SimpleNamespace(config=_file(name)), cfg=_cfg(name),
        window=SimpleNamespace(steps=[step], seconds=1.0),
        slice=SimpleNamespace(by_kind=lambda: kinds), slice_steps=[step])


@pytest.mark.parametrize("name", sorted(PINNED_FLOPS))
def test_readers_give_the_pinned_counts(name):
    run = _run(name, [1500], [2047])
    _, _, prefill, decode = PINNED_FLOPS[name]
    assert session.read_metric("mfu", run) == pytest.approx(
        100.0 * (prefill + decode) / 989e12, rel=1e-15)
    flash = session.read_metric("flash_attn_roofline", run)
    ssd = session.read_metric("ssd_scan_roofline", run)
    if name == "olmoe-1b-7b":
        assert flash == pytest.approx(
            100.0 * 16 * PINNED_FLASH_S[1500] / 1e-3, rel=1e-15)
        assert ssd is None
    else:
        assert flash is None
        assert ssd == pytest.approx(
            100.0 * 64 * PINNED_SSD_S[1500] / 1e-3, rel=1e-15)


def _ssd_by_hand(cfg):
    d, n, p = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    di = 2 * d
    nh = di // p
    return (2 * d * (2 * di + 2 * n + nh) + 2 * di * d + 2 * 4 * (di + 2 * n)
            + 5 * nh * p * n)


def _moe_by_hand(cfg):
    d = cfg.d_model
    return 2 * d * cfg.num_experts + 2 * cfg.experts_per_token * 3 * d \
        * cfg.d_ff


def _ssm_moe(base):
    """``base`` (its d_model and depth) with a made-up layer kind of
    mamba2's SSD mixer and olmoe's experts."""
    ssm, moe = _cfg("mamba2-2.7b"), _cfg("olmoe-1b-7b")
    return dataclasses.replace(
        base, family="hybrid", block_pattern=("ssm_moe",),
        **{k: getattr(ssm, k) for k in (
            "ssm_state", "ssm_expand", "ssm_head_dim", "ssm_chunk",
            "ssm_groups", "conv_width")},
        **{k: getattr(moe, k) for k in (
            "num_experts", "experts_per_token", "d_ff", "mlp_gated")})


MIXED = {"layer_parts": {"ssm_moe": ["ssd", "moe"]}}


@pytest.mark.parametrize("name", ["mamba2-2.7b", "olmoe-1b-7b"])
def test_a_kind_that_mixes_parts_counts_their_sum(name):
    cfg = _ssm_moe(_cfg(name))
    per_layer = _ssd_by_hand(cfg) + _moe_by_hand(cfg)
    assert counts.token_flops(cfg, 9, MIXED) == cfg.num_layers * per_layer
    assert counts.decode_flops(cfg, 8, MIXED) == cfg.num_layers \
        * per_layer + 2 * cfg.d_model * cfg.vocab_size
    assert counts.prefill_flops(cfg, 7, MIXED) == 7 * cfg.num_layers \
        * per_layer + 2 * cfg.d_model * cfg.vocab_size
    assert counts.layers_with(cfg, "ssd", MIXED) == cfg.num_layers
    assert counts.layers_with(cfg, "attention", MIXED) == 0


def test_layers_are_found_by_part_in_a_pattern():
    cfg = dataclasses.replace(_ssm_moe(_cfg("olmoe-1b-7b")), num_layers=6,
                              block_pattern=("ssm_moe", "ssm_moe", "moe"))
    assert counts.layers_with(cfg, "ssd", MIXED) == 4
    assert counts.layers_with(cfg, "attention", MIXED) == 2
    assert counts.layers_with(cfg, "moe", MIXED) == 6
    assert counts.layers(cfg, MIXED) == [(4, ("ssd", "moe")),
                                         (2, ("attention", "moe"))]


def test_a_kind_with_no_parts_names_the_fix():
    cfg = dataclasses.replace(_cfg("olmoe-1b-7b"), family="hybrid",
                              block_pattern=("rec",))
    with pytest.raises(ValueError, match=r"layer_parts.*bench_port/parts/"):
        counts.token_flops(cfg, 1)
    with pytest.raises(ValueError, match="layer_parts"):
        counts.layers_with(cfg, "attention")


def test_a_part_with_no_file_names_the_fix():
    cfg = _cfg("olmoe-1b-7b")
    config = {"layer_parts": {"moe": ["attention", "shared_expert"]}}
    with pytest.raises(ValueError,
                       match=r"bench_port/parts/shared_expert\.py.*"
                             r"layer_parts"):
        counts.token_flops(cfg, 1, config)
    with pytest.raises(ValueError, match="bench_port/parts/"):
        counts.part("../counts")


def test_local_flash_attn_counts_the_pairs_it_keeps():
    s, w, h, k, hd = 8, 3, 2, 1, 4
    pairs = sum(1 for i, j in itertools.product(range(s), repeat=2)
                if i - w < j <= i)
    flops, nbytes = counts.flash_attn(s, h, k, hd, window=w)
    assert pairs == 21
    assert flops == 4 * h * hd * pairs
    assert nbytes == counts.flash_attn(s, h, k, hd)[1]
    assert counts.flash_attn(s, h, k, hd, window=s) \
        == counts.flash_attn(s, h, k, hd)
    assert counts.flash_attn_bound_s(s, h, k, hd, w) == max(
        flops / 989e12, nbytes / 3.35e12)


def test_local_attention_reads_its_window_only():
    cfg = dataclasses.replace(_cfg("olmoe-1b-7b").reduced(),
                              attention="local", window=3)
    h, hd = cfg.num_heads, cfg.head_dim
    assert counts.token_flops(cfg, 10) == counts.token_flops(cfg, 3)
    assert counts.token_flops(cfg, 2) == counts.token_flops(cfg, 3) \
        - cfg.num_layers * 4 * h * hd
    s = 8
    want = sum(counts.token_flops(cfg, i + 1) for i in range(s)) \
        + counts.lm_head_flops(cfg)
    assert counts.prefill_flops(cfg, s) == want
    full = dataclasses.replace(cfg, attention="full")
    kept = sum(min(i + 1, 3) for i in range(s))
    assert counts.prefill_flops(full, s) - counts.prefill_flops(cfg, s) \
        == cfg.num_layers * 4 * h * hd * (s * (s + 1) // 2 - kept)
