"""The yardstick's formulas against hand counts at tiny shapes."""
import dataclasses
import itertools

import pytest

from bench_port import counts
from bench_port.spec import model_config, load_cell


def test_flash_attn_counts_only_causal_pairs():
    s, h, k, hd = 3, 2, 1, 4
    pairs = sum(1 for i, j in itertools.product(range(s), repeat=2)
                if j <= i)
    flops, nbytes = counts.flash_attn(s, h, k, hd)
    assert pairs == 6
    assert flops == 2 * 2 * hd * h * pairs           # QK^T and PV
    assert nbytes == 2 * (s * h * hd * 2 + s * k * hd * 2)
    assert counts.flash_attn_bound_s(s, h, k, hd) == max(
        flops / 989e12, nbytes / 3.35e12)


def test_ssd_scan_counts_its_recurrence():
    s, h, p, n = 2, 1, 2, 3
    flops, nbytes = counts.ssd_scan(s, h, p, n, init_state=False)
    # per step and head: decay P*N, outer product P*N FMAs, read-out P*N
    assert flops == s * h * (p * n + 2 * p * n + 2 * p * n)
    words = s * h * p + s * h + 2 * s * n + h + s * h * p + h * p * n
    assert nbytes == 4 * words
    with_init = counts.ssd_scan(s, h, p, n, init_state=True)[1]
    assert with_init == nbytes + 4 * h * p * n
    assert counts.ssd_scan_bound_s(s, h, p, n) == max(
        flops / 495e12, nbytes / 3.35e12)


def _cfg(name):
    return model_config(load_cell(name).config).reduced()


def test_moe_token_flops_by_hand():
    cfg = _cfg("olmoe-1b-7b.code_long_prompt")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    per_layer = (2 * d * hd * (2 * h + 2 * k) + 2 * d * cfg.num_experts
                 + 2 * cfg.experts_per_token * 3 * d * f + 4 * 5 * h * hd)
    assert counts.token_flops(cfg, 5) == cfg.num_layers * per_layer
    assert counts.decode_flops(cfg, 4) == cfg.num_layers * per_layer \
        + 2 * d * cfg.vocab_size


def test_ssm_token_flops_by_hand():
    cfg = _cfg("mamba2-2.7b.code_long_prompt")
    d, di, n, p = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // p
    per_layer = (2 * d * (2 * di + 2 * n + nh) + 2 * di * d
                 + 2 * 4 * (di + 2 * n) + 5 * nh * p * n)
    assert counts.token_flops(cfg, 7) == cfg.num_layers * per_layer
    assert counts.token_flops(cfg, 7) == counts.token_flops(cfg, 1)


@pytest.mark.parametrize("name", ["olmoe-1b-7b.code_long_prompt",
                                  "mamba2-2.7b.code_long_prompt"])
def test_prefill_is_its_tokens_and_one_head(name):
    cfg = _cfg(name)
    s = 9
    want = sum(counts.token_flops(cfg, i + 1) for i in range(s)) \
        + counts.lm_head_flops(cfg)
    assert counts.prefill_flops(cfg, s) == pytest.approx(want, rel=1e-12)


def test_dense_layer_counts_its_mlp():
    cfg = dataclasses.replace(_cfg("olmoe-1b-7b.code_long_prompt"),
                              family="dense", num_experts=0,
                              experts_per_token=0)
    moe = _cfg("olmoe-1b-7b.code_long_prompt")
    d, f = cfg.d_model, cfg.d_ff
    diff = counts.token_flops(moe, 1) - counts.token_flops(cfg, 1)
    assert diff == cfg.num_layers * (2 * d * moe.num_experts
                                     + 2 * 2 * 3 * d * f - 2 * 3 * d * f)
