"""A Mamba2 (SSD) mixer: the in and out projections, the depthwise conv
over x, B and C, and the recurrence's ``5 x H x P x N`` a step."""


def flops(cfg, context):
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    g = cfg.ssm_groups
    return (2.0 * d * (2 * di + 2 * g * n + nh) + 2.0 * di * d
            + 2.0 * cfg.conv_width * (di + 2 * g * n)
            + 5.0 * nh * cfg.ssm_head_dim * n)
