"""A dense MLP: two matrices, three where it is gated (SwiGLU)."""


def flops(cfg, context):
    mats = 3 if cfg.mlp_gated else 2
    return 2.0 * mats * cfg.d_model * cfg.d_ff
