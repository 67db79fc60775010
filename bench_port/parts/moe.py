"""A routed MoE: the router over every expert, then the token's top-k
experts, each an MLP of width ``d_ff``."""


def flops(cfg, context):
    d = cfg.d_model
    mats = 3 if cfg.mlp_gated else 2
    return (2.0 * d * cfg.num_experts
            + 2.0 * cfg.experts_per_token * mats * d * cfg.d_ff)
