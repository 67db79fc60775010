"""mamba2-2.7b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]  64L d_model=2560 (attn-free) d_ff=0
vocab=50280, ssm_state=128.  expand=2 -> d_inner=5120; head_dim=64 ->
80 SSD heads; conv width 4.  Sub-quadratic -> runs long_500k with O(1)
recurrent state (no KV cache).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_groups=1,
    conv_width=4,
    sub_quadratic=True,
)
