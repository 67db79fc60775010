"""starcoder2-15b — dense code LM, GQA + RoPE.

[arXiv:2402.19173; hf]  40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152.  Plain (non-gated) GELU MLP per the StarCoder2 arch; we model
full attention (the optional 4k sliding window is not modeled — DESIGN.md
§6.8).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,
    qkv_bias=True,            # starcoder2 uses bias
    sub_quadratic=False,
)
