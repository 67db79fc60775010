"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1:2 attn:recurrent.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1, i.e. MQA)
d_ff=7680 vocab=256000.  Block pattern (rec, rec, attn) repeating; local
attention window 2048; RG-LRU width = d_model with block-diagonal gates
(num heads = attention heads).  Sub-quadratic -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attention="local",
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_heads=10,
    mlp_gated=True,          # gated MLP: silu(g) * h, as models/layers.py
    scan_layers=False,       # heterogeneous pattern -> python loop (26L ok)
    sub_quadratic=True,
)
