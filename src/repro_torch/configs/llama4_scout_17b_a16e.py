"""llama4-scout-17b-a16e — MoE (16 experts, top-1), early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.  Modeled with every
layer MoE and homogeneous layers (DESIGN.md §6.9).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    sub_quadratic=False,
)
