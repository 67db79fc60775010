"""internvl2-1b — VLM: InternViT frontend + Qwen2-0.5B-class LM backbone.

[arXiv:2404.16821; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  The vision frontend (InternViT) is a STUB — input_specs()
provides precomputed patch embeddings prepended to the text sequence
(DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,            # qwen2-style
    frontend="vision",
    frontend_tokens=256,      # one 448x448 tile -> 256 patch tokens
    sub_quadratic=False,
)
