"""seamless-m4t-large-v2 — enc-dec multimodal (audio) transformer backbone.

[arXiv:2308.11596; hf]  24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206.  Encoder-decoder; the audio frontend (w2v-BERT conformer) is
a STUB — input_specs() provides precomputed frame embeddings (DESIGN.md §5).
24L is interpreted as 24 encoder + 24 decoder layers (the published text
stacks are 24/24).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    is_encdec=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,          # full MHA (GQA kv=16 == heads)
    d_ff=8192,
    vocab_size=256206,
    mlp_gated=False,          # classic transformer FFN (GELU)
    frontend="audio",
    frontend_tokens=0,        # encoder consumes frames directly
    sub_quadratic=False,
)
