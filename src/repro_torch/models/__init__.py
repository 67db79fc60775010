"""The LM substrate's models: dense, moe, hybrid (RG-LRU + local
attention), ssm (Mamba2) and vision (vlm) decoders, and the
encoder-decoder (audio)."""
from repro_torch.models.model import Model, build
