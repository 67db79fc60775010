"""The LM substrate's models: dense, hybrid (RG-LRU + local attention) and
ssm (Mamba2) decoders."""
from repro_torch.models.model import Model, build
