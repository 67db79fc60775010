"""The LM substrate's models: dense and hybrid (RG-LRU + local attention)
decoders."""
from repro_torch.models.model import Model, build
