"""Model configurations: a copy of :mod:`repro.configs` (``base`` and the
ten architecture files are plain data), resolved by ``--arch <id>``."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import all_configs, arch_ids, get
