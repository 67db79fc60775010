from repro_torch.train.optimizer import (
    AdamW, AdamWState, constant_schedule, cosine_schedule, global_norm,
)
from repro_torch.train.train_step import TrainState, init_state, make_train_step
from repro_torch.train.data import DataConfig, SyntheticLM, Prefetcher
from repro_torch.train import grad_compress
