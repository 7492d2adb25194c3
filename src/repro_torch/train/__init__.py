"""Training on one device: the train step (gradient accumulation, AdamW)
and the loop around it."""
from repro_torch.train.trainer import TrainConfig, make_train_step, train_loop

__all__ = ["TrainConfig", "make_train_step", "train_loop"]
