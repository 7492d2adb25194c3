"""Shape and dtype stand-ins for the model inputs: the dry run's inputs
(the port of the JAX package's ``launch/specs.py``, token inputs only).

``train_batch_specs(cfg, shape)`` gives the training batch as
``{name: TensorSpec}``, the port's counterpart of JAX's
``ShapeDtypeStruct``; the dry run makes each one a fake tensor.  The
embedding and vision inputs of the JAX package's other architectures come
with the slice that ports them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, TensorSpec]:
    """{'tokens', 'labels'}: (global batch, seq_len) int32 each."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.input_mode!r} inputs come with the 'other "
            "mixers and inputs' slice of the PyTorch port")
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": TensorSpec((B, S), torch.int32),
            "labels": TensorSpec((B, S), torch.int32)}
