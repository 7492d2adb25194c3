"""Shape and dtype stand-ins for the model inputs: the dry run's inputs
(the port of the JAX package's ``launch/specs.py``, token inputs only).

``train_batch_specs(cfg, shape)`` gives the training batch as
``{name: TensorSpec}``, the port's counterpart of JAX's
``ShapeDtypeStruct``, ``prefill_batch_specs`` the prompts of a prefill and
``decode_token_specs`` the (tokens, pos) pair of a decode step; the dry
run makes each one a fake tensor.  The
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


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, TensorSpec]:
    """{'tokens'}: (global batch, seq_len) int32."""
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels")
    return batch


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[TensorSpec, TensorSpec]:
    """(tokens (global batch, 1) int32, pos () int32)."""
    return (TensorSpec((shape.global_batch, 1), torch.int32),
            TensorSpec((), torch.int32))
