"""Shape and dtype stand-ins for the model inputs: the dry run's inputs
(the port of the JAX package's ``launch/specs.py``), and a small concrete
batch of the same structure for tests and smoke runs.

``train_batch_specs(cfg, shape)`` gives the training batch as
``{name: TensorSpec}``, the port's counterpart of JAX's
``ShapeDtypeStruct``, ``prefill_batch_specs`` the prompts of a prefill and
``decode_token_specs`` the (tokens, pos) pair of a decode step; the dry
run makes each one a fake tensor.  The modality front ends are stubs, as
in the JAX package: an ``embeddings`` model (musicgen-medium) takes
precomputed frame ``embeds`` in place of tokens, a ``tokens+vision``
model (qwen2-vl-2b) takes precomputed patch ``vision_embeds`` beside its
tokens and the 3-D M-RoPE ``position_ids``.
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
    """{'tokens' or 'embeds', 'labels'[, 'vision_embeds',
    'position_ids']}: tokens and labels (global batch, seq_len) int32;
    frame embeds (B, S, d) and patch embeds (B, V, d) bf16, as the JAX
    package's specs give them; position ids (3, B, S) int32."""
    dtype = torch.bfloat16
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = TensorSpec((B, S, cfg.d_model), dtype)
    else:
        batch["tokens"] = TensorSpec((B, S), torch.int32)
    batch["labels"] = TensorSpec((B, S), torch.int32)
    if cfg.input_mode == "tokens+vision":
        batch["vision_embeds"] = TensorSpec((B, cfg.vision_tokens,
                                             cfg.d_model), dtype)
        batch["position_ids"] = TensorSpec((3, B, S), torch.int32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, TensorSpec]:
    """The training batch's inputs without its labels."""
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels")
    return batch


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[TensorSpec, TensorSpec]:
    """(tokens (global batch, 1) int32, pos () int32)."""
    return (TensorSpec((shape.global_batch, 1), torch.int32),
            TensorSpec((), torch.int32))


def grid_position_ids(batch_size: int, seq_len: int, grid_h: int,
                      grid_w: int, device="cpu") -> torch.Tensor:
    """M-RoPE position ids (3, B, S) int32 of a stream that opens with a
    ``grid_h`` x ``grid_w`` grid of image patches (row-major) and goes on
    with text, as Qwen2-VL numbers them: patch i sits at (t, h, w) = (0,
    i // grid_w, i % grid_w), and the text after the grid at t = h = w =
    max(grid_h, grid_w) + its index among the text positions."""
    n = grid_h * grid_w
    i = torch.arange(seq_len, device=device)
    text = (i - n).clamp_min(0) + max(grid_h, grid_w)
    ids = torch.stack([torch.where(i < n, 0, text),
                       torch.where(i < n, i // grid_w, text),
                       torch.where(i < n, i % grid_w, text)])
    return ids[:, None].expand(3, batch_size, seq_len).to(torch.int32)


def concrete_train_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                         seed: int = 0, device="cpu"
                         ) -> Dict[str, torch.Tensor]:
    """A small concrete batch of the specs' structure (the JAX package's
    ``concrete_train_batch``), drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``: frame embeds ~ N(0, 0.1²) or tokens
    uniform over the vocabulary, labels uniform over it, patch embeds ~
    N(0, 0.02²) (embeddings f32), and the position ids of a text stream
    (t = h = w = 0..S-1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B, S, d = batch_size, seq_len, cfg.d_model
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = torch.randn((B, S, d), generator=gen,
                                      device=device) * 0.1
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen, device=device,
                                        dtype=torch.int32)
    batch["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=gen, device=device,
                                    dtype=torch.int32)
    if cfg.input_mode == "tokens+vision":
        batch["vision_embeds"] = torch.randn(
            (B, cfg.vision_tokens, d), generator=gen, device=device) * 0.02
        pos = torch.arange(S, dtype=torch.int32, device=device)
        batch["position_ids"] = pos[None, None].expand(3, B, S).contiguous()
    return batch
