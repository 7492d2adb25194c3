"""Parameters, gradients and optimizer state between the JAX package's
pytrees and the port's ``Params`` / name-keyed dicts.

The JAX tree (``repro.models.transformer.init_params``) holds ``embed``,
``final_norm``, ``prefix`` (a list of per-layer dicts) and ``blocks`` (a
list of ``period`` dicts whose leaves are stacked on dim 0 over the scanned
repeats): layer ``start + b * period + pos`` is ``blocks[pos][...][b]``.
The port keeps one ParameterDict per layer, so the bridge unstacks.

Weights keep the JAX orientation, (in, out), and the port applies them as
``x @ W``: nothing is transposed either way, and a round trip is exact.
Gradients and the AdamW moments are dicts keyed by ``named_parameters``
names (``embed.tok``, ``layers.3.mixer.wq``); they map onto the same tree.
With tied embeddings ``embed.tok`` carries the sum of the gather's and the
LM head's gradients, in both packages.  Both directions speak numpy, so
this module needs no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Params, layer_plan


def _tensors(d, index=None, device="cpu"):
    out = {}
    for k, v in d.items():
        a = np.asarray(v if index is None else np.asarray(v)[index])
        out[k] = torch.tensor(a, device=device)
    return out


def _layer(tree_layer, index=None, device="cpu"):
    return {name: _tensors(sub, index, device)
            for name, sub in tree_layer.items()}


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Params:
    """JAX params pytree (leaves as numpy arrays) -> port ``Params``."""
    prefix, blocks = tree["prefix"], tree["blocks"]
    period = len(blocks)
    n_blocks = (next(iter(next(iter(blocks[0].values())).values())).shape[0]
                if period else 0)
    layers = [_layer(lp, device=device) for lp in prefix]
    for b in range(n_blocks):
        for pos in range(period):
            layers.append(_layer(blocks[pos], b, device))
    return Params(_tensors(tree["embed"], device=device),
                  _tensors(tree["final_norm"], device=device), layers)


def _to_jax_tree(named: Dict[str, np.ndarray], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """{'embed.tok': a, 'layers.3.mixer.wq': a, ...} -> the JAX tree, with
    the scanned layers stacked as ``layer_plan`` stacks them."""
    embed, final, by_layer = {}, {}, {}
    for name, a in named.items():
        parts = name.split(".")
        if parts[0] == "embed":
            embed[parts[1]] = a
        elif parts[0] == "final_norm":
            final[parts[1]] = a
        else:
            by_layer.setdefault(int(parts[1]), {}).setdefault(
                parts[2], {})[parts[3]] = a
    layers = [by_layer[i] for i in sorted(by_layer)]
    prefix, start, period, n_blocks = layer_plan(cfg)
    blocks = []
    for pos in range(period if n_blocks else 0):
        reps = [layers[start + b * period + pos] for b in range(n_blocks)]
        blocks.append({name: {k: np.stack([r[name][k] for r in reps])
                              for k in reps[0][name]}
                       for name in reps[0]})
    return {"embed": embed, "final_norm": final,
            "prefix": [layers[i] for i in prefix], "blocks": blocks}


def _numpy(named) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in named}


def params_to_jax(params: Params, cfg: ModelConfig) -> Dict[str, Any]:
    """Port ``Params`` -> the JAX params pytree, leaves as numpy arrays."""
    return _to_jax_tree(_numpy(params.named_parameters()), cfg)


def grads_to_jax(grads: Dict[str, torch.Tensor], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """Name-keyed gradients -> the JAX grads pytree (params-shaped)."""
    return _to_jax_tree(_numpy(grads.items()), cfg)


def opt_state_to_jax(state: Dict, cfg: ModelConfig) -> Dict[str, Any]:
    """Port AdamW state {'m', 'v', 'step'} -> the JAX ``init_opt_state``
    tree, leaves as numpy arrays."""
    return {"m": grads_to_jax(state["m"], cfg),
            "v": grads_to_jax(state["v"], cfg),
            "step": np.asarray(state["step"], np.int32)}


def opt_state_from_jax(tree: Dict[str, Any], device="cpu") -> Dict:
    """JAX AdamW state tree (numpy leaves) -> port state {'m', 'v',
    'step'} with f32 moments on ``device``."""
    def moments(t):
        return {n: p.detach().float()
                for n, p in params_from_jax(t, device).named_parameters()}
    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": int(np.asarray(tree["step"]))}
