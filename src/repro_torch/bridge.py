"""Parameters between the JAX package's pytree and the port's ``Params``.

The JAX tree (``repro.models.transformer.init_params``) holds ``embed``,
``final_norm``, ``prefix`` (a list of per-layer dicts) and ``blocks`` (a
list of ``period`` dicts whose leaves are stacked on dim 0 over the scanned
repeats): layer ``start + b * period + pos`` is ``blocks[pos][...][b]``.
The port keeps one ParameterDict per layer, so the bridge unstacks.

Weights keep the JAX orientation, (in, out), and the port applies them as
``x @ W``: nothing is transposed either way, and a round trip is exact.
Both directions speak numpy, so this module needs no JAX.
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


def _numpy(pdict) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in pdict.items()}


def params_to_jax(params: Params, cfg: ModelConfig) -> Dict[str, Any]:
    """Port ``Params`` -> the JAX params pytree, leaves as numpy arrays."""
    prefix, start, period, n_blocks = layer_plan(cfg)
    layers = [{name: _numpy(sub) for name, sub in lp.items()}
              for lp in params.layers]
    blocks = []
    for pos in range(period if n_blocks else 0):
        reps = [layers[start + b * period + pos] for b in range(n_blocks)]
        blocks.append({name: {k: np.stack([r[name][k] for r in reps])
                              for k in reps[0][name]}
                       for name in reps[0]})
    return {"embed": _numpy(params.embed),
            "final_norm": _numpy(params.final_norm),
            "prefix": [layers[i] for i in prefix],
            "blocks": blocks}
