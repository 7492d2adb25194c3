"""Parameters, gradients, optimizer state and dense decode caches between
the JAX package's pytrees and the port's ``Params`` / name-keyed dicts /
per-layer cache lists.

The JAX tree (``repro.models.transformer.init_params``) holds ``embed``,
``final_norm``, ``prefix`` (a list of per-layer dicts) and ``blocks`` (a
list of ``period`` dicts whose leaves are stacked on dim 0 over the scanned
repeats): layer ``start + b * period + pos`` is ``blocks[pos][...][b]``.
The port keeps one ParameterDict per layer, so the bridge unstacks; leaves
may sit at any depth (the RWKV-6 mixer nests ``ln_x``).

Weights keep the JAX orientation, (in, out), and the port applies them as
``x @ W``: nothing is transposed either way, and a round trip is exact.
Gradients and the AdamW moments are dicts keyed by ``named_parameters``
names (``embed.tok``, ``layers.3.mixer.wq``, ``layers.3.mixer.ln_x.scale``);
they map onto the same tree, nested at every dot.
With tied embeddings ``embed.tok`` carries the sum of the gather's and the
LM head's gradients, in both packages.  Both directions speak numpy, so
this module needs no JAX.  Towards JAX, a model sharded by FSDP2 and
tensor parallelism (and its ``DTensor`` gradients and moments, on the
(data, model) mesh) is gathered whole on every rank; under a pipeline,
given the pipe group, each rank's stage layers are gathered from the
others too.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Params, layer_plan


def _tensors(d, index=None, device="cpu"):
    """A dict of arrays, nested to any depth -> the same dict of tensors;
    with ``index``, each leaf's entry ``index`` on its stacked dim 0."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _tensors(v, index, device)
        else:
            a = np.asarray(v if index is None else np.asarray(v)[index])
            out[k] = torch.tensor(a, device=device)
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Params:
    """JAX params pytree (leaves as numpy arrays) -> port ``Params``."""
    prefix, blocks = tree["prefix"], tree["blocks"]
    period = len(blocks)
    n_blocks = np.shape(_first_leaf(blocks[0]))[0] if period else 0
    layers = [_tensors(lp, device=device) for lp in prefix]
    for b in range(n_blocks):
        for pos in range(period):
            layers.append(_tensors(blocks[pos], b, device))
    return Params(_tensors(tree["embed"], device=device),
                  _tensors(tree["final_norm"], device=device), layers)


def _stack(trees):
    """Same-shaped nested dicts -> one nested dict of leaves stacked on a
    new dim 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _to_jax_tree(named: Dict[str, np.ndarray], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """{'embed.tok': a, 'layers.3.mixer.wq': a, 'layers.3.mixer.ln_x.scale':
    a, ...} -> the JAX tree (names nest at every dot), with the scanned
    layers stacked as ``layer_plan`` stacks them."""
    tree: Dict[str, Any] = {}
    for name, a in named.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    by_layer = tree.get("layers", {})
    layers = [by_layer[str(i)] for i in range(len(by_layer))]
    prefix, start, period, n_blocks = layer_plan(cfg)
    blocks = [_stack([layers[start + b * period + pos]
                      for b in range(n_blocks)])
              for pos in range(period if n_blocks else 0)]
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "prefix": [layers[i] for i in prefix], "blocks": blocks}


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A wrapper subclass (``core.parallel.Fp8Wire``, a shard FSDP2
    gathers in fp8) -> the tensor it wraps; any other tensor as is."""
    while type(t) is not torch.Tensor and hasattr(t, "__tensor_flatten__"):
        t = getattr(t, t.__tensor_flatten__()[0][0])
    return t


def _numpy(named) -> Dict[str, np.ndarray]:
    """(name, tensor) pairs -> {name: array}.  A sharded tensor
    (``DTensor``) is gathered whole first: a collective, so every rank of
    its mesh must convert the same tensors in the same order."""
    return {k: _plain((v.full_tensor() if isinstance(v, DTensor) else v)
                      .detach()).cpu().numpy() for k, v in named}


def _over_pipe(named: Dict[str, np.ndarray], pipe_group
                ) -> Dict[str, np.ndarray]:
    """Each pipe rank's arrays -> all of them (a rank holds its stages'
    layers and the leaves every rank holds alike); a collective over
    ``pipe_group``, if one is given."""
    if pipe_group is None:
        return named
    parts = [None] * torch.distributed.get_world_size(pipe_group)
    torch.distributed.all_gather_object(parts, named, group=pipe_group)
    out: Dict[str, np.ndarray] = {}
    for part in parts:
        out.update(part)
    return out


def params_to_jax(params: Params, cfg: ModelConfig,
                  pipe_group=None) -> Dict[str, Any]:
    """Port ``Params`` -> the JAX params pytree, leaves as numpy arrays."""
    return _to_jax_tree(_over_pipe(_numpy(params.named_parameters()),
                                   pipe_group), cfg)


def grads_to_jax(grads: Dict[str, torch.Tensor], cfg: ModelConfig,
                 pipe_group=None) -> Dict[str, Any]:
    """Name-keyed gradients -> the JAX grads pytree (params-shaped)."""
    return _to_jax_tree(_over_pipe(_numpy(grads.items()), pipe_group), cfg)


def opt_state_to_jax(state: Dict, cfg: ModelConfig,
                     pipe_group=None) -> Dict[str, Any]:
    """Port AdamW state {'m', 'v', 'step'} -> the JAX ``init_opt_state``
    tree, leaves as numpy arrays."""
    return {"m": grads_to_jax(state["m"], cfg, pipe_group),
            "v": grads_to_jax(state["v"], cfg, pipe_group),
            "step": np.asarray(state["step"], np.int32)}


def opt_state_from_jax(tree: Dict[str, Any], device="cpu") -> Dict:
    """JAX AdamW state tree (numpy leaves) -> port state {'m', 'v',
    'step'} with f32 moments on ``device``."""
    def moments(t):
        return {n: p.detach().float()
                for n, p in params_from_jax(t, device).named_parameters()}
    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": int(np.asarray(tree["step"]))}


def cache_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX dense decode cache (``transformer.init_cache``'s tree after a
    prefill: ``prefix`` per-layer dicts and ``blocks`` stacked on a leading
    layer dim, leaves as numpy arrays) -> the port's ``{'layers': [...]}``
    (an attention layer's {'kv': {'k', 'v', 'kpos', 'idx'}}, an RWKV-6
    layer's {'att': {'x_prev', 'wkv'}, 'ffn': {'x_prev'}})."""
    prefix, blocks = tree["prefix"], tree["blocks"]
    period = len(blocks)
    n_blocks = np.shape(_first_leaf(blocks[0]))[0] if period else 0
    layers = [_tensors(lc, device=device) for lc in prefix]
    for b in range(n_blocks):
        for pos in range(period):
            layers.append(_tensors(blocks[pos], b, device))
    return {"layers": layers}


def cache_to_jax(cache: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's whole (unsharded) dense cache -> the JAX tree, leaves as
    numpy arrays, the scanned layers stacked as ``layer_plan`` stacks
    them."""
    def arrays(d):
        return {k: arrays(v) if isinstance(v, dict)
                else v.detach().cpu().numpy() for k, v in d.items()}

    layers = [arrays(lc) for lc in cache["layers"]]
    prefix, start, period, n_blocks = layer_plan(cfg)
    return {"prefix": [layers[i] for i in prefix],
            "blocks": [_stack([layers[start + b * period + pos]
                               for b in range(n_blocks)])
                       for pos in range(period if n_blocks else 0)]}
