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

A training state — ``{"params": <params tree>, "opt": {"m", "v",
"step"}}``, the tree the JAX package checkpoints — goes out through
:func:`train_state_to_tree` and comes back in place through
:func:`load_train_state`, each rank keeping its own shard.
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


def _jax_layers(tree: Dict[str, Any]):
    """A JAX tree's layers in order -> [(dict, index)]: each ``prefix``
    dict (index None), then each scanned repeat b of each ``blocks[pos]``
    (index b on its stacked dim 0)."""
    prefix, blocks = tree["prefix"], tree["blocks"]
    n_blocks = np.shape(_first_leaf(blocks[0]))[0] if blocks else 0
    return [(lp, None) for lp in prefix] + [
        (blocks[pos], b) for b in range(n_blocks)
        for pos in range(len(blocks))]


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Params:
    """JAX params pytree (leaves as numpy arrays) -> port ``Params``."""
    layers = [_tensors(d, index, device) for d, index in _jax_layers(tree)]
    return Params(_tensors(tree["embed"], device=device),
                  _tensors(tree["final_norm"], device=device), layers)


def _stack(trees, stack=np.stack):
    """Same-shaped nested dicts -> one nested dict of leaves stacked on a
    new dim 0 (by ``stack``)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def _to_jax_tree(named: Dict[str, np.ndarray], cfg: ModelConfig,
                 stack=np.stack) -> Dict[str, Any]:
    """{'embed.tok': a, 'layers.3.mixer.wq': a, 'layers.3.mixer.ln_x.scale':
    a, ...} -> the JAX tree (names nest at every dot), with the scanned
    layers stacked as ``layer_plan`` stacks them (by ``stack``)."""
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
                      for b in range(n_blocks)], stack)
              for pos in range(period if n_blocks else 0)]
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "prefix": [layers[i] for i in prefix], "blocks": blocks}


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A wrapper subclass (``core.parallel.Fp8Wire``, a shard FSDP2
    gathers in fp8) -> the tensor it wraps; any other tensor as is."""
    while type(t) is not torch.Tensor and hasattr(t, "__tensor_flatten__"):
        t = getattr(t, t.__tensor_flatten__()[0][0])
    return t


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor -> an array of its values in host memory of its own: the
    copy off a card, or a copy of a CPU tensor (whose ``.numpy()`` would
    share the memory that the optimizer goes on updating in place)."""
    t = _plain(t.detach())
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def _numpy(named) -> Dict[str, np.ndarray]:
    """(name, tensor) pairs -> {name: array}, each array a copy (see
    :func:`_host`).  A sharded tensor (``DTensor``) is gathered whole
    first: a collective, so every rank of its mesh must convert the same
    tensors in the same order."""
    return {k: _host(v.full_tensor() if isinstance(v, DTensor) else v)
            for k, v in named}


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


def train_state_to_tree(params: Params, opt_state: Dict, cfg: ModelConfig,
                        pipe_group=None) -> Dict[str, Any]:
    """A training state -> ``{"params": ..., "opt": {"m", "v", "step"}}``
    in the JAX package's layout, leaves as numpy arrays (``opt/step`` an
    int32 scalar): the tree a checkpoint holds.  Its arrays share no
    memory with the live state, so a background write may take them as
    they are.  A collective where the parameters are sharded or pipelined
    (see :func:`_numpy`)."""
    return {"params": params_to_jax(params, cfg, pipe_group),
            "opt": opt_state_to_jax(opt_state, cfg, pipe_group)}


class _Shape:
    """A leaf that is only a shape (what ``restore_checkpoint`` checks)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def train_state_target(params: Params, cfg: ModelConfig,
                       pipe_group=None) -> Dict[str, Any]:
    """The tree :func:`train_state_to_tree` would build, with shape-only
    leaves and no data moved: the target a checkpoint is restored
    against.  Over ``pipe_group`` the ranks swap their stages' shapes."""
    shapes = _over_pipe({n: _Shape(p.shape)
                         for n, p in params.named_parameters()}, pipe_group)

    def stack(leaves):
        return _Shape((len(leaves),) + leaves[0].shape)

    tree = _to_jax_tree(shapes, cfg, stack)
    return {"params": tree, "opt": {"m": tree, "v": tree,
                                    "step": _Shape(())}}


def _from_jax_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX tree -> {port name: leaf}, the scanned layers unstacked
    (views, no copy), as :func:`params_from_jax` orders them."""
    out: Dict[str, Any] = {}

    def walk(prefix, d, index=None):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v, index)
            else:
                out[prefix + k] = v if index is None else v[index]

    walk("embed.", tree["embed"])
    walk("final_norm.", tree["final_norm"])
    for i, (d, index) in enumerate(_jax_layers(tree)):
        walk(f"layers.{i}.", d, index)
    return out


def _local_cut(full: torch.Tensor, t: DTensor) -> torch.Tensor:
    """This rank's shard of the whole array ``full`` as the ``DTensor``
    ``t`` places it: cut by each mesh dimension's placement as
    ``torch.chunk`` cuts (FSDP2's and ``Shard``'s rule; a short last
    chunk, or none).  The model axis cut first where FSDP2 strides over
    it (``_StridedShard``, no ``Shard`` in every torch version), else in
    mesh order."""
    mesh, places = t.device_mesh, t.placements
    coord = mesh.get_coordinate()
    dims = range(mesh.ndim)
    if any(type(p).__name__ == "_StridedShard" for p in places):
        dims = reversed(dims)
    for d in dims:
        dim = getattr(places[d], "dim", None)
        if places[d].is_replicate() or dim is None or mesh.size(d) == 1:
            continue
        chunks = torch.chunk(full, mesh.size(d), dim=dim)
        full = (chunks[coord[d]] if coord[d] < len(chunks)
                else full.narrow(dim, 0, 0))
    return full


def _copy_into(dst: torch.Tensor, leaf, name: str) -> None:
    """Write the whole array ``leaf`` (numpy or tensor) into ``dst``'s
    storage in place: a ``DTensor`` takes its own shard of it."""
    if not isinstance(leaf, torch.Tensor):
        leaf = np.asarray(leaf)
        leaf = torch.from_numpy(leaf if leaf.flags.writeable else leaf.copy())
    src = leaf
    if isinstance(dst, DTensor):
        src = _local_cut(src, dst)
        dst = dst.to_local()
    dst = _plain(dst)
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"{name}: checkpoint {src.dtype} "
                         f"{tuple(src.shape)} does not fit this rank's "
                         f"{dst.dtype} {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def load_train_state(tree: Dict[str, Any], params: Params,
                     opt_state: Dict) -> None:
    """Write a loaded training state (the tree of
    :func:`train_state_to_tree`, numpy or tensor leaves) into the live
    ``params`` and ``opt_state`` in place, so FSDP2's registered
    parameters and hooks stay as they are: a plain tensor is copied, a
    ``DTensor`` takes its local shard (:func:`_local_cut`), and a pipe
    rank, whose other stages' layers are empty, its own stages'.  No
    collective."""
    p_tree = _from_jax_tree(tree["params"])
    m_tree, v_tree = (_from_jax_tree(tree["opt"][k]) for k in ("m", "v"))
    for name, p in params.named_parameters():
        _copy_into(p, p_tree[name], name)
        _copy_into(opt_state["m"][name], m_tree[name], f"m/{name}")
        _copy_into(opt_state["v"][name], v_tree[name], f"v/{name}")
    opt_state["step"] = int(np.asarray(tree["opt"]["step"]))


def cache_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX dense decode cache (``transformer.init_cache``'s tree after a
    prefill: ``prefix`` per-layer dicts and ``blocks`` stacked on a leading
    layer dim, leaves as numpy arrays) -> the port's ``{'layers': [...]}``
    (an attention layer's {'kv': {'k', 'v', 'kpos', 'idx'}}, an RWKV-6
    layer's {'att': {'x_prev', 'wkv'}, 'ffn': {'x_prev'}})."""
    return {"layers": [_tensors(d, index, device)
                       for d, index in _jax_layers(tree)]}


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
