"""Parallelization plan of the port: the precision policies and the
data-parallel half of the JAX package's ``core/parallel.py``.

``PrecisionPolicy``, ``PRECISION_POLICIES`` and ``ParallelPlan`` are
copies (the plan sits over a ``torch.distributed`` ``DeviceMesh``, and
carries its ZeRO stage, which FSDP2 needs and the JAX lowering leaves to
XLA); ``make_runtime`` derives a ``Runtime``'s dtypes from the plan's
policy as the JAX one does.  ``apply_plan`` takes the place of
``param_shardings`` and ``place_train_state``: it wraps every layer, then
the whole model, in FSDP2's ``fully_shard`` over the plan's mesh, so each
layer's parameters are gathered in its forward and its gradients
reduce-scattered in its backward.  One mechanism serves every dp mode:

  * ``fsdp`` shards over the ``data`` axis (ZeRO-3 reshards each layer
    after its forward, ZeRO-2 keeps it gathered until its backward);
  * ``hsdp`` across islands shards over ``data`` and replicates over
    ``pod`` (FSDP2 on a 2-D mesh);
  * ``ddp`` (ZeRO-0) replicates over the data axes and shards over the
    size-1 ``model`` axis — every rank holds whole parameters.

Gathers run at the parameter dtype (f32), as the JAX package gathers
(``comm_dtype ''``); the bf16 cast stays where the model casts (the
embedding, the LM head, each product).  The fp8 policy rounds each
gathered layer parameter through float8_e4m3fn to bf16 in the layer
(``Runtime.gather_dtype``), which gives the JAX package's values; its
wire stays f32.  ``_ovl`` becomes FSDP2's explicit prefetch of layer
i + 1 while layer i computes.  Tensor parallelism (``_param_spec``,
``activation_specs``, ``cache_shardings``) comes with its own slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.strategy.topology import mesh_shape

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Execution-side mixed-precision policy (dtype names, not torch
    dtypes, so the plan stays hashable and equal to the JAX package's).

    ``param_dtype`` is the stored-parameter dtype the runtime computes
    from; master parameters always stay f32 (``init_params`` initializes
    f32 and the optimizer updates in f32 — torchtitan's
    ``MixedPrecisionPolicy`` split).  ``compute_dtype`` is the activation/
    matmul dtype, ``grad_dtype`` the grad-accumulation/reduce dtype, and
    ``comm_dtype`` (when set) the wire dtype of the per-layer ZeRO param
    all-gathers — the emulated-fp8-comms path: quantize, gather, and
    dequantize back to ``compute_dtype`` (FSDP2's fp8 all-gather
    extension point).
    """
    name: str
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    grad_dtype: str = "float32"
    comm_dtype: str = ""                 # '' = gather at param_dtype


PRECISION_POLICIES = {
    "f32": PrecisionPolicy("f32"),
    "bf16": PrecisionPolicy("bf16", param_dtype="float32",
                            compute_dtype="bfloat16"),
    "fp8": PrecisionPolicy("fp8", param_dtype="float32",
                           compute_dtype="bfloat16",
                           comm_dtype="float8_e4m3fn"),
}


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    mesh: Any                            # DeviceMesh, or {axis: size}
    dp: Tuple[str, ...]                  # batch-dim axes ('pod','data') or ('data',)
    fsdp: Tuple[str, ...]                # param-shard axes (HSDP: ('data',))
    tp: str                              # model axis name
    attn: str                            # 'head_tp' | 'context'
    kv_tp: bool                          # shard KV heads on model axis
    shape_mode: str = "train"            # train | prefill | decode
    decode_cache_axes: Tuple[str, ...] = ("model",)
    seq_parallel_residuals: bool = True  # Megatron-SP residual stream
    pipe: str = ""                       # pipeline mesh axis ('' = no PP)
    microbatches: int = 1                # pipeline microbatches per minibatch
    pipe_sched: str = "gpipe"            # pipeline schedule: 'gpipe' |
                                         # '1f1b' | '1f1b_i<v>' | 'zb'
    zero_overlap: bool = False           # prefetch layer l+1's gather
                                         # during layer l's compute
    expert: str = ""                     # expert mesh axis ('' = no EP)
    precision: str = "f32"               # PRECISION_POLICIES key
    zero: int = 3                        # ZeRO stage: 3 reshards a layer
                                         # after its forward, 2 keeps it
                                         # gathered through its backward,
                                         # 0 replicates (fsdp == ())

    @property
    def policy(self) -> PrecisionPolicy:
        return PRECISION_POLICIES[self.precision]

    @property
    def tp_size(self) -> int:
        return mesh_shape(self.mesh)[self.tp]

    @property
    def pipe_size(self) -> int:
        return mesh_shape(self.mesh)[self.pipe] if self.pipe else 1

    @property
    def ep_size(self) -> int:
        return mesh_shape(self.mesh)[self.expert] if self.expert else 1

    @property
    def fsdp_no_expert(self) -> Tuple[str, ...]:
        """Param-shard axes for tensors already sharded over 'expert'
        (the non-E dims of expert stacks must not reuse the axis)."""
        return tuple(a for a in self.fsdp if a != self.expert)

    def axis_size(self, axes) -> int:
        shape = mesh_shape(self.mesh)
        n = 1
        for a in axes:
            n *= shape[a]
        return n


def make_runtime(cfg: ModelConfig, plan: ParallelPlan, shape: ShapeConfig,
                 **overrides):
    """Runtime with this plan's dtypes: ``param_dtype``, ``compute_dtype``
    and ``grad_dtype`` from its precision policy, and the fp8 policy's wire
    dtype when the plan shards parameters (the JAX package turns its
    per-layer gatherer on under the same condition)."""
    from repro_torch.models.layers import Runtime
    pol = plan.policy
    kw = dict(param_dtype=_DTYPES[pol.param_dtype],
              compute_dtype=_DTYPES[pol.compute_dtype],
              grad_dtype=_DTYPES[pol.grad_dtype])
    if pol.comm_dtype and plan.fsdp:
        kw["gather_dtype"] = _DTYPES[pol.comm_dtype]
    kw.update(overrides)
    return Runtime(**kw)


def _fsdp_mesh(plan: ParallelPlan):
    """The (sub)mesh FSDP2 runs over: 1-D over the shard axes when the
    plan shards over every data axis; else 2-D (replicate, shard), with
    the size-1 model axis as the shard dimension of ZeRO-0."""
    shard = plan.fsdp or (plan.tp,)
    replicate = tuple(a for a in plan.dp if a not in shard)
    if len(shard) != 1:
        raise ValueError(f"FSDP2 shards over one mesh axis; plan shards "
                         f"over {shard}")
    if not replicate:
        return plan.mesh[shard[0]]
    if len(replicate) == 1:
        return plan.mesh[replicate + shard]
    # ZeRO-0 across islands: every data-parallel rank replicates
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(
        plan.mesh.device_type,
        (plan.axis_size(replicate), plan.axis_size(shard)),
        mesh_dim_names=("dp_replicate", shard[0]))


def apply_plan(params, plan: ParallelPlan):
    """Shard ``params`` (a ``Params`` module on this rank's device) in
    place under ``plan`` -> the same module, now an FSDP2 module whose
    parameters are ``DTensor`` shards.  Every rank must hold the same
    weights first (a seeded ``init_params``).  The embedding, the LM head
    and the final norm stay in the root unit: tied embeddings use one
    table at both ends."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    pol = plan.policy
    mesh = _fsdp_mesh(plan)
    # inputs keep their dtype: the model casts where the JAX package casts
    mp = MixedPrecisionPolicy(param_dtype=_DTYPES[pol.param_dtype],
                              reduce_dtype=_DTYPES[pol.grad_dtype],
                              cast_forward_inputs=False)
    reshard = bool(plan.fsdp) and plan.zero >= 3
    layers = list(params.layers)
    for layer in layers:
        fully_shard(layer, mesh=mesh, reshard_after_forward=reshard,
                    mp_policy=mp)
    fully_shard(params, mesh=mesh, reshard_after_forward=reshard,
                mp_policy=mp)
    if plan.zero_overlap:
        for cur, nxt in zip(layers, layers[1:]):
            cur.set_modules_to_forward_prefetch([nxt])
            nxt.set_modules_to_backward_prefetch([cur])
    return params

