"""The port's dry run at full size on the pod for the MoE archs (under
``fsdp_ep8`` and the legacy tp layout) and the non-token archs, the
points it skips naming their reason, and the context attention the
legacy layout resolves to (split from ``tests/test_torch_dryrun_memory.py``
so that ``--dist loadfile`` spreads the two).  A train point is traced
with remat (``make_runtime``'s train default, as JAX lowers it): the
backward reruns each block as far as its backward needs, so the
collectives and MoE dispatches inside a block count twice, a block's last
collective once.
"""
import json

import numpy as np
import pytest

from repro_torch.configs import LATER, SHAPES, get_config
from repro_torch.launch import dryrun
from test_torch_dryrun import QWEN, trace_points
from test_torch_fsdp import _few_threads  # noqa: F401

# long_500k on full attention, for the JAX package's reason
SKIPS = [(arch, "long_500k") for arch in (QWEN, "llama2-1b", "llama2-7b",
                                          "qwen2-1.5b", "granite-20b")] \
    + [(arch, "train_4k") for arch in sorted(LATER)]


MOE = ["deepseek-moe-16b", "dbrx-132b"]
INPUTS = ["musicgen-medium", "qwen2-vl-2b"]


@pytest.fixture(scope="module")
def points(tmp_path_factory):
    """(their directory, {key: record}) of the points below, traced at
    once, each record written under its key's directory."""
    pts = {f"ep-{arch}": (arch, "train_4k", dict(strategy="fsdp_ep8"))
           for arch in MOE}
    pts["legacy"] = ("deepseek-moe-16b", "train_4k", {})
    pts["context"] = (QWEN, "train_4k", dict(attn_override="context"))
    for arch in INPUTS:
        for shape in ("train_4k", "prefill_32k"):
            pts[f"{arch}-{shape}"] = (arch, shape, {})
    out = tmp_path_factory.mktemp("points")
    return out, trace_points(pts, out)


@pytest.mark.parametrize("arch", MOE)
def test_moe_points_trace_under_ep(arch, points):
    """train_4k of each MoE arch at full size under ``fsdp_ep8`` on the
    pod (256 fake ranks: data 32 x expert 8) traces with remat: every MoE
    layer took the all-to-all (``moe_dispatch``) in its forward and again
    in the backward's recompute of its block, and the census counts its
    six exchanges a layer (dispatch and combine in the forward, in the
    recompute and in the backward), each moving the (E, C, d) buffer
    JAX's HLO counts, C the capacity of a rank's 4096 tokens; its
    analytic fields and resilience block are JAX's."""
    from test_torch_dryrun import _analytic_equal, _jax_point, _jax_resilience
    rec = points[1][f"ep-{arch}"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config(arch)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert rec["plan"]["mesh"] == {"data": 32, "expert": 8, "model": 1}
    assert rec["plan"]["dp"] == rec["plan"]["fsdp"] == ["data", "expert"]
    assert rec["remat"] is True
    assert rec["moe_dispatch"] == {"ep_calls": 2 * n_moe,
                                   "ep_padded_calls": 0,
                                   "ep_fallback_calls": 0}
    m = cfg.moe
    tokens = SHAPES["train_4k"].global_batch * SHAPES["train_4k"].seq_len \
        // 256
    cap = -(-tokens * m.top_k * m.capacity_factor // m.n_experts)
    cap = max(8, -(-int(cap) // 8) * 8)
    assert rec["collectives"]["all-to-all"] == {
        "count": 6 * n_moe, "bytes": 6 * n_moe * m.n_experts * cap
        * cfg.d_model * 4}
    jcfg, shape, s, topo = _jax_point(arch, "fsdp_ep8", "pod", "train_4k")
    _analytic_equal(rec, jcfg, shape)
    assert rec["resilience"] == _jax_resilience(jcfg, s, topo)


def test_moe_under_the_legacy_tp_layout_is_refused(points):
    """The legacy pod layout (hsdp_tp16) on a MoE arch traces: every MoE
    layer splits its experts over the model axis (4 of deepseek's 64 a
    rank) and leaves through its combine's reduce-scatter (one a layer,
    in the forward: the backward's recompute of a block stops once it has
    what the backward saves, before the block's last collective), which
    the record names (``collective_sites``)."""
    rec = points[1]["legacy"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config("deepseek-moe-16b")
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert rec["plan"]["mesh"]["model"] == 16 and rec["plan"]["attn"] == \
        "head_tp"
    assert rec["remat"] is True
    assert rec["collective_sites"]["moe_combine"] == n_moe


@pytest.mark.parametrize("arch", INPUTS)
def test_input_points_trace_as_jax(arch, points):
    """train_4k and prefill_32k of the non-token archs at full size on the
    pod (the legacy layout: tp 16 resolves to context attention for 24
    and 12 heads, K and V gathered in every layer's forward, and again in
    the train step's recompute of each block) trace; the train
    record's analytic fields and resilience block are JAX's, and the
    prefill point's inputs (frame embeds, or tokens with patch embeds and
    position ids, as the JAX package's specs give them) are its
    activations at the peak, byte for byte."""
    from repro.launch import specs as jspecs
    from test_torch_dryrun import _analytic_equal, _jax_point, _jax_resilience
    cfg = get_config(arch)
    out, recs = points
    for shape in ("train_4k", "prefill_32k"):
        rec = recs[f"{arch}-{shape}"]
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["plan"]["attn"] == "context"
        assert rec["collective_sites"]["context_kv_gather"] == \
            2 * cfg.n_layers * (2 if rec["remat"] else 1)
        assert rec["remat"] is (shape == "train_4k")
    jcfg, jshape, s, topo = _jax_point(arch, "hsdp_tp16", "pod", "train_4k")
    train = json.loads((out / f"{arch}-train_4k" /
                        f"{arch}_train_4k_pod16x16.json").read_text())
    _analytic_equal(train, jcfg, jshape)
    assert train["resilience"] == _jax_resilience(jcfg, s, topo)
    jshape = _jax_point(arch, "hsdp_tp16", "pod", "prefill_32k")[1]
    inputs = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                 for x in jspecs.prefill_batch_specs(jcfg, jshape).values())
    assert rec["memory"]["activations_bytes"] == inputs


@pytest.mark.parametrize("arch,shape", SKIPS)
def test_unported_points_are_skipped_naming_their_slice(arch, shape,
                                                         tmp_path):
    rec = dryrun.run_one(arch, shape, False, str(tmp_path), device="cpu")
    assert json.loads(next(tmp_path.glob("*.json")).read_text()) == rec
    assert rec["status"] == "skipped"
    want = (f"'{LATER[arch]}' slice" if arch in LATER
            else dryrun.SUBQUADRATIC)
    assert want in rec["reason"]


def test_context_attention_is_refused_as_cp(points):
    """``--attn context`` on the pod layout resolves tp 16 to context
    attention, which traces: every layer gathers K and V over the model
    axis in its forward and in the backward's recompute, named in the
    record (``collective_sites``), and the census holds their backward's
    reduce-scatters beside FSDP2's."""
    rec = points[1]["context"]
    assert rec["status"] == "ok", rec.get("traceback")
    L = get_config(QWEN).n_layers
    assert rec["plan"]["attn"] == "context"
    assert rec["remat"] is True
    assert rec["collective_sites"]["context_kv_gather"] == 4 * L
    assert rec["collective_sites"]["moe_combine"] == 0
    assert rec["collectives"]["reduce-scatter"]["count"] >= 2 * L
