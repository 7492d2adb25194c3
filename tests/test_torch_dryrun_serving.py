"""The dry run's serving points of the archs the port serves (prefill,
decode and ``long_500k`` of RWKV-6, the Llama-2 family, granite-20b,
h2o-danube-1.8b and qwen2-1.5b) on the pod topology, on the CPU: each
traces on 256 fake ranks, its caches per device exactly the bytes of the
shards JAX's ``cache_shardings`` gives them (the rest of the dry run's
tests: ``tests/test_torch_dryrun.py``)."""
import pytest

from test_torch_dryrun import _jax_cache_bytes, trace_points
from test_torch_fsdp import _few_threads  # noqa: F401

# the serving points of the other archs the port serves, on the pod:
# RWKV-6's three (long_500k too: a recurrent state, batch 1 < data 16
# spreads the caches over data x model), the Llama-2 family's decode
# (70B's 8 KV heads do not split over the model axis of 16; 13B's 40
# query heads do not either, which resolves tp 16 to context attention,
# so it runs hsdp_tp8) and two prefills
SERVING = [("rwkv6-1.6b", "prefill_32k", ""),
           ("rwkv6-1.6b", "decode_32k", ""),
           ("rwkv6-1.6b", "long_500k", "")] + \
    [(f"llama2-{n}", "decode_32k", "") for n in ("1b", "7b", "70b")] + \
    [("llama2-13b", "decode_32k", "hsdp_tp8"),
     ("llama2-1b", "prefill_32k", ""), ("llama2-70b", "prefill_32k", "")] + \
    [("granite-20b", "decode_32k", ""),       # one KV head, 48 query heads
     ("h2o-danube-1.8b", "decode_32k", ""),   # a ring of 4096 slots
     ("h2o-danube-1.8b", "long_500k", ""),    # the window: sub-quadratic
     ("qwen2-1.5b", "decode_32k", "hsdp_tp4")]   # 12 heads: tp 16 is cp


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return trace_points({i: (arch, shape, dict(strategy=spec))
                         for i, (arch, shape, spec) in enumerate(SERVING)},
                        tmp_path_factory.mktemp("serving"))


@pytest.mark.parametrize("arch,shape,spec", SERVING)
def test_serving_points_trace_with_jax_cache_shards(arch, shape, spec,
                                                    records):
    """Each point traces on 256 fake ranks (the legacy pod layout unless a
    spec is given); its caches take exactly the bytes per device of JAX's
    shards on the same plan, and the decode cache axes are JAX's
    choice."""
    rec = records[SERVING.index((arch, shape, spec))]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cache_bytes_per_device"] == _jax_cache_bytes(
        arch, shape, rec["plan"])
    assert rec["memory"]["cache_bytes"] >= rec["cache_bytes_per_device"]
    axes = ["data", "model"] if shape == "long_500k" else ["model"]
    assert rec["plan"]["decode_cache_axes"] == axes
