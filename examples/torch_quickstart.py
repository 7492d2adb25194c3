"""Quickstart on the PyTorch port: train a tiny Qwen3-family model on
synthetic data, then generate from it — the port's public API, as
``examples/quickstart.py`` walks the JAX package's.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Trains under ``Strategy(dp_mode="fsdp")`` on a one-rank process group
(FSDP2 over a real mesh, as the train CLI runs), then serves the trained
weights through the paged engine (``ServeEngine.generate``).  Runs on the
card unless ``--device cpu``; ``main`` returns the losses, the generated
tokens and the engine's counts of forward calls and decode steps.
"""
import argparse

import numpy as np

from repro_torch import bridge
from repro_torch import strategy as strategy_lib
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import parallel as par
from repro_torch.data import Batcher, SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, shutdown
from repro_torch.models import Runtime, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("qwen3-0.6b"))          # 2 layers, d_model 256
    shape = ShapeConfig("quickstart", seq_len=128, global_batch=8, mode="train")
    batches = Batcher(SyntheticSource(cfg.vocab_size, seed=0),
                      shape.seq_len, shape.global_batch)
    tc = TrainConfig(steps=args.steps, warmup=5,
                     log_every=min(10, args.steps),
                     opt=AdamWConfig(lr=1e-3))
    init_distributed(device)
    try:
        topo = strategy_lib.host_topology()
        plan = strategy_lib.Strategy(dp_mode="fsdp").to_plan(cfg, topo,
                                                             shape)
        rt = par.make_runtime(cfg, plan, shape, remat=False)
        params = par.apply_plan(init_params(cfg, 0, device), plan, cfg)
        params, _, history = train_loop(cfg, rt, tc, batches, params,
                                        plan=plan)
        # the paged engine serves one device's whole weights: gather them
        weights = bridge.params_from_jax(bridge.params_to_jax(params, cfg),
                                         device)
        del params
    finally:
        shutdown()
    losses = [h["loss"] for h in history]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"did not learn: losses {losses}")

    engine = ServeEngine(cfg, weights, Runtime(), max_len=160,
                         device=device)
    prompts = next(iter(batches))["tokens"][:2, :64]
    out = engine.generate(prompts, n_new=16)
    print("generated:", out[0, -16:].tolist())
    print(f"quickstart OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses, "steps": args.steps, "tokens": out,
            "serve_stats": engine.stats}


if __name__ == "__main__":
    main()
