"""End-to-end example on the PyTorch port: train a ~100M-parameter
llama-family model on the synthetic corpus, with checkpointing and the
sharded train loop — ``examples/train_100m.py`` on the port.

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] [--device cpu]

One process trains on one card (or the host with ``--device cpu``) under
``Strategy(dp_mode="fsdp")`` on a one-rank process group; under
``torchrun`` the same script trains on every rank of the job (the plan
and runtime adapt to the mesh).  Checkpoints go to
``results/ckpt/llama-100m`` every ``--ckpt_every`` steps, in the JAX
package's layout.  ``main`` returns the losses and the final training
state as the checkpoint holds it (``bridge.train_state_to_tree``).
"""
import argparse

import numpy as np

from repro_torch import bridge
from repro_torch import strategy as strategy_lib
from repro_torch.configs import ShapeConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import parallel as par
from repro_torch.data import Batcher, SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, local_rank, shutdown
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train_loop

# ~100M params: 12L, d=768, vocab 16k (llama-style SwiGLU decoder)
M100 = ModelConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=2048, vocab_size=16384,
    source="paper-style Llama-2 family scaled to ~100M")
# the loss must fall by LEARN_DROP over a run of at least LEARN_STEPS
# steps (the JAX example's bar; a shorter run is a smoke of the loop)
LEARN_STEPS, LEARN_DROP = 60, 0.5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq_len", type=int, default=256)
    ap.add_argument("--global_batch", type=int, default=8)
    ap.add_argument("--ckpt_every", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device, local_rank())

    cfg = M100
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    shape = ShapeConfig("e2e", args.seq_len, args.global_batch, "train")
    batches = Batcher(SyntheticSource(cfg.vocab_size, seed=1),
                      shape.seq_len, shape.global_batch)
    tc = TrainConfig(steps=args.steps, warmup=20,
                     log_every=min(20, args.steps),
                     ckpt_every=args.ckpt_every,
                     ckpt_dir="results/ckpt/llama-100m",
                     opt=AdamWConfig(lr=6e-4))
    init_distributed(device)
    try:
        topo = strategy_lib.host_topology()
        plan = strategy_lib.Strategy(dp_mode="fsdp").to_plan(cfg, topo,
                                                             shape)
        rt = par.make_runtime(cfg, plan, shape, remat=False)
        params = par.apply_plan(init_params(cfg, 0, device), plan, cfg)
        params, opt_state, history = train_loop(cfg, rt, tc, batches,
                                                params, plan=plan)
        state = bridge.train_state_to_tree(params, opt_state, cfg)
        del params, opt_state
    finally:
        shutdown()
    losses = [h["loss"] for h in history]
    first, last = losses[0], losses[-1]
    print(f"loss {first:.4f} -> {last:.4f}")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses {losses}")
    if args.steps >= LEARN_STEPS and not last < first - LEARN_DROP:
        raise RuntimeError("expected substantial learning on synthetic "
                           f"data: loss {first:.4f} -> {last:.4f}")
    return {"losses": losses, "state": state}


if __name__ == "__main__":
    main()
