"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode with the KV/state cache — on a hybrid (Jamba-family) model, to
exercise attention + Mamba + MoE caches together; ``examples/
serve_batched.py`` on the port.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The paged engine refuses a recurrent stack (as the JAX package's gate
does), so ``generate`` serves it from dense caches (``generate_static``).
Runs on the card unless ``--device cpu``; ``main`` returns the greedy and
sampled outputs, the tokens generated per call and the wall times.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import Runtime, init_params
from repro_torch.serve import ServeEngine

SEED = 7


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("jamba-v0.1-52b"))
    rt = Runtime(rwkv_chunk=16, mamba_chunk=16, moe_impl="dense")
    params = init_params(cfg, SEED, device)

    batch, prompt_len, n_new = 8, 48, 24
    engine = ServeEngine(cfg, params, rt, max_len=prompt_len + n_new,
                         device=device)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)

    t0 = time.time()
    greedy = engine.generate(prompts, n_new)
    t1 = time.time()
    sampled = engine.generate(prompts, n_new, temperature=0.8, seed=SEED)
    t2 = time.time()

    if greedy.shape != (batch, prompt_len + n_new):
        raise RuntimeError(f"greedy output shape {greedy.shape}")
    # greedy decode is deterministic
    again = engine.generate(prompts, n_new)
    if not np.array_equal(again, greedy):
        raise RuntimeError("greedy decode is not deterministic")
    print(f"greedy:  {batch * n_new} tokens in {t1-t0:.2f}s")
    print(f"sampled: {batch * n_new} tokens in {t2-t1:.2f}s")
    print("batch 0 greedy tail:", greedy[0, -8:].tolist())
    print("batch 0 sampled tail:", sampled[0, -8:].tolist())
    print("serve_batched OK")
    return {"greedy": greedy, "sampled": sampled, "tokens": batch * n_new,
            "greedy_s": t1 - t0, "sampled_s": t2 - t1}


if __name__ == "__main__":
    main()
