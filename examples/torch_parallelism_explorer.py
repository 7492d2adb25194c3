"""The paper's §5 recommendations as a tool, on the PyTorch port: given a
model, a cluster, and a batch, search the executable-strategy space with
the cost-model-driven planner (repro_torch.strategy) and print the ranked
configurations — including context-parallel degrees and the throughput x
energy Pareto front; ``examples/parallelism_explorer.py`` on the port.

    PYTHONPATH=src python examples/torch_parallelism_explorer.py \\
        --model llama2-7b --hw H100 --gpus 256 --global_batch 512

Pure cost model: it needs no device.  ``main`` returns the ranked rows
(the planner's ``PlannedStrategy`` records, best first) and the specs of
the Pareto front.
"""
import argparse

from repro_torch import strategy as strategy_lib
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costmodel as cm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--hw", default="H100", choices=sorted(cm.HARDWARE))
    ap.add_argument("--gpus", type=int, default=256)
    ap.add_argument("--global_batch", type=int, default=512)
    ap.add_argument("--seq_len", type=int, default=4096)
    ap.add_argument("--zero", type=int, default=2, choices=[0, 2, 3])
    ap.add_argument("--hbm_gb", type=float, default=80.0)
    ap.add_argument("--objective", default="wps",
                    choices=sorted(strategy_lib.OBJECTIVES))
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_config(args.model)
    hw = cm.HARDWARE[args.hw]
    topo = strategy_lib.Topology(hw.name, args.gpus, island=hw.island,
                                 hardware=hw.name, hbm=args.hbm_gb * 2**30)
    shape = ShapeConfig("explore", args.seq_len, args.global_batch, "train")
    dp_mode = "ddp" if args.zero == 0 else "fsdp"
    ranked = strategy_lib.search(
        cfg, topo, shape, objective=args.objective, dp_modes=(dp_mode,),
        zero_stages=(args.zero,), pps=(1, 2, 4, 8, 16), cps=(1, 2, 4, 8),
        require_fits=False, require_lowerable=False)
    front = {p.spec for p in strategy_lib.pareto_front(
        ranked, objectives=("wps", "tokens_per_joule"))}

    print(f"{cfg.name} on {args.gpus}x {hw.name}, gb={args.global_batch}, "
          f"seq={args.seq_len}, ZeRO-{args.zero}, objective={args.objective}")
    print(f"{'spec':>18} {'tp':>3} {'pp':>3} {'cp':>3} {'ep':>3} {'dp':>5} "
          f"{'WPS':>12} "
          f"{'MFU':>6} {'exposed':>8} {'W/gpu':>6} {'tok/J':>7} "
          f"{'mem GB':>7} fits runs pareto")
    for p in ranked[: args.top]:
        r, s = p.report, p.strategy
        print(f"{p.spec:>18} {s.tp:>3} {s.pp:>3} {s.cp:>3} {s.ep:>3} "
              f"{r.strategy.dp:>5} {r.wps:>12,.0f} {r.mfu:>6.3f} "
              f"{r.t_comm_exposed / r.t_step:>8.1%} "
              f"{r.power_per_device:>6.0f} {r.tokens_per_joule:>7.2f} "
              f"{r.memory_per_device / 2**30:>7.1f} "
              f"{'y' if r.fits else 'n':>4} {'y' if p.lowers else 'n':>4} "
              f"{'*' if p.spec in front else '':>6}")
    # recommend only specs the port can execute (a point may fail to
    # lower, e.g. when the layer stack is not uniform or degrees do not
    # divide)
    best = next((p for p in ranked if p.lowers), None)
    if best is None:
        print("\nno ranked strategy lowers on this topology "
              "(analytic-only table)")
    else:
        print(f"\nrecommendation: --strategy {best.spec}  (paper §5: at "
              f"scale, small model-parallel degrees beat pure FSDP; the "
              f"same spec string drives repro_torch.launch.train / dryrun "
              f"/ serve)")
    return {"ranked": ranked, "front": front}


if __name__ == "__main__":
    main()
