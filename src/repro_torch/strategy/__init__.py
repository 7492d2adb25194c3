"""Unified executable-strategy API of the port (a copy of the JAX
package's; see descriptor.py for the design).

    from repro_torch import strategy

    s = strategy.parse("fsdp_bf16")           # or strategy.Strategy(...)
    topo = strategy.host_topology()
    plan = s.to_plan(cfg, topo, shape)        # DeviceMesh + ParallelPlan
    report = strategy.evaluate(cfg, s, topo, shape)   # analytic price
    ranked = strategy.search(cfg, topo, shape)        # planner
"""
from repro_torch.strategy.descriptor import (DP_MODES, Strategy,
                                             StrategyError, format_spec,
                                             parse)
from repro_torch.strategy.planner import (OBJECTIVES, PlannedStrategy, best,
                                          candidates, default_objective,
                                          evaluate, pareto_front, resolve,
                                          search)
from repro_torch.strategy.topology import (Topology, build_mesh,
                                           get_topology, host_topology,
                                           pod_topology)

__all__ = [
    "DP_MODES", "OBJECTIVES",
    "PlannedStrategy", "Strategy",
    "StrategyError", "Topology", "best", "build_mesh", "candidates",
    "default_objective", "evaluate", "format_spec", "get_topology",
    "host_topology", "parse", "pareto_front", "pod_topology", "resolve",
    "search",
]
