from repro_torch.resilience.faults import (FaultEvent, FaultPlan,
                                           SimulatedFailure, load_fault_plan)
from repro_torch.resilience.supervisor import (RestartBudgetExceeded,
                                               Supervisor, SupervisorConfig,
                                               supervise_training)

__all__ = [
    "FaultEvent", "FaultPlan", "SimulatedFailure", "load_fault_plan",
    "RestartBudgetExceeded", "Supervisor", "SupervisorConfig",
    "supervise_training",
]
