"""AdamW and learning-rate schedules of the port."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state)
from repro_torch.optim.schedule import linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "linear_warmup_cosine"]
