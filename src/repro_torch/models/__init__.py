from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import (Params, forward, init_params,
                                            layer_plan)

__all__ = ["Runtime", "Params", "init_params", "forward", "layer_plan"]
