from repro_torch.models.model import (forward_decode, forward_prefill,
                                      init_caches, init_params, model_specs,
                                      stage_plan)
from repro_torch.models.param import ParamTree, params_from_numpy
from repro_torch.models.steps import make_decode_step, make_prefill_step

__all__ = [
    "ParamTree", "forward_decode", "forward_prefill", "init_caches",
    "init_params", "make_decode_step", "make_prefill_step", "model_specs",
    "params_from_numpy", "stage_plan",
]
