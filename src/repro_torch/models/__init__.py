from repro_torch.models.model import (forward_decode, forward_prefill,
                                      forward_train, init_caches,
                                      init_params, model_specs, stage_plan)
from repro_torch.models.param import (ParamTree, opt_state_from_numpy,
                                      params_from_numpy)
from repro_torch.models.steps import (chunked_xent, loss_fn,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)

__all__ = [
    "ParamTree", "chunked_xent", "forward_decode", "forward_prefill",
    "forward_train", "init_caches", "init_params", "loss_fn",
    "make_decode_step", "make_prefill_step", "make_train_step",
    "model_specs", "opt_state_from_numpy", "params_from_numpy",
    "stage_plan",
]
