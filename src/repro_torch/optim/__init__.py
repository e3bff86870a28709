from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule)
from repro_torch.optim.compress import (compress_gradients,
                                        decompress_gradients,
                                        init_error_feedback)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "compress_gradients", "decompress_gradients",
           "init_error_feedback"]
