from repro_torch.kernels.segment_combine.ref import (segment_combine_blocked,
                                                     segment_combine_ref)
from repro_torch.kernels.segment_combine.segment_combine import (
    counter, segment_combine, segment_combine_cuda)

__all__ = ["counter", "segment_combine", "segment_combine_blocked",
           "segment_combine_cuda", "segment_combine_ref"]
