from repro_torch.kernels.bucket_pack.bucket_pack import (bucket_pack,
                                                         bucket_pack_cuda,
                                                         counter)
from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref

__all__ = ["bucket_pack", "bucket_pack_cuda", "bucket_pack_ref", "counter"]
