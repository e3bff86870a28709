"""The expert-grouped matmul behind one wrapper.

``grouped_matmul_cuda`` launches the hand-written Hopper kernel
(``kernels/csrc/moe_gmm.cu``; a TMA-fed, warp-specialised wgmma GEMM for
bfloat16, a plain FMA kernel for float32). The kernel takes the (E,)
group sizes itself and walks its own tile schedule, so a call is one
launch and no other op; ``ops.tile_map`` and ``ops.work_tiles`` replay
that schedule in torch. ``ops.grouped_matmul`` is the entry point the
model calls; it runs the plain version on CPU tensors.
``counter.launches`` counts kernel launches: the forward's, and the
backward's dX launches (``ops.GroupedMatmul``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE_M = 128           # rows a tile of the bfloat16 kernel (float32: 64)
MAX_GROUPS = 256       # groups the kernel's schedule holds
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def tile_n(f: int) -> int:
    """Columns a tile of the bfloat16 kernel, for an output of f columns
    (float32: 64)."""
    return 256 if f % 256 == 0 else 128


def _need(cond: bool, what: str):
    if not cond:
        raise ValueError(f"grouped_matmul_cuda: {what}")


def grouped_matmul_cuda(tokens: torch.Tensor, w: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. tokens: (T, d) expert-sorted; w: (E, d, f);
    group_sizes: (E,) int32 or int64 on the card, cut as ``ops.tile_map``
    cuts them. -> (T, f) in tokens' dtype, on the current stream, not
    synchronised."""
    dev = tokens.device
    _need(dev.type == "cuda" and w.device == dev
          and group_sizes.device == dev, "all tensors on one CUDA device")
    _need(tokens.dtype in DTYPE_CODES and w.dtype == tokens.dtype,
          "tokens and w both float32 or both bfloat16")
    _need(tokens.dim() == 2 and w.dim() == 3
          and w.shape[1] == tokens.shape[1], "tokens (T, d), w (E, d, f)")
    E = w.shape[0]
    _need(group_sizes.dtype in (torch.int32, torch.int64)
          and group_sizes.shape == (E,), "group_sizes (E,) int32 or int64")
    _need(1 <= E <= MAX_GROUPS, f"at most {MAX_GROUPS} groups, got {E}")
    _need(tokens.is_contiguous() and w.is_contiguous()
          and group_sizes.is_contiguous(), "contiguous tensors")
    T, d = tokens.shape
    f = w.shape[2]
    if tokens.dtype == torch.bfloat16:
        _need(d % 8 == 0 and f % 8 == 0,
              f"bfloat16 needs d and f multiples of 8, got {d}, {f}")
        _need(tokens.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
              "bfloat16 needs 16-byte aligned tokens and w")
    out = torch.empty((T, f), dtype=tokens.dtype, device=dev)
    if T == 0:
        return out
    fn = build.function("moe_gmm", "grouped_matmul_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(DTYPE_CODES[tokens.dtype], tokens.data_ptr(), w.data_ptr(),
                group_sizes.data_ptr(),
                int(group_sizes.dtype == torch.int64), E, T, d, f,
                out.data_ptr(), stream)
    build.check("moe_gmm", rc)
    counter.launches += 1
    return out
