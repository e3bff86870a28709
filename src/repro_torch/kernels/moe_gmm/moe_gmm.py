"""The expert-grouped matmul behind one wrapper.

``grouped_matmul_cuda`` launches the hand-written Hopper kernel
(``kernels/csrc/moe_gmm.cu``; tensor cores for bfloat16, a plain FMA
kernel for float32) over the tile map of ``ops.tile_map``: each entry
names one expert and up to ``TILE_M`` of its expert-sorted rows, which
the kernel reads and writes in place. ``ops.grouped_matmul`` is the
entry point the model calls; it runs the plain version on CPU tensors.
``counter.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE_M = 64            # rows a tile, fixed by the kernel
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def _need(cond: bool, what: str):
    if not cond:
        raise ValueError(f"grouped_matmul_cuda: {what}")


def grouped_matmul_cuda(tokens: torch.Tensor, w: torch.Tensor,
                        tiles: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. tokens: (T, d) expert-sorted; w: (E, d, f);
    tiles: (n, 3) int32 (expert, first row, row count <= TILE_M) from
    ``ops.tile_map``, covering every row once. -> (T, f) in tokens'
    dtype, on the current stream, not synchronised."""
    dev = tokens.device
    _need(dev.type == "cuda" and w.device == dev and tiles.device == dev,
          "all tensors on one CUDA device")
    _need(tokens.dtype in DTYPE_CODES and w.dtype == tokens.dtype,
          "tokens and w both float32 or both bfloat16")
    _need(tiles.dtype == torch.int32 and tiles.dim() == 2
          and tiles.shape[1] == 3, "tiles (n, 3) int32")
    _need(tokens.dim() == 2 and w.dim() == 3
          and w.shape[1] == tokens.shape[1], "tokens (T, d), w (E, d, f)")
    _need(tokens.is_contiguous() and w.is_contiguous()
          and tiles.is_contiguous(), "contiguous tensors")
    T, d = tokens.shape
    f = w.shape[2]
    if tokens.dtype == torch.bfloat16:
        _need(d % 8 == 0 and f % 8 == 0,
              f"bfloat16 needs d and f multiples of 8, got {d}, {f}")
    out = torch.empty((T, f), dtype=tokens.dtype, device=dev)
    if T == 0 or tiles.shape[0] == 0:
        return out
    fn = build.function("moe_gmm", "grouped_matmul_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(DTYPE_CODES[tokens.dtype], tokens.data_ptr(), w.data_ptr(),
                tiles.data_ptr(), tiles.shape[0], d, f, out.data_ptr(),
                stream)
    build.check("moe_gmm", rc)
    counter.launches += 1
    return out
