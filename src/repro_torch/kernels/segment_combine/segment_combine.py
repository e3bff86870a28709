"""The segmented combine (D7 sender fold) behind one wrapper.

On a CUDA tensor ``segment_combine`` launches the hand-written Hopper
kernel (``kernels/csrc/segment_combine.cu``); on a CPU tensor it runs the
plain replay of the same schedule (``ref.segment_combine_blocked``). Both
give the reference's ``segment_combine_blocked`` bits, float sums
included. ``counter.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_combine.ref import (INT32_MAX, IDENT,
                                                     segment_combine_blocked,
                                                     segment_lasts)

OP_CODES = {"sum": 0, "min": 1, "max": 2}
MAX_BLOCK_M = 512

counter = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 8)


def segment_combine_cuda(seg2: torch.Tensor, pay: torch.Tensor, op: str,
                         block_m: int) -> torch.Tensor:
    """Launch the kernel. seg2: (M,) int32 with invalid rows already int32
    max; pay: (M, D) float32 with invalid rows already the identity.
    -> folded (M, D) float32, on the current stream, not synchronised."""
    if op not in OP_CODES:
        raise ValueError(f"op={op!r}: expected one of {tuple(OP_CODES)}")
    if seg2.device.type != "cuda" or pay.device != seg2.device:
        raise ValueError("segment_combine_cuda needs CUDA tensors on one "
                         "device")
    if seg2.dtype != torch.int32 or pay.dtype != torch.float32:
        raise TypeError("segment_combine_cuda: seg2 int32, pay float32")
    if seg2.dim() != 1 or pay.dim() != 2 or pay.shape[0] != seg2.shape[0]:
        raise ValueError(f"bad shapes {tuple(seg2.shape)}, "
                         f"{tuple(pay.shape)}")
    if not (seg2.is_contiguous() and pay.is_contiguous()):
        raise ValueError("segment_combine_cuda needs contiguous tensors")
    M, D = pay.shape
    if M == 0 or D == 0 or not 1 <= block_m <= MAX_BLOCK_M:
        raise ValueError(f"M={M}, D={D}, block_m={block_m}")
    BM = min(block_m, M)
    n_tiles = -(-M // BM)
    ints = lambda: torch.empty(n_tiles, dtype=torch.int32,
                               device=seg2.device)
    floats = lambda: torch.empty((n_tiles, D), dtype=torch.float32,
                                 device=seg2.device)
    out = torch.empty((M, D), dtype=torch.float32, device=seg2.device)
    seg_first, seg_last, first_len, carry_seg = ints(), ints(), ints(), \
        ints()
    last_val, carry_val = floats(), floats()
    fn = build.function("segment_combine", "segment_combine_launch",
                        _ARGTYPES)
    stream = torch.cuda.current_stream(seg2.device).cuda_stream
    with torch.cuda.device(seg2.device):
        rc = fn(seg2.data_ptr(), pay.data_ptr(), M, D, BM, OP_CODES[op],
                out.data_ptr(), seg_first.data_ptr(), seg_last.data_ptr(),
                first_len.data_ptr(), last_val.data_ptr(),
                carry_seg.data_ptr(), carry_val.data_ptr(), stream)
    build.check("segment_combine", rc)
    counter.launches += 1
    return out


def segment_combine(seg_ids: torch.Tensor, payload: torch.Tensor,
                    valid: torch.Tensor, op: str = "sum", *,
                    block_m: int = 512):
    """seg_ids: (M,) sorted int32; payload: (M, D); valid: (M,) with
    invalid rows sorted to the tail. -> (folded (M, D), is_last (M,)).
    The port of segment_combine_pallas: the kernel on CUDA tensors, its
    plain replay on CPU tensors."""
    dev = payload.device
    if dev.type == "cpu":
        return segment_combine_blocked(seg_ids, payload, valid, op,
                                       block_m=block_m)
    if dev.type != "cuda":
        raise ValueError(f"segment_combine: no kernel for device {dev}")
    seg2 = torch.where(valid, seg_ids, INT32_MAX).to(torch.int32)
    pay = torch.where(valid[:, None], payload,
                      IDENT[op]).to(torch.float32).contiguous()
    folded = segment_combine_cuda(seg2.contiguous(), pay, op, block_m)
    return folded, segment_lasts(seg2, valid)
