"""The scatter group-by (D1 receiver combine) behind one wrapper.

On a CUDA tensor ``scatter_combine`` launches the hand-written Hopper
kernel (``kernels/csrc/scatter_combine.cu``): each valid row folded into
its dense slot by an atomic, invalid rows and slots outside [0, Np)
dropped, no sink row. On a CPU tensor, and on a ``meta`` tensor (shapes
only: the operator counter's probe, ``launch/op_cost.py``), it runs the
plain scatter chain (``ref.scatter_combine_ref``). The two agree in
``has`` and in min and max bit for bit, and in sums to rounding (the
atomics add in no fixed order). ``counter.launches`` counts kernel
calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scatter_combine.ref import scatter_combine_ref

OP_CODES = {"sum": 0, "min": 1, "max": 2}
MAX_D = 4
MAX_P = 65535            # partitions ride the grid's y dimension
INT32_MAX = 2 ** 31 - 1

counter = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
             + [ctypes.c_void_p] * 3)


def scatter_combine_cuda(slot: torch.Tensor, payload: torch.Tensor,
                         valid: torch.Tensor, Np: int, op: str):
    """Launch the kernel. slot: (P, M) int32; payload: (P, M, D) float32,
    D <= 4; valid: (P, M) bool; all contiguous on one CUDA device.
    -> (dense (P, Np, D) float32, the identity where no valid row
    arrived; has (P, Np) bool), on the current stream, not
    synchronised. Nothing but the two outputs is allocated."""
    if op not in OP_CODES:
        raise ValueError(f"op={op!r}: expected one of {tuple(OP_CODES)}")
    dev = payload.device
    if dev.type != "cuda" or slot.device != dev or valid.device != dev:
        raise ValueError("scatter_combine_cuda needs CUDA tensors on one "
                         "device")
    if slot.dtype != torch.int32 or payload.dtype != torch.float32 or \
            valid.dtype != torch.bool:
        raise TypeError("scatter_combine_cuda: slot int32, payload float32, "
                        "valid bool")
    if slot.dim() != 2 or payload.dim() != 3 or \
            payload.shape[:2] != slot.shape or valid.shape != slot.shape:
        raise ValueError(f"bad shapes {tuple(slot.shape)}, "
                         f"{tuple(payload.shape)}, {tuple(valid.shape)}")
    if not (slot.is_contiguous() and payload.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("scatter_combine_cuda needs contiguous tensors")
    P, M, D = payload.shape
    if P > MAX_P or not 1 <= D <= MAX_D or not 0 <= Np <= INT32_MAX:
        raise ValueError(f"P={P}, D={D}, Np={Np}")
    dense = torch.empty((P, Np, D), dtype=torch.float32, device=dev)
    has = torch.empty((P, Np), dtype=torch.bool, device=dev)
    fn = build.function("scatter_combine", "scatter_combine_launch",
                        _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(slot.data_ptr(), payload.data_ptr(), valid.data_ptr(), P, M,
                D, Np, OP_CODES[op], dense.data_ptr(), has.data_ptr(),
                stream)
    build.check("scatter_combine", rc)
    counter.launches += 1
    return dense, has


def scatter_combine(slot: torch.Tensor, payload: torch.Tensor,
                    valid: torch.Tensor, Np: int, op: str):
    """slot: (P, M) int (int32 on CUDA); payload: (P, M, D); valid: (P,
    M). -> (dense (P, Np, D), has (P, Np)): per partition, the op's fold
    of the valid rows' payloads by slot (the identity where none
    arrived) and whether any arrived. The kernel on CUDA tensors, the
    plain chain on CPU and meta tensors."""
    dev = payload.device
    if dev.type in ("cpu", "meta"):
        return scatter_combine_ref(slot, payload, valid, Np, op)
    if dev.type != "cuda":
        raise ValueError(f"scatter_combine: no kernel for device {dev}")
    return scatter_combine_cuda(slot.contiguous(), payload.contiguous(),
                                valid.contiguous(), Np, op)
