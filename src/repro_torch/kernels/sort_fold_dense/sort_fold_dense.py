"""The sort group-by's fold into dense slots (D1) behind one wrapper.

On a CUDA tensor ``sort_fold_dense`` launches the hand-written Hopper
kernel (``kernels/csrc/sort_fold_dense.cu``): an identity fill of the
dense slots, then one pass over the sorted streams with the fold's
look-back, in which the last row of each run stores its folded value
into its slot; the dropped tail (invalid rows, slots outside [0, Np))
writes nothing and is not read past one id a tile. On a CPU tensor it
runs the plain version (``ref.sort_fold_dense_ref``), which replays the
same schedule: the two agree bit for bit, float sums included.
``counter.launches`` counts kernel calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_combine.segment_combine import _scratch_for
from repro_torch.kernels.sort_fold_dense.ref import sort_fold_dense_ref

OP_CODES = {"sum": 0, "min": 1, "max": 2}
MAX_D = 4
BLOCK_M = 512            # the tile of the blocked schedule
INT32_MAX = 2 ** 31 - 1

counter = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 3
             + [ctypes.c_ulonglong, ctypes.c_uint]
             + [ctypes.c_void_p] * 2)


def sort_fold_dense_cuda(keys: torch.Tensor, payload: torch.Tensor,
                         valid: torch.Tensor, Np: int, op: str):
    """Launch the kernel. keys: (P, M) int32, each row ascending with its
    invalid rows keyed int32 max at the tail (ids that do not ascend make
    the kernel trap, a CUDA launch failure); payload: (P, M, D) float32,
    D <= 4; valid: (P, M) bool; all contiguous on one CUDA device.
    -> (dense (P, Np, D) float32, the identity where no valid row
    arrived; has (P, Np) bool), on the current stream, not synchronised.
    Nothing but the two outputs (and, the first time, the look-back's
    scratch, shared with segment_combine on the stream) is allocated."""
    if op not in OP_CODES:
        raise ValueError(f"op={op!r}: expected one of {tuple(OP_CODES)}")
    dev = payload.device
    if dev.type != "cuda" or keys.device != dev or valid.device != dev:
        raise ValueError("sort_fold_dense_cuda needs CUDA tensors on one "
                         "device")
    if keys.dtype != torch.int32 or payload.dtype != torch.float32 or \
            valid.dtype != torch.bool:
        raise TypeError("sort_fold_dense_cuda: keys int32, payload float32, "
                        "valid bool")
    if keys.dim() != 2 or payload.dim() != 3 or \
            payload.shape[:2] != keys.shape or valid.shape != keys.shape:
        raise ValueError(f"bad shapes {tuple(keys.shape)}, "
                         f"{tuple(payload.shape)}, {tuple(valid.shape)}")
    if not (keys.is_contiguous() and payload.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("sort_fold_dense_cuda needs contiguous tensors")
    P, M, D = payload.shape
    if not 1 <= D <= MAX_D or not 0 <= Np < INT32_MAX:
        raise ValueError(f"P={P}, D={D}, Np={Np}")
    BM = max(min(BLOCK_M, M), 1)
    n_tiles = P * -(-M // BM)
    dense = torch.empty((P, Np, D), dtype=torch.float32, device=dev)
    has = torch.empty((P, Np), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s = _scratch_for(dev, stream, n_tiles * D + P)
    fn = build.function("sort_fold_dense", "sort_fold_dense_launch",
                        _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), payload.data_ptr(), valid.data_ptr(), P, M,
                D, BM, Np, OP_CODES[op], dense.data_ptr(), has.data_ptr(),
                s.ticket.data_ptr(), s.tickets, s.epoch, s.words.data_ptr(),
                stream)
    build.check("sort_fold_dense", rc)
    if P * Np and M:             # the fold ran and drew its tickets
        s.tickets += n_tiles
    counter.launches += 1
    return dense, has


def sort_fold_dense(keys: torch.Tensor, payload: torch.Tensor,
                    valid: torch.Tensor, Np: int, op: str):
    """keys: (P, M) int32, each stream ascending with its invalid rows
    keyed int32 max at the tail (``groupby._sort_rows``' output); payload:
    (P, M, D); valid: (P, M). -> (dense (P, Np, D), has (P, Np)): per
    stream, the op's fold of each run of valid rows into its slot (the
    identity where none arrived) and whether one arrived; slots outside
    [0, Np) dropped. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    dev = payload.device
    if dev.type == "cpu":
        return sort_fold_dense_ref(keys, payload, valid, Np, op)
    if dev.type != "cuda":
        raise ValueError(f"sort_fold_dense: no kernel for device {dev}")
    return sort_fold_dense_cuda(keys.contiguous(), payload.contiguous(),
                                valid.contiguous(), Np, op)
