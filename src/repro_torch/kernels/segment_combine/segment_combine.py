"""The segmented combine (D7 sender fold) behind one wrapper.

On a CUDA tensor ``segment_combine`` launches the hand-written Hopper
kernel (``kernels/csrc/segment_combine.cu``), one launch over every
partition stream; on a CPU tensor it runs the plain replay of the same
schedule (``ref.segment_combine_blocked``, once per partition). Both
give the reference's ``segment_combine_blocked`` bits, float sums
included. On a ``meta`` tensor (shapes only: the operator counter's
probe, ``launch/op_cost.py``) it returns outputs of the right shapes and
dtypes without running and charges the counter the kernel's own
traffic. ``counter.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_combine.ref import segment_combine_blocked

OP_CODES = {"sum": 0, "min": 1, "max": 2}
MAX_BLOCK_M = 512
MAX_D = 4
EPOCHS = 1 << 30          # the kernel tags a tile's status word with these

counter = build.LaunchCounter()
# the operator counter's by_op key of the fold on meta tensors
META_OP = "repro_torch.segment_combine"

_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 3
             + [ctypes.c_ulonglong, ctypes.c_uint]
             + [ctypes.c_void_p] * 2)


class _Scratch:
    """The look-back's scratch for one (device, stream): a ticket counter
    and 64-bit words (status, tagged with the launch's epoch, and a
    value), one a tile and payload column and one a partition for its
    invalid tail. Zeroed once when allocated; every launch then takes a
    new epoch (words of older launches never match it) and the ticket's
    next range, so no launch clears anything. Launches that share it run
    in order on its stream; the sort group-by's fold (``sort_fold_dense``)
    takes the same scratch."""

    def __init__(self, device, n_words: int):
        self.n_words = n_words
        self.ticket = torch.zeros(1, dtype=torch.int64, device=device)
        self.words = torch.zeros(n_words, dtype=torch.int64, device=device)
        self.tickets = 0          # the ticket counter's value on the card
        self.epoch = 0


_scratch: dict = {}


def _scratch_for(device, stream: int, n_words: int) -> _Scratch:
    key = (device, stream)
    s = _scratch.get(key)
    if s is None or s.n_words < n_words:
        s = _Scratch(device, n_words)
        _scratch[key] = s
    s.epoch += 1
    if s.epoch == EPOCHS:         # every 2**30 launches: clear, restart
        s.words.zero_()
        s.epoch = 1
    return s


def segment_combine_cuda(keys: torch.Tensor, payload: torch.Tensor,
                         valid: torch.Tensor, op: str, block_m: int):
    """Launch the kernel on (P, M) streams. keys: (P, M) int32, each row
    sorted with its invalid rows at the tail (a valid row after an
    invalid one makes the kernel trap, a CUDA launch failure); payload:
    (P, M, D) float32, D <= 4; valid: (P, M) bool; all contiguous on one
    CUDA device.
    -> (folded (P, M, D) float32, is_last (P, M) bool), on the current
    stream, not synchronised. Nothing but the outputs (and, the first
    time, the scratch) is allocated; no other op runs."""
    if op not in OP_CODES:
        raise ValueError(f"op={op!r}: expected one of {tuple(OP_CODES)}")
    dev = keys.device
    if dev.type != "cuda" or payload.device != dev or valid.device != dev:
        raise ValueError("segment_combine_cuda needs CUDA tensors on one "
                         "device")
    if keys.dtype != torch.int32 or payload.dtype != torch.float32 or \
            valid.dtype != torch.bool:
        raise TypeError("segment_combine_cuda: keys int32, payload float32, "
                        "valid bool")
    if keys.dim() != 2 or payload.dim() != 3 or \
            payload.shape[:2] != keys.shape or valid.shape != keys.shape:
        raise ValueError(f"bad shapes {tuple(keys.shape)}, "
                         f"{tuple(payload.shape)}, {tuple(valid.shape)}")
    if not (keys.is_contiguous() and payload.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("segment_combine_cuda needs contiguous tensors")
    P, M, D = payload.shape
    if P == 0 or M == 0 or not 1 <= D <= MAX_D or \
            not 1 <= block_m <= MAX_BLOCK_M:
        raise ValueError(f"P={P}, M={M}, D={D}, block_m={block_m}")
    BM = min(block_m, M)
    n_tiles = P * -(-M // BM)
    out = torch.empty((P, M, D), dtype=torch.float32, device=dev)
    is_last = torch.empty((P, M), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s = _scratch_for(dev, stream, n_tiles * D + P)
    fn = build.function("segment_combine", "segment_combine_launch",
                        _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), payload.data_ptr(), valid.data_ptr(), P,
                M, D, BM, OP_CODES[op], out.data_ptr(), is_last.data_ptr(),
                s.ticket.data_ptr(), s.tickets, s.epoch, s.words.data_ptr(),
                stream)
    build.check("segment_combine", rc)
    s.tickets += n_tiles
    counter.launches += 1
    return out, is_last


def segment_combine_meta(keys: torch.Tensor, payload: torch.Tensor,
                         valid: torch.Tensor, op: str):
    """The fold on ``meta`` tensors: (folded (P, M, D) float32, is_last
    (P, M) bool) with no data, and one call of ``META_OP`` charged to
    the running operator counter: keys, payload and valid read once,
    folded and is_last written once (the bound column's byte count) and
    one combine an element of the payload."""
    from repro_torch.launch import op_cost
    if op not in OP_CODES:
        raise ValueError(f"op={op!r}: expected one of {tuple(OP_CODES)}")
    P, M, D = payload.shape
    folded = torch.empty((P, M, D), dtype=torch.float32, device="meta")
    is_last = torch.empty((P, M), dtype=torch.bool, device="meta")
    io = sum(t.numel() * t.element_size()
             for t in (keys, payload, valid, folded, is_last))
    op_cost.charge(META_OP, float(io), float(P * M * D))
    return folded, is_last


def segment_combine(seg_ids: torch.Tensor, payload: torch.Tensor,
                    valid: torch.Tensor, op: str = "sum", *,
                    block_m: int = 512):
    """seg_ids: (P, M) int32, each partition's stream sorted with its
    invalid rows at the tail; payload: (P, M, D); valid: (P, M).
    -> (folded (P, M, D), is_last (P, M)), every partition folded on its
    own. A 1-D call ((M,), (M, D), (M,)) is P = 1 and returns (M, D),
    (M,). The port of segment_combine_pallas: one kernel launch for all
    partitions on CUDA tensors, the plain replay on CPU tensors, the
    shapes alone on meta tensors."""
    one = seg_ids.dim() == 1
    if one:
        seg_ids, payload, valid = seg_ids[None], payload[None], valid[None]
    dev = payload.device
    if dev.type == "cpu":
        outs = [segment_combine_blocked(seg_ids[p], payload[p], valid[p],
                                        op, block_m=block_m)
                for p in range(seg_ids.shape[0])]
        folded = torch.stack([o[0] for o in outs])
        is_last = torch.stack([o[1] for o in outs])
    elif dev.type == "cuda":
        folded, is_last = segment_combine_cuda(seg_ids, payload, valid, op,
                                               block_m)
    elif dev.type == "meta":
        folded, is_last = segment_combine_meta(seg_ids, payload, valid, op)
    else:
        raise ValueError(f"segment_combine: no kernel for device {dev}")
    return (folded[0], is_last[0]) if one else (folded, is_last)
