"""The connector's bucket pack behind one wrapper.

On a CUDA tensor ``bucket_pack`` launches the hand-written Hopper kernel
(``kernels/csrc/bucket_pack.cu``): a count of each tile's rows by owner,
a scan of those counts, a fill of each bucket's slots past its count,
and one pass that writes each kept row straight to its slot; no sort, no
sink slot, and an invalid row is read as its flag alone. On a CPU
tensor, and on a ``meta`` tensor (shapes only: the operator counter's
probe, ``launch/op_cost.py``), it runs the plain chain
(``ref.bucket_pack_ref``). The two agree bit for bit in all four
outputs. ``counter.launches`` counts kernel calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref

MAX_P = 4096             # the write pass keeps 8 warps x P counts in smem
MAX_S = 65535            # sources ride the grid's y dimension
TILE = 2048              # rows a tile of the count and write passes
INT32_MAX = 2 ** 31 - 1

counter = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 7)


def bucket_pack_cuda(dst: torch.Tensor, payload: torch.Tensor,
                     valid: torch.Tensor, P: int, bucket_cap: int, *,
                     partition: str = "hash", capacity: int = 0):
    """Launch the kernel. dst: (S, K) int32; payload: (S, K, D) of a dtype
    whose row is whole 4-byte words (float32 and int32 at any D); valid:
    (S, K) bool; all contiguous on one CUDA device. -> (b_dst (S, P, C)
    int32, b_payload (S, P, C, D), b_valid (S, P, C) bool, overflow (S,)
    int32), on the current stream, not synchronised. Besides the outputs
    it allocates the tiles' counts, (S, P, ceil(K / 2048)) int32, and
    each bucket's fill start."""
    if partition not in ("hash", "range"):
        raise ValueError(f"partition={partition!r}: expected hash or range")
    dev = dst.device
    if dev.type != "cuda" or payload.device != dev or valid.device != dev:
        raise ValueError("bucket_pack_cuda needs CUDA tensors on one device")
    if dst.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("bucket_pack_cuda: dst int32, valid bool")
    if dst.dim() != 2 or payload.dim() != 3 or \
            payload.shape[:2] != dst.shape or valid.shape != dst.shape:
        raise ValueError(f"bad shapes {tuple(dst.shape)}, "
                         f"{tuple(payload.shape)}, {tuple(valid.shape)}")
    if not (dst.is_contiguous() and payload.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("bucket_pack_cuda needs contiguous tensors")
    S, K, D = payload.shape
    row_bytes = D * payload.element_size()
    if row_bytes % 4:
        raise TypeError(f"bucket_pack_cuda: a payload row of {row_bytes} B "
                        "is not whole 4-byte words")
    if not 1 <= P <= MAX_P or S > MAX_S or not 0 <= bucket_cap <= INT32_MAX \
            or K > INT32_MAX or (partition == "range" and capacity < 1):
        raise ValueError(f"S={S}, K={K}, P={P}, bucket_cap={bucket_cap}, "
                         f"capacity={capacity}")
    C = bucket_cap
    W = row_bytes // 4
    b_dst = torch.empty((S, P, C), dtype=torch.int32, device=dev)
    b_pay = torch.empty((S, P, C, D), dtype=payload.dtype, device=dev)
    b_val = torch.empty((S, P, C), dtype=torch.bool, device=dev)
    overflow = torch.empty((S,), dtype=torch.int32, device=dev)
    counts = torch.empty((S, P, -(-K // TILE)), dtype=torch.int32,
                         device=dev)
    fill_from = torch.empty((S, P), dtype=torch.int32, device=dev)
    fn = build.function("bucket_pack", "bucket_pack_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(dst.data_ptr(), payload.data_ptr(), valid.data_ptr(), S, K,
                W, P, C, int(partition == "range"), capacity,
                b_dst.data_ptr(), b_pay.data_ptr(), b_val.data_ptr(),
                overflow.data_ptr(), counts.data_ptr(), fill_from.data_ptr(),
                stream)
    build.check("bucket_pack", rc)
    counter.launches += 1
    return b_dst, b_pay, b_val, overflow


def bucket_pack(dst: torch.Tensor, payload: torch.Tensor,
                valid: torch.Tensor, P: int, bucket_cap: int, *,
                partition: str = "hash", capacity: int = 0):
    """dst: (S, K) global vid; payload: (S, K, D); valid: (S, K). ->
    (b_dst (S, P, C) int32, b_payload (S, P, C, D), b_valid (S, P, C),
    overflow (S,) int32): per source row, each valid row in its owner's
    bucket (``dst % P``, or ``min(dst // capacity, P - 1)`` under range
    partitioning) at its rank among that owner's valid rows in input
    order; ranks from C on are counted in overflow; slots past a bucket's
    count hold -1, 0, False. The kernel on CUDA tensors, the plain chain
    on CPU and meta tensors."""
    dev = dst.device
    if dev.type in ("cpu", "meta"):
        return bucket_pack_ref(dst, payload, valid, P, bucket_cap,
                               partition=partition, capacity=capacity)
    if dev.type != "cuda":
        raise ValueError(f"bucket_pack: no kernel for device {dev}")
    return bucket_pack_cuda(dst.to(torch.int32).contiguous(),
                            payload.contiguous(), valid.contiguous(), P,
                            bucket_cap, partition=partition,
                            capacity=capacity)
