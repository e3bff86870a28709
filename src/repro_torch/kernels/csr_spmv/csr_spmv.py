"""The row-blocked edge gather (D3 send gather) behind one wrapper.

On a CUDA tensor ``edge_gather`` launches the hand-written Hopper kernel
(``kernels/csrc/csr_spmv.cu``) over the host-planned layout of
``ops.plan_layout_fixed``; on a CPU tensor it runs the plain gather
(``ref.edge_gather_ref``). Both are exact for every float, inf and NaN
included. ``counter.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmv.ref import edge_gather_ref

counter = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def _need(cond: bool, what: str):
    if not cond:
        raise ValueError(f"edge_gather_cuda: {what}")


def edge_gather_cuda(values: torch.Tensor, flat_src: torch.Tensor,
                     edge_val: Optional[torch.Tensor], perm: torch.Tensor,
                     tile_row: torch.Tensor, *, block_m: int = 512,
                     block_r: int = 256) -> torch.Tensor:
    """Launch the kernel. values: (N, V) float32; flat_src: (E,) int32;
    edge_val: (E,) float32 or None; perm: (n_tiles * block_m,) int32;
    tile_row: (n_tiles,) int32. -> (E, V) float32 in edge order, on the
    current stream, not synchronised."""
    dev = values.device
    ts = [values, flat_src, perm, tile_row] + \
        ([edge_val] if edge_val is not None else [])
    _need(dev.type == "cuda" and all(t.device == dev for t in ts),
          "all tensors on one CUDA device")
    _need(values.dtype == torch.float32 and flat_src.dtype == torch.int32
          and perm.dtype == torch.int32 and tile_row.dtype == torch.int32
          and (edge_val is None or edge_val.dtype == torch.float32),
          "values/edge_val float32, flat_src/perm/tile_row int32")
    _need(all(t.is_contiguous() for t in ts), "contiguous tensors")
    _need(values.dim() == 2 and flat_src.dim() == 1 and perm.dim() == 1
          and tile_row.dim() == 1, "1-D indices, 2-D values")
    N, V = values.shape
    E = flat_src.shape[0]
    n_tiles = tile_row.shape[0]
    _need(edge_val is None or edge_val.shape == (E,), "edge_val shape")
    _need(perm.shape[0] == n_tiles * block_m, "perm != n_tiles * block_m")
    _need(1 <= V and block_r * V * 4 <= 48 * 1024, f"V={V} too wide")
    out = torch.zeros((E, V), dtype=torch.float32, device=dev)
    if n_tiles == 0 or E == 0:
        return out
    fn = build.function("csr_spmv", "edge_gather_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(values.data_ptr(), N, V, flat_src.data_ptr(),
                edge_val.data_ptr() if edge_val is not None else None,
                perm.data_ptr(), tile_row.data_ptr(), n_tiles, block_m,
                block_r, out.data_ptr(), stream)
    build.check("csr_spmv", rc)
    counter.launches += 1
    return out


def edge_gather(values: torch.Tensor, flat_src: torch.Tensor,
                edge_val: Optional[torch.Tensor],
                layout: Tuple[torch.Tensor, torch.Tensor], *,
                block_m: int = 512, block_r: int = 256) -> torch.Tensor:
    """values: (N, V); flat_src: (E,) int32, -1 = invalid; edge_val: (E,)
    or None; layout = (perm, tile_row) from ``ops.plan_layout_fixed`` over
    flat_src. -> (E, V); invalid edges read 0.0. The kernel on CUDA
    tensors, the plain gather on CPU tensors (which needs no layout)."""
    dev = values.device
    if dev.type == "cpu":
        return edge_gather_ref(values, flat_src, edge_val)
    if layout is None:
        raise ValueError("edge_gather: the kernel needs the layout "
                         "(perm, tile_row) of ops.plan_layout_fixed")
    if dev.type != "cuda":
        raise ValueError(f"edge_gather: no kernel for device {dev}")
    perm, tile_row = layout
    return edge_gather_cuda(values.contiguous(), flat_src.contiguous(),
                            edge_val, perm, tile_row, block_m=block_m,
                            block_r=block_r)
