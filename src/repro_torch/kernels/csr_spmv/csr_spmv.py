"""The edge-order gather (D3 send gather) behind one wrapper.

On a CUDA tensor ``edge_gather`` launches the hand-written Hopper kernel
(``kernels/csrc/csr_spmv.cu``), which walks the edges in their own order
and needs no layout; on a CPU tensor it runs the plain gather
(``ref.edge_gather_ref``). Both are exact for every float, inf and NaN
included. ``counter.launches`` counts kernel launches. The reference's
row-blocked design and its host layout have no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmv.ref import edge_gather_ref

counter = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p]


def _need(cond: bool, what: str):
    if not cond:
        raise ValueError(f"edge_gather_cuda: {what}")


def edge_gather_cuda(values: torch.Tensor, flat_src: torch.Tensor,
                     edge_val: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Launch the kernel. values: (N, V) float32; flat_src: (E,) int32,
    -1 = invalid, else < N; edge_val: (E,) float32 or None. -> (E, V)
    float32 in edge order, every row written by the kernel (0.0 where the
    source is -1), on the current stream, not synchronised."""
    dev = values.device
    ts = [values, flat_src] + ([edge_val] if edge_val is not None else [])
    _need(dev.type == "cuda" and all(t.device == dev for t in ts),
          "all tensors on one CUDA device")
    _need(values.dtype == torch.float32 and flat_src.dtype == torch.int32
          and (edge_val is None or edge_val.dtype == torch.float32),
          "values/edge_val float32, flat_src int32")
    _need(all(t.is_contiguous() for t in ts), "contiguous tensors")
    _need(values.dim() == 2 and flat_src.dim() == 1,
          "1-D flat_src, 2-D values")
    N, V = values.shape
    E = flat_src.shape[0]
    _need(edge_val is None or edge_val.shape == (E,), "edge_val shape")
    _need(V >= 1, f"V={V}")
    out = torch.empty((E, V), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    fn = build.function("csr_spmv", "edge_gather_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(values.data_ptr(), V, flat_src.data_ptr(),
                edge_val.data_ptr() if edge_val is not None else None, E,
                out.data_ptr(), stream)
    build.check("csr_spmv", rc)
    counter.launches += 1
    return out


def edge_gather(values: torch.Tensor, flat_src: torch.Tensor,
                edge_val: Optional[torch.Tensor] = None) -> torch.Tensor:
    """values: (N, V); flat_src: (E,) int32, -1 = invalid; edge_val: (E,)
    or None. -> (E, V); invalid edges read 0.0. The kernel on CUDA
    tensors, the plain gather on CPU (and data-less meta) tensors."""
    dev = values.device
    if dev.type in ("cpu", "meta"):     # meta: the operator counter's probe
        return edge_gather_ref(values, flat_src, edge_val)
    if dev.type != "cuda":
        raise ValueError(f"edge_gather: no kernel for device {dev}")
    return edge_gather_cuda(values.contiguous(), flat_src.contiguous(),
                            edge_val)
