"""Operator cost counter — the port's counterpart of the reference's
HLO analyzer (``repro.launch.hlo_cost``). There is no HLO to read, so
this counts what the plain superstep executes: a ``TorchDispatchMode``
sees every aten operator a function dispatches and adds up

* bytes: every tensor the operator reads and every tensor it writes
  (an in-place operator reads and writes its first argument), once per
  call — eager execution fuses nothing, so this is each operator's own
  traffic;
* flops: matrix products 2·m·n·k; every other operator one flop per
  element of the largest tensor it touches (an elementwise count).

Views, aliases and allocations without a fill move no bytes and are not
counted. Run on ``meta`` tensors (shapes and dtypes only), the count
needs no data and no device — the counterpart of lowering a superstep of
``ShapeDtypeStruct``s. Every operator of the plain superstep has a meta
kernel; the fold and the gather treat ``meta`` as the plain path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_aten = torch.ops.aten
# operators that allocate or re-describe memory without moving bytes
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.detach.default,
         _aten.lift_fresh.default}
_MATMULS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
            _aten.baddbmm.default}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    by_op: dict = field(default_factory=dict)   # aten op -> [calls, bytes]


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _matmul_flops(func, args) -> float:
    a, b = (args[1], args[2]) if func in (_aten.addmm.default,
                                          _aten.baddbmm.default) \
        else (args[0], args[1])
    # (..., m, k) @ (..., k, n): 2 m n k per batch entry
    return 2.0 * a.numel() * b.shape[-1]


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _FREE or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        nbytes = float(sum(t.numel() * t.element_size()
                           for t in ins + outs))
        if func in _MATMULS:
            flops = _matmul_flops(func, args)
        else:
            flops = float(max((t.numel() for t in ins + outs), default=0))
        self.cost.bytes += nbytes
        self.cost.flops += flops
        calls = self.cost.by_op.setdefault(str(func), [0, 0.0])
        calls[0] += 1
        calls[1] += nbytes
        return out


def measure(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under the counter -> its ``Cost``."""
    cost = Cost()
    with _Counter(cost):
        fn(*args, **kwargs)
    return cost
