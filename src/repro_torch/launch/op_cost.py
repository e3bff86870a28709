"""Operator cost counter — the port's counterpart of the reference's
HLO analyzer (``repro.launch.hlo_cost``) and of XLA's
``compiled.memory_analysis()``. There is no HLO to read, so this counts
what the plain superstep executes: a ``TorchDispatchMode`` sees every
aten and c10d operator a function dispatches and adds up

* bytes: every tensor the operator reads and every tensor it writes
  (an in-place operator reads and writes its first argument), once per
  call — eager execution fuses nothing, so this is each operator's own
  traffic;
* flops: matrix products 2·m·n·k; every other operator one flop per
  element of the largest tensor it touches (an elementwise count);
  collectives none;
* collective bytes: the reference's ring formulas over a group of g
  ranks — ``all_to_all_single`` (``c10d.alltoall_base_``) bytes ×
  (g−1)/g, ``all_reduce`` (``c10d.allreduce_``) 2 × bytes × (g−1)/g —
  into ``coll_bytes`` and ``coll_detail`` ("all-to-all", "all-reduce");
* memory: ``argument_bytes``, the bytes of the function's inputs, and
  ``peak_temp_bytes``, the peak of the bytes that operator outputs hold
  alive beyond them. Every output storage not seen before counts from
  its operator until it is freed; views and in-place results share a
  storage and add nothing. This is eager's peak, with no fusion and no
  buffer reuse: it is not XLA's ``temp_size_in_bytes``.

Views, aliases and allocations without a fill move no bytes and are not
counted as traffic. Run on ``meta`` tensors (shapes and dtypes only),
the count needs no data and no device — the counterpart of lowering a
superstep of ``ShapeDtypeStruct``s. Every operator of the plain
superstep has a meta kernel; on ``meta`` the gather runs its plain
version, and the fold returns its outputs' shapes without running and
charges its own traffic through ``charge`` (keys, payload and valid read
once, folded and is_last written once), one ``by_op`` entry.
"""
from __future__ import annotations

import dataclasses
import weakref
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
# c10d operator -> (its coll_detail key, the index of its process group
# argument, the ring factor on the bytes it sends)
_COLLECTIVES = {"c10d.alltoall_base_.default": ("all-to-all", 2, 1.0),
                "c10d.allreduce_.default": ("all-reduce", 1, 2.0)}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    by_op: dict = field(default_factory=dict)   # op -> [calls, bytes]
    coll_bytes: float = 0.0
    coll_detail: dict = field(default_factory=dict)  # kind -> bytes
    argument_bytes: int = 0
    peak_temp_bytes: int = 0


def _tensors(tree):
    """The tensors of a pytree whose nodes may also be dataclasses (the
    engine's relations)."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out += _tensors([getattr(x, f.name)
                             for f in dataclasses.fields(x)])
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def nbytes(tree) -> int:
    """The bytes of the tensors of ``tree`` (dataclasses included)."""
    return _nbytes(_tensors(tree))


def _matmul_flops(func, args) -> float:
    a, b = (args[1], args[2]) if func in (_aten.addmm.default,
                                          _aten.baddbmm.default) \
        else (args[0], args[1])
    # (..., m, k) @ (..., k, n): 2 m n k per batch entry
    return 2.0 * a.numel() * b.shape[-1]


def _group_size(pg) -> int:
    import torch.distributed as dist
    return dist.ProcessGroup.unbox(pg).size()


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost, arguments=()):
        super().__init__()
        self.cost = cost
        # storages the counter has seen: the arguments' (never counted)
        # and each operator output's, live until freed
        self._args = [t.untyped_storage() for t in arguments]
        self._seen = {id(s) for s in self._args}
        self._live = 0

    def _freed(self, key: int, nbytes: int):
        self._seen.discard(key)
        self._live -= nbytes

    def _track(self, outs):
        for t in outs:
            s = t.untyped_storage()
            if id(s) in self._seen:
                continue
            n = s.nbytes()
            self._seen.add(id(s))
            self._live += n
            weakref.finalize(s, self._freed, id(s), n)
        self.cost.peak_temp_bytes = max(self.cost.peak_temp_bytes,
                                        self._live)

    def charge(self, name: str, nbytes: float, flops: float = 0.0):
        self.cost.bytes += nbytes
        self.cost.flops += flops
        calls = self.cost.by_op.setdefault(name, [0, 0.0])
        calls[0] += 1
        calls[1] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(outs)
        if func in _FREE or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        nbytes = float(_nbytes(ins + outs))
        coll = _COLLECTIVES.get(str(func))
        if coll is not None:
            kind, pg_at, ring = coll
            g = _group_size(args[pg_at])
            sent = (_nbytes([args[1]]) if kind == "all-to-all"
                    else _nbytes(args[0]))
            cb = ring * sent * (g - 1) / g
            self.cost.coll_bytes += cb
            self.cost.coll_detail[kind] = \
                self.cost.coll_detail.get(kind, 0.0) + cb
            flops = 0.0
        elif func in _MATMULS:
            flops = _matmul_flops(func, args)
        else:
            flops = float(max((t.numel() for t in ins + outs), default=0))
        self.charge(str(func), nbytes, flops)
        return out


_active: list = []


def charge(name: str, nbytes: float, flops: float = 0.0) -> None:
    """Add an operator that dispatches no aten operator of its own (the
    fold's meta route) to the innermost running counter, as one call of
    ``name``; nothing when no counter runs."""
    if _active:
        _active[-1].charge(name, nbytes, flops)


def measure(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under the counter -> its ``Cost``."""
    ins = _tensors((args, kwargs))
    cost = Cost(argument_bytes=nbytes(ins))
    counter = _Counter(cost, ins)
    _active.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
            del out
    finally:
        _active.pop()
    return cost
