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
  collectives none. ``matmul_flops`` keeps the matrix products'
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``) apart: what the reference's
  HLO analyzer counts as flops;
* collective bytes: the reference's ring formulas over a group of g
  ranks — all-to-all out × (g−1)/g, all-reduce 2 × out × (g−1)/g,
  all-gather out × (g−1)/g, reduce-scatter in × (g−1)/g — into
  ``coll_bytes`` and ``coll_detail`` ("all-to-all", "all-reduce",
  "all-gather", "reduce-scatter"), for c10d's operators
  (``alltoall_base_``, ``allreduce_``) and the functional collectives
  DTensor issues (``_c10d_functional.all_to_all_single``, ``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``);
* memory: ``argument_bytes``, the bytes of the function's inputs,
  ``output_bytes``, its outputs', and ``peak_temp_bytes``, the peak of
  the bytes that operator outputs hold alive beyond them. Every output
  storage not seen before counts from its operator until it is freed;
  views and in-place results share a storage and add nothing. This is
  eager's peak, with no fusion and no buffer reuse: it is not XLA's
  ``temp_size_in_bytes``.

A DTensor operator is counted at its local shards: the counter lets
DTensor run first (it returns ``NotImplemented`` to it), then sees the
local operators and the collectives DTensor's sharding propagation
issues, so every figure is rank 0's (the fake tensors DTensor infers
global shapes on are not counted). ``argument_bytes`` counts the
inputs' local shards, a module's parameters included.

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
from torch._subclasses.fake_tensor import FakeTensor
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
# argument, the ring factor, whether the factor scales the input's bytes
# (else the output's))
_COLLECTIVES = {
    "c10d.alltoall_base_.default": ("all-to-all", 2, 1.0, True),
    "c10d.allreduce_.default": ("all-reduce", 1, 2.0, True),
    "_c10d_functional.all_to_all_single.default":
        ("all-to-all", 3, 1.0, False),
    "_c10d_functional.all_reduce.default": ("all-reduce", 2, 2.0, False),
    "_c10d_functional.all_reduce_.default": ("all-reduce", 2, 2.0, False),
    "_c10d_functional.all_gather_into_tensor.default":
        ("all-gather", 2, 1.0, False),
    "_c10d_functional.reduce_scatter_tensor.default":
        ("reduce-scatter", 3, 1.0, True)}
# functional-collective bookkeeping that moves nothing
_FREE_NAMES = {"_c10d_functional.wait_tensor.default",
               "_c10d_functional._wrap_tensor_autograd.default"}


@dataclass
class Cost:
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    by_op: dict = field(default_factory=dict)   # op -> [calls, bytes]
    coll_bytes: float = 0.0
    coll_detail: dict = field(default_factory=dict)  # kind -> bytes
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_temp_bytes: int = 0


def _tensors(tree):
    """The tensors of a pytree whose nodes may also be dataclasses (the
    engine's relations) or modules (their parameters and buffers)."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out += list(x.parameters()) + list(x.buffers())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out += _tensors([getattr(x, f.name)
                             for f in dataclasses.fields(x)])
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _nbytes(ts) -> int:
    return sum(_local(t).numel() * _local(t).element_size() for t in ts)


def nbytes(tree) -> int:
    """The bytes of the tensors of ``tree`` (dataclasses and modules
    included), a DTensor's at its local shard."""
    return _nbytes(_tensors(tree))



def _matmul_flops(func, args) -> float:
    a, b = (args[1], args[2]) if func in (_aten.addmm.default,
                                          _aten.baddbmm.default) \
        else (args[0], args[1])
    # (..., m, k) @ (..., k, n): 2 m n k per batch entry
    return 2.0 * a.numel() * b.shape[-1]


def _group_size(pg) -> int:
    import torch.distributed as dist
    if isinstance(pg, str):        # a functional collective's group name
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(pg).size()
    return dist.ProcessGroup.unbox(pg).size()


def _is_dtensor_call(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost, arguments=()):
        super().__init__()
        self.cost = cost
        # storages the counter has seen: the arguments' (never counted)
        # and each operator output's, live until freed
        self._args = [_local(t).untyped_storage() for t in arguments]
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

    def charge(self, name: str, nbytes: float, flops: float = 0.0,
               matmul: bool = False):
        self.cost.bytes += nbytes
        self.cost.flops += flops
        if matmul:
            self.cost.matmul_flops += flops
        calls = self.cost.by_op.setdefault(name, [0, 0.0])
        calls[0] += 1
        calls[1] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_call(types):
            # let DTensor propagate its sharding and run the local
            # operators and collectives, which this mode then sees
            return NotImplemented
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            # DTensor's sharding propagation infers an output's global
            # shape on fake tensors: no work of the step
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out
        self._track(outs)
        name = str(func)
        if func in _FREE or func.is_view or name in _FREE_NAMES:
            return out
        nbytes = float(_nbytes(ins + outs))
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            kind, pg_at, ring, of_input = coll
            g = _group_size(args[pg_at])
            if name.startswith("c10d."):
                sent = (_nbytes([args[1]]) if kind == "all-to-all"
                        else _nbytes(args[0]))
            else:
                sent = _nbytes(_tensors(args[0] if of_input else out))
            cb = ring * sent * (g - 1) / g
            self.cost.coll_bytes += cb
            self.cost.coll_detail[kind] = \
                self.cost.coll_detail.get(kind, 0.0) + cb
            flops = 0.0
        elif func in _MATMULS:
            flops = _matmul_flops(func, args)
            self.cost.matmul_flops += flops
        else:
            flops = float(max((t.numel() for t in ins + outs), default=0))
        self.charge(str(func), nbytes, flops)
        return out


_active: list = []


def charge(name: str, nbytes: float, flops: float = 0.0,
           matmul: bool = False) -> None:
    """Add an operator that dispatches no aten operator of its own (a
    kernel's meta route) to the innermost running counter, as one call
    of ``name`` (its flops also matrix-product flops when ``matmul``);
    nothing when no counter runs."""
    if _active:
        _active[-1].charge(name, nbytes, flops, matmul)


def uncounted():
    """A context in which no counter sees the operators run (shape-only
    bookkeeping of a meta route)."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


def measure(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under the counter -> its ``Cost``."""
    ins = _tensors((args, kwargs))
    cost = Cost(argument_bytes=nbytes(ins))
    counter = _Counter(cost, ins)
    _active.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
            cost.output_bytes = nbytes(out)
            del out
    finally:
        _active.pop()
    return cost
