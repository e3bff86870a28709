"""Parameter shapes, their initialisation, and the weight carry-across.

Every layer declares its parameters as a nested dict of ``Spec`` leaves
(shape + initializer + placement), as the JAX package does. A
placement is the port's counterpart of a ``PartitionSpec``: a tuple
with one entry per dimension, each ``None`` (replicated), a mesh axis
name, or a tuple of axis names; ``placements`` gives the tree of them
and ``launch/specs.py`` turns them into DTensor placements for the
production dry run. ``materialize`` and the weight carry-across ignore
them (the card path runs on one device). ``materialize`` turns the tree into a ``ParamTree`` (an
``nn.Module`` whose attributes carry the JAX names, so its
``state_dict`` keys read ``stages.0.sub0.attn.wq``) from an explicit
``torch.Generator`` on an explicit device. ``params_from_numpy`` builds
the same module from the JAX parameter tree as numpy arrays, and
``opt_state_from_numpy`` the optimizer state from the JAX ``{"step",
"m", "v"}`` tree, so the tests hand both packages the same weights and
the same state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

# a leaf above this many bytes in float32 is drawn a block of leading
# slices at a time (each block at most this size; a slice larger than
# that cut the same way), so the full model never holds a float32 copy
# of its experts or embedding
_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    init: str = "normal"          # normal|zeros|ones|ssm_a_log|ssm_dt_bias
    fan_in: Optional[int] = None
    dtype: Optional[torch.dtype] = None  # overrides the model dtype
    placement: tuple = ()         # a mesh axis (or axes, or None) a dim


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def tree_map_specs(f, tree):
    """``f`` applied to every Spec of a nested dict / list of Specs."""
    if is_spec(tree):
        return f(tree)
    if isinstance(tree, list):
        return [tree_map_specs(f, t) for t in tree]
    return {k: tree_map_specs(f, v) for k, v in tree.items()}


def full_placement(s: Spec) -> list:
    """``s.placement`` padded with ``None`` to one entry a dimension."""
    return list(s.placement) + [None] * (len(s.shape) - len(s.placement))


def placements(tree):
    """The tree of placements (the JAX package's ``pspecs``)."""
    return tree_map_specs(lambda s: tuple(full_placement(s)), tree)


# production mesh axis sizes (fixed: 16x16 single-pod, 2x16x16 multi-pod),
# as the JAX package's: a placement must divide its dimension, so every
# Spec is sanitized against these before use
AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _axes_size(entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= AXIS_SIZES[a]
        return n
    return AXIS_SIZES[entry]


def sanitize(tree):
    """Fix Specs whose sharded dims aren't divisible by the mesh axis: move
    the axis to the largest divisible unsharded dim, else drop it."""
    def fix(s: Spec) -> Spec:
        spec = full_placement(s)
        changed = False
        big = math.prod(s.shape) * 2 >= (64 << 20)
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            if s.shape[i] % _axes_size(entry) == 0:
                continue
            spec[i] = None
            changed = True
            if not big:
                continue  # small tensor: replicate (avoids psum chatter)
            # large tensor: relocate to the largest unsharded divisible dim
            for j in sorted(range(len(s.shape)), key=lambda k: -s.shape[k]):
                if spec[j] is None and s.shape[j] % _axes_size(entry) == 0 \
                        and s.shape[j] > 1:
                    spec[j] = entry
                    break
        if not changed:
            return s
        return dataclasses.replace(s, placement=tuple(spec))

    return tree_map_specs(fix, tree)


def stack(tree, n: int):
    """Prepend a layer axis of size n (replicated) to every Spec."""
    return tree_map_specs(
        lambda s: dataclasses.replace(
            s, shape=(n,) + tuple(s.shape),
            placement=(None,) + tuple(s.placement)), tree)


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: ``tree["attn"]["wq"]``
    and ``tree.attn.wq`` name the same tensor. Parameters are made with
    ``requires_grad=False`` (serving runs under ``torch.no_grad()``
    anyway); the trainer turns gradients on with the module's own
    ``requires_grad_(True)``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(ParamTree(s) for s in v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def layer_views(tree: ParamTree) -> list:
    """Every layer of a stacked stage: a list of nested dicts of the views
    ``t.unbind(0)`` gives (layer i's ``t[i]``). Under autograd one
    backward node a leaf stacks the layers' gradients, where ``t[i]``
    taken a layer at a time would each write a full-size zero gradient
    to be summed. A sharded model's gathering view of a stage
    (``models/sharded.py``) gives its own."""
    if not isinstance(tree, ParamTree):
        return tree.layer_views()
    parts = {k: v.unbind(0) for k, v in tree._parameters.items()}
    parts.update({k: layer_views(m) for k, m in tree._modules.items()})
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _pieces(t: torch.Tensor) -> list:
    """``t`` cut along its leading axes into views of at most
    _CHUNK_BYTES in float32 (as many leading rows as fit; a row larger
    than that cut the same way)."""
    if t.numel() * 4 <= _CHUNK_BYTES or t.dim() == 0:
        return [t]
    row = t[0].numel()
    if row * 4 > _CHUNK_BYTES:
        return [p for r in t for p in _pieces(r)]
    return list(t.split(_CHUNK_BYTES // (4 * row)))


def _init_leaf(spec: Spec, gen: torch.Generator, device,
               dtype: torch.dtype) -> torch.Tensor:
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "ssm_a_log":
        # mamba: A = -(1 .. N) along the last axis, stored as its log
        n = spec.shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(spec.shape).to(dt).contiguous()
    if spec.init == "ssm_dt_bias":
        # dt = exp(U[log 1e-3, log 1e-1]), stored through softplus^-1
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device)
        dtv = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                               - math.log(1e-3)))
        return (dtv + torch.log(-torch.expm1(-dtv))).to(dt)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    fan = spec.fan_in or (spec.shape[0] if spec.shape else 1)
    scale = 1.0 / math.sqrt(max(fan, 1))
    out = torch.empty(spec.shape, dtype=dt, device=device)
    for piece in _pieces(out):
        piece.copy_(torch.randn(piece.shape, generator=gen,
                                dtype=torch.float32, device=device) * scale)
    return out


def _materialize(tree, gen, device, dtype):
    if is_spec(tree):
        return _init_leaf(tree, gen, device, dtype)
    if isinstance(tree, list):
        return [_materialize(t, gen, device, dtype) for t in tree]
    return {k: _materialize(v, gen, device, dtype) for k, v in tree.items()}


def materialize(tree, gen: torch.Generator, device,
                dtype: torch.dtype) -> ParamTree:
    """Real parameters, drawn from ``gen`` (a generator on ``device``):
    normal leaves are N(0, 1) / sqrt(fan_in) in float32, cast to their
    dtype. The numbers differ from jax.random's for the same seed."""
    return ParamTree(_materialize(tree, gen, device, dtype))


def to_tensor(a, device) -> torch.Tensor:
    """A copy of a numpy array (bfloat16 from ml_dtypes included) as a
    tensor."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def tree_from_numpy(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return to_tensor(tree, device)


def _check_against(specs, tree, path="params"):
    if is_spec(specs):
        shape = tuple(np.shape(tree))
        if shape != tuple(specs.shape):
            raise ValueError(f"{path}: shape {shape}, expected "
                             f"{tuple(specs.shape)}")
        return
    if isinstance(specs, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(specs):
            raise ValueError(f"{path}: expected a list of {len(specs)}")
        for i, (s, t) in enumerate(zip(specs, tree)):
            _check_against(s, t, f"{path}[{i}]")
        return
    if not isinstance(tree, dict) or set(tree) != set(specs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"{path}: keys {got}, expected {sorted(specs)}")
    for k in specs:
        _check_against(specs[k], tree[k], f"{path}.{k}")


def params_from_numpy(cfg, tree, device="cuda") -> ParamTree:
    """The JAX package's parameter tree for ``cfg`` as numpy arrays
    (``{"embed", "final_norm", "stages": [{"sub0": {...}}]}``, each stage
    stacked on a leading layer axis; an audio model's ``embed`` holds
    only ``unembed``, a vision model adds ``vision_proj.w``) -> the
    port's parameters with the same values, on ``device``. Raises if a
    name or shape differs from the port's own tree."""
    from repro_torch.models.model import model_specs
    _check_against(model_specs(cfg), tree)
    return ParamTree(tree_from_numpy(tree, device))


def opt_state_from_numpy(cfg, state, device="cuda") -> dict:
    """The JAX package's AdamW state ``{"step", "m", "v"}`` as numpy
    arrays (moments shaped like ``cfg``'s parameters) -> the port's
    (``optim.adamw_init``'s layout: an int32 step, nested dicts and
    lists of moments), on ``device``."""
    from repro_torch.models.model import model_specs
    for k in ("m", "v"):
        _check_against(model_specs(cfg), state[k], f"opt.{k}")
    out = tree_from_numpy({k: state[k] for k in ("m", "v")}, device)
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out
