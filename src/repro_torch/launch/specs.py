"""Meta DTensor stand-ins for every model input of every (arch x shape)
cell: rank 0's shards of the production mesh, with no data and no
device. The port's counterpart of the JAX package's ``launch/specs.py``,
whose ``ShapeDtypeStruct``s carry ``NamedSharding``s: here each input is
a ``DTensor`` made ``from_local`` on a ``meta`` shard, its placements
read from the parameter specs (``models/param.py``) and from the rules
below, which are the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import axis_names, axis_size, dp_axes
from repro_torch.models.model import init_caches, model_specs
from repro_torch.models.param import (DTYPES, ParamTree, full_placement,
                                      is_spec)

# archs whose serve KV caches are int8-quantized to fit one device's
# memory, as the JAX package's
QUANTIZED_KV_ARCHS = {"internvl2-76b"}
# archs whose Adam moments are bf16 to fit (llama4-400B on 256 devices)
BF16_MOMENT_ARCHS = {"llama4-maverick-400b-a17b"}
# gradient-accumulation factors at train_4k, the JAX package's: chosen so
# per-microbatch layer-boundary activation saves stay under ~4 GiB/device
TRAIN_MICROBATCHES = {
    "hubert-xlarge": 2, "qwen2-moe-a2.7b": 4, "llama4-maverick-400b-a17b": 16,
    "h2o-danube-3-4b": 4, "stablelm-12b": 8, "gemma3-12b": 8, "yi-34b": 16,
    "zamba2-1.2b": 2, "internvl2-76b": 16, "falcon-mamba-7b": 8,
}


def train_profile(cfg: ModelConfig) -> str:
    from repro_torch.models.model import resolve_profile
    return resolve_profile(cfg, "auto")


def microbatches_for(cfg: ModelConfig) -> int:
    if train_profile(cfg) == "zero":
        return 1  # already 1 sequence/device
    return TRAIN_MICROBATCHES.get(cfg.name, 1)


def _dim_axes(size: int, axes: tuple, mesh):
    """Shard `size` over as many of `axes` as divide it (prefix)."""
    use = []
    n = 1
    for a in axes:
        if size % (n * axis_size(mesh, a)) == 0:
            use.append(a)
            n *= axis_size(mesh, a)
    if not use:
        return None
    return tuple(use) if len(use) > 1 else use[0]


def dtensor_placements(placement, mesh) -> list:
    """A placement (one entry a tensor dim: None, an axis, or a tuple of
    axes, major first) -> DTensor placements, one a mesh dim. A tensor
    dim over several axes is sharded on each, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(placement):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            out[names.index(a)] = Shard(d)
    return out


def meta_dtensor(shape, dtype, placement, mesh):
    """Rank 0's shard of a ``shape`` tensor placed by ``placement`` on
    ``mesh``, as a DTensor over a ``meta`` local tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = dtensor_placements(placement, mesh)
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)
    t = torch.empty(local, dtype=dtype, device="meta")
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _map(f, tree):
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(f, v) for v in tree]
    return f(tree)


def sharded_params(cfg: ModelConfig, mesh, profile: str = "auto"):
    """The parameter tree as a ``ParamTree`` of meta DTensors placed by
    ``model_specs(cfg, profile)``."""
    dt = DTYPES[cfg.dtype]

    def f(s):
        return meta_dtensor(s.shape, s.dtype or dt, full_placement(s), mesh)
    return ParamTree(_map(lambda s: f(s) if is_spec(s) else s,
                          model_specs(cfg, profile)))


def _param_tree_dict(params) -> dict:
    """A ParamTree as the nested dicts and lists of its tensors."""
    out = {k: v for k, v in params._parameters.items()}
    for k, m in params._modules.items():
        out[k] = ([_param_tree_dict(x) for x in m]
                  if isinstance(m, torch.nn.ModuleList)
                  else _param_tree_dict(m))
    return out


def distribute_params(params, cfg: ModelConfig, mesh,
                      profile: str = "auto"):
    """A ``ParamTree`` of real tensors (the same on every rank) as one of
    DTensors placed by ``model_specs(cfg, profile)``: each rank keeps its
    shards."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, s):
        if isinstance(t, dict):
            return {k: place(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [place(v, x) for v, x in zip(t, s)]
        return distribute_tensor(t.detach(), mesh, dtensor_placements(
            full_placement(s), mesh))
    return ParamTree(place(_param_tree_dict(params),
                           model_specs(cfg, profile)))


def sharded_opt_state(cfg: ModelConfig, params, mesh) -> dict:
    """AdamW's state (``optim.adamw_init``'s layout) for ``params``: the
    moments placed as their parameters, in bf16 for the archs of
    ``BF16_MOMENT_ARCHS``, else float32; the step a replicated int32."""
    from torch.distributed.tensor import DTensor
    mdt = torch.bfloat16 if cfg.name in BF16_MOMENT_ARCHS else torch.float32

    def moment(p):
        local = torch.empty(p.to_local().shape, dtype=mdt, device="meta")
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    tree = _param_tree_dict(params)
    step = meta_dtensor((), torch.int32, (), mesh)
    return {"step": step, "m": _map(moment, tree), "v": _map(moment, tree)}


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                batch_axes=None) -> dict:
    """tokens and labels (B, S) int32 (an audio model's frames (B, S, d)
    in place of tokens; a vision model adds patch_embeds (B, F, d)), the
    batch sharded over as many of the data axes as divide it."""
    dp = batch_axes if batch_axes is not None else dp_axes(mesh)
    B, S = cell.global_batch, cell.seq_len
    bspec = _dim_axes(B, dp, mesh)
    dt = DTYPES[cfg.dtype]
    tok = lambda: meta_dtensor((B, S), torch.int32, (bspec, None), mesh)
    if cfg.frontend == "audio":
        return {"frames": meta_dtensor((B, S, cfg.d_model), dt,
                                       (bspec, None, None), mesh),
                "labels": tok()}
    batch = {"tokens": tok(), "labels": tok()}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = meta_dtensor(
            (B, cfg.frontend_len, cfg.d_model), dt, (bspec, None, None),
            mesh)
    return batch


def _cache_pspec(leaf_path: str, shape, mesh, bspec) -> tuple:
    """Placement of a cache leaf (without its layer axis): batch over the
    data axes; attention caches SEQUENCE-sharded over "model" (context
    parallelism: works for any kv-head count; the softmax over the
    sharded length reduces over "model"); SSM states shard their inner
    dim over "model"."""
    tp = axis_size(mesh, "model")
    model = lambda s: "model" if (s > 1 and s % tp == 0) else None
    if "conv" in leaf_path:          # (B, k-1, d_in)
        return (bspec, None, model(shape[2]))
    if "ssm" in leaf_path:
        if len(shape) == 4:          # mamba2 (B, H, P, N)
            return (bspec, model(shape[1]), None, None)
        return (bspec, model(shape[1]), None)   # mamba1 (B, d_in, N)
    if "'ks'" in leaf_path or "'vs'" in leaf_path:  # quant scales (B,S,KV)
        return (bspec, model(shape[1]), None)
    # attention k/v/k8/v8: (B, S, KV, hd) -> shard S
    return (bspec, model(shape[1]), None, None)


def sharded_caches(cfg: ModelConfig, cell: ShapeCell, mesh) -> list:
    """``init_caches`` for the cell's batch and length (int8 for
    ``QUANTIZED_KV_ARCHS``) as meta DTensors placed by ``_cache_pspec``,
    the layer axis replicated."""
    bspec = _dim_axes(cell.global_batch, dp_axes(mesh), mesh)
    caches = init_caches(cfg, cell.global_batch, cell.seq_len,
                         quantize=cfg.name in QUANTIZED_KV_ARCHS,
                         device="meta")
    out = []
    for si, stage in enumerate(caches):
        out.append({
            sub: {name: meta_dtensor(
                t.shape, t.dtype,
                (None,) + _cache_pspec(f"[{si}]['{sub}']['{name}']",
                                       t.shape[1:], mesh, bspec), mesh)
                for name, t in leaves.items()}
            for sub, leaves in stage.items()})
    return out


def cell_inputs(cfg: ModelConfig, cell: ShapeCell, mesh) -> tuple:
    """-> (kind, args tuple of meta DTensors) for the cell's step fn.

    Training uses the per-arch profile (``train_profile``: "tp" with
    microbatching, or "zero" with the batch sharded over every axis).
    Serving always uses "tp". A decode cell's last argument is the cache
    length as a replicated int32 scalar (4 bytes, as the JAX package's);
    its value is not read (``step_fn_for``)."""
    if cell.kind == "train":
        profile = train_profile(cfg)
        params = sharded_params(cfg, mesh, profile)
        opt = sharded_opt_state(cfg, params, mesh)
        baxes = (dp_axes(mesh) + ("model",) if profile == "zero"
                 else dp_axes(mesh))
        return "train", (params, opt,
                         batch_specs(cfg, cell, mesh, batch_axes=baxes))
    params = sharded_params(cfg, mesh, "tp")
    if cell.kind == "prefill":
        return "prefill", (params, batch_specs(cfg, cell, mesh))
    bspec = _dim_axes(cell.global_batch, dp_axes(mesh), mesh)
    tok = meta_dtensor((cell.global_batch, 1), torch.int32, (bspec, None),
                       mesh)
    clen = meta_dtensor((), torch.int32, (), mesh)
    return "decode", (params, tok, sharded_caches(cfg, cell, mesh), clen)


def step_fn_for(cfg: ModelConfig, kind: str, mesh, *,
                causal_mode: str = "masked_full", microbatches=None):
    """The step function matching ``cell_inputs``' sharding decisions:
    the port's step functions run on DTensors (``models/sharded.py``
    supplies the pieces DTensor has no sharding rule for). The decode
    step writes the token at the caches' last slot: the port's decode
    attends over every slot under a mask, so its count does not depend on
    the position. ``microbatches`` (default ``microbatches_for(cfg)``)
    sets a train step's."""
    from repro_torch.models import sharded
    if microbatches is None:
        microbatches = microbatches_for(cfg) if kind == "train" else 1
    return sharded.make_step(cfg, kind, mesh, causal_mode=causal_mode,
                             microbatches=microbatches)

