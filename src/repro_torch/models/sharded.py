"""The model on DTensors: the port's counterpart of the JAX package's
GSPMD partitioning. The production dry run (``launch/dryrun.py``) runs
it on meta DTensors over a fake process group; the tests run it on real
CPU DTensors over gloo.

The parameters carry the placements of ``model_specs`` (as DTensor
placements: ``launch/specs.py``), and DTensor's sharding propagation
runs the matrix products, norms and losses and inserts the collectives
(``_c10d_functional``): a replicated activation times a column-sharded
weight gives a sharded one, a row-sharded product a Partial sum. Left
to itself DTensor chooses op by op, so the plan is pinned where it
matters:

* ``Gathered``: FSDP / ZeRO-3 weights gathered where a layer reads them
  (``gather_fsdp``), never the whole model at once;
* ``settle``: each block's output all-reduced onto the residual
  stream's placement (batch-sharded, replicated on "model");
* ``embed`` and ``xent_chunk``: the vocabulary-parallel embedding and
  cross entropy.

The pieces DTensor has no rule for run on local shards under
``local_map`` (the counterpart of ``shard_map``), their collectives and
their gradients' placements written out:

* ``attention``: heads on "model" where they divide it (the K/V heads a
  rank's query heads read picked on the rank), else sequence-parallel as
  the JAX package's: queries sharded on S, K/V whole (cut at the rank's
  last query when causal); the kernel, its plain version or its meta
  route runs on the local shards;
* ``attn_decode_cached``: one token against a sequence-sharded cache
  (the JAX package's context-parallel cache layout): each rank writes
  the token where its slots hold it and attends to its slots; the
  softmax's max, sum and weighted values are all-reduced over "model";
* ``store_prompt_kv``: the prompt's K/V into such a cache;
* ``apply_moe``: expert parallel: each "model" rank runs the dispatch
  (capacity scatter or sort + grouped matmul) for its own experts over
  its batch shard's tokens, a Partial sum over "model";
* ``apply_ssm``: the SSM layers data parallel, their weights gathered;
* ``microbatch``: each rank's own rows of a microbatch.

The JAX package's ``with_sharding_constraint`` points become the
redistributions these make (``local_map``'s input placements) and the
prefill caches' placement (``init_caches``). The single-device path
never reaches this module: every entry takes a DTensor
(``is_dtensor``), and ``make_step`` builds the dry run's step functions.
"""
from __future__ import annotations

import sys
from collections.abc import Mapping

import torch

from repro_torch.configs.base import ModelConfig


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (never true before
    torch.distributed.tensor is imported, which the single-device path
    does not do)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _model_dim(mesh):
    names = tuple(mesh.mesh_dim_names)
    return names.index("model") if "model" in names else None


def _is_shard(p, dim: int) -> bool:
    from torch.distributed.tensor import Shard
    return isinstance(p, Shard) and p.dim == dim


def batch_placements(x) -> list:
    """``x``'s batch sharding (Shard(0) on a mesh dim where ``x`` has
    it), every other mesh dim Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if _is_shard(p, 0) else Replicate()
            for p in x.placements]


def settle(x):
    """``x`` placed as the residual stream is: batch-sharded as it is,
    replicated on every other mesh dim (a row-parallel product's Partial
    sum all-reduced: tensor parallelism's all-reduce after each block).
    DTensor left to itself carries a Partial sum on, and a norm over it
    comes out Partial too."""
    return x.redistribute(x.device_mesh, batch_placements(x))


def _local_map(fn, out, ins, mesh, grads=None):
    """``local_map`` with the inputs redistributed to ``ins``; ``out`` the
    placements of one output, or a tuple of them, one an output;
    ``grads`` the inputs' gradients' placements (default ``ins``): an
    input every rank of an axis reads whole while the ranks split the
    work has a Partial gradient there."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    if all(isinstance(p, Placement) for p in out):
        out = (out,)
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def _partial_on(pl, dims) -> tuple:
    """``pl`` with Partial in place of Replicate on the mesh dims
    ``dims``."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if i in dims and isinstance(p, Replicate) else p
                 for i, p in enumerate(pl))


def _batch_dims(x) -> set:
    """The mesh dims ``x`` is batch-sharded on."""
    return {i for i, p in enumerate(x.placements) if _is_shard(p, 0)}


def _tp(x):
    """(the "model" mesh dim, its size, this rank's coordinate on it) when
    ``x`` is not batch-sharded on "model" (tensor parallelism applies),
    else (None, 1, 0)."""
    mesh = x.device_mesh
    md = _model_dim(mesh)
    if md is None or _is_shard(x.placements[md], 0):
        return None, 1, 0
    return md, mesh.size(md), mesh.get_local_rank(md)


# ---------------------------------------------------------------------------
# FSDP: the parameters as the layers read them
# ---------------------------------------------------------------------------


def gather_fsdp(t):
    """A parameter as a layer computes with it: a tensor dim it holds
    sharded over "data" (or "pod") gathered over every mesh dim that
    shards it (FSDP and ZeRO-3: an all-gather, whose backward is the
    gradient's reduce-scatter); "model" shards of other dims (tensor
    parallelism) kept."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(t.device_mesh.mesh_dim_names)
    dims = {p.dim for a, p in zip(names, t.placements)
            if a in ("pod", "data") and isinstance(p, Shard)}
    if not dims:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim in dims else p
        for p in t.placements])


class Gathered(Mapping):
    """A parameter tree (a ``ParamTree`` or the nested dicts of a stage's
    layer views) read through ``gather_fsdp``: each read of a leaf
    gathers it, so a layer gathers its weights where it uses them (and
    again where a checkpointed layer is replayed), never the whole model
    at once."""

    def __init__(self, tree):
        self._tree = tree

    def _keys(self):
        t = self._tree
        if isinstance(t, torch.nn.Module):
            return list(t._parameters) + list(t._modules)
        return list(t)

    def __getitem__(self, key):
        v = self._tree[key]
        if isinstance(v, torch.nn.ModuleList):
            return [Gathered(m) for m in v]
        if isinstance(v, (torch.nn.Module, dict)):
            return Gathered(v)
        return gather_fsdp(v)

    def __iter__(self):
        return iter(self._keys())

    def __len__(self):
        return len(self._keys())

    def __contains__(self, key):
        return key in self._keys()

    def layer_views(self) -> list:
        """``param.layer_views`` of the stage, each layer read through
        ``gather_fsdp``."""
        from repro_torch.models.param import layer_views
        return [Gathered(v) for v in layer_views(self._tree)]


# ---------------------------------------------------------------------------
# embedding, attention
# ---------------------------------------------------------------------------


def embed(table, tokens):
    """``layers.embed`` on DTensors: vocabulary-parallel when the table
    is sharded on its rows over "model": each rank looks up the tokens
    its rows hold (zeros for the others), then the sum over "model" (an
    all-reduce), the batch sharded as the tokens. Else DTensor's own
    indexing."""
    from torch.distributed.tensor import Partial
    mesh = table.device_mesh
    md = _model_dim(mesh)
    if md is None or not _is_shard(table.placements[md], 0) or \
            _is_shard(tokens.placements[md], 0):
        return table[tokens.long()]
    V, tp, m = table.shape[0], mesh.size(md), mesh.get_local_rank(md)
    Vl = V // tp
    base = batch_placements(tokens)
    tpl = tuple(table.placements)
    out = list(base)
    out[md] = Partial()

    def fn(tl, tok):
        tok = tok.long() - m * Vl
        mine = (tok >= 0) & (tok < Vl)
        return tl[tok.clamp(0, Vl - 1)] * mine[..., None].to(tl.dtype)

    x = _local_map(fn, tuple(out), (tpl, tuple(base)), mesh,
                   grads=(_partial_on(tpl, _batch_dims(tokens)),
                          tuple(base)))(table, tokens)
    return x.redistribute(mesh, base)      # the all-reduce over "model"


def proj_in(x, w):
    """``attention._proj_in`` on DTensors: (B,S,d) @ (d,h,hd) ->
    (B,S,h,hd), the product's h*hd dim gathered on a mesh dim whose size
    does not divide h (DTensor cannot split such a shard into heads)."""
    from torch.distributed.tensor import Replicate
    d, h, hd = w.shape
    y = x @ w.reshape(d, h * hd)
    mesh = y.device_mesh
    bad = [i for i, p in enumerate(y.placements)
           if _is_shard(p, 2) and h % mesh.size(i)]
    if bad:
        y = y.redistribute(mesh, [Replicate() if i in bad else p
                                  for i, p in enumerate(y.placements)])
    return y.unflatten(-1, (h, hd))


def apply_attention(p: dict, x, cfg: ModelConfig, *, local: bool,
                    positions, causal_mode: str):
    """``attention.apply_attention`` on DTensors, the whole block (the
    projections, RoPE, the attention core, the output projection) on each
    rank's shards under one ``local_map``, so its backward is the
    block's own on the shards. On "model": heads sharded when the query
    projection is (K/V sharded too when their projection is, else
    computed whole with each rank attending with the K/V heads its query
    heads read), the output a Partial sum; else, for a global layer with S
    a multiple of the axis (and at least 64), sequence-parallel as the
    JAX package's: the rank's queries over all keys (cut after its last
    query when causal), the output sharded on S; else replicated. The
    output is then settled onto the residual's placement. -> (out, (k,
    v)), k and v whole on "model" unless their projection is sharded
    (the prefill's caches). With gradients on (the training forward,
    which reads no cache) k and v are None, and a rank projects only
    the K/V heads it attends with."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models.attention import (Q_BLOCK, _proj_in, _proj_out,
                                              blocked_attention)
    from repro_torch.models.layers import rope
    mesh = x.device_mesh
    wq, wk, wv, wo = (p[n] for n in ("wq", "wk", "wv", "wo"))
    S, H, KV = x.shape[1], wq.shape[1], wk.shape[1]
    md, tp, m = _tp(x)
    window = cfg.attn.window if local else None
    mode = None
    if tp > 1 and H % tp == 0 and _is_shard(wq.placements[md], 1):
        mode = "heads"
    elif tp > 1 and S % tp == 0 and S >= 64 and (window is None
                                                  or not cfg.attn.causal):
        mode = "seq"
    kv_sharded = mode == "heads" and KV % tp == 0 and \
        _is_shard(wk.placements[md], 1)
    base = batch_placements(x)
    rep = [Replicate()] * len(base)

    def at(pl, placement):
        out = list(pl)
        if md is not None and placement is not None:
            out[md] = placement
        return tuple(out)

    heads = mode == "heads"
    wq_pl = at(rep, Shard(1) if heads else None)
    wkv_pl = at(rep, Shard(1) if kv_sharded else None)
    wo_pl = at(rep, Shard(0) if heads else None)
    out_pl = at(base, {"heads": Partial(), "seq": Shard(1)}.get(mode)) \
        if mode else tuple(base)
    kv_pl = at(base, Shard(2) if kv_sharded else None)
    split = {md} if mode else set()
    wg = lambda pl: _partial_on(pl, _batch_dims(x) | split)
    G, h_loc, causal = H // KV, H // tp, cfg.attn.causal
    want_kv = not torch.is_grad_enabled()

    def kv_heads(t):
        """The K/V heads of this rank's query heads m * h_loc .. (m+1) *
        h_loc - 1, of a projection (d, KV, hd) or of K/V (B, S, KV, hd)."""
        dim = 1 if t.dim() == 3 else 2
        if h_loc % G == 0 or G % h_loc == 0:
            return t.narrow(dim, m * h_loc // G, max(1, h_loc // G))
        idx = (m * h_loc + torch.arange(h_loc, device=t.device)) // G
        return t.index_select(dim, idx)

    def fn(xl, wql, wkl, wvl, wol):
        select = heads and not kv_sharded
        if select and not want_kv:   # project only the heads used
            wkl, wvl = kv_heads(wkl), kv_heads(wvl)
        k, v = _proj_in(xl, wkl), _proj_in(xl, wvl)
        pos, xq = positions, xl
        if mode == "seq":
            rows = slice(m * (S // tp), (m + 1) * (S // tp))
            pos, xq = positions[:, rows], xl[:, rows]
        q = _proj_in(xq, wql)
        if causal:                    # decoders use RoPE; encoders skip it
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        ka, va = k, v
        if select and want_kv:
            ka, va = kv_heads(k), kv_heads(v)
        mode_l = causal_mode
        if mode == "seq" and causal:
            cut = (m + 1) * (S // tp)
            ka, va = ka[:, :cut], va[:, :cut]
            mode_l = "masked_full"   # recursive halving needs Sq == Sk
        Sq = q.shape[1]
        o = blocked_attention(q, ka, va, causal=causal, window=window,
                              q_block=min(Q_BLOCK, Sq),
                              kv_block=min(Q_BLOCK, Sq), causal_mode=mode_l)
        out = _proj_out(o, wol)
        return (out, k, v) if want_kv else out

    outs = _local_map(
        fn, (out_pl, kv_pl, kv_pl) if want_kv else out_pl,
        (tuple(base), wq_pl, wkv_pl, wkv_pl, wo_pl), mesh,
        grads=(_partial_on(base, split), wg(wq_pl), wg(wkv_pl),
               wg(wkv_pl), wg(wo_pl)))(x, wq, wk, wv, wo)
    if want_kv:
        return settle(outs[0]), tuple(outs[1:])
    return settle(outs), (None, None)


def mlp(p: dict, x):
    """``layers.apply_mlp`` on DTensors: when the weights are tensor
    parallel on "model" (gate and up on their columns, down on its rows)
    and x is not batch-sharded on it, the block on each rank's shards
    under ``local_map`` (its backward the shards' own), a Partial sum;
    else DTensor's own ops. Settled onto the residual's placement."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    import torch.nn.functional as F
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    md, tp, _ = _tp(x)
    if tp == 1 or not (_is_shard(wg.placements[md], 1)
                       and _is_shard(wu.placements[md], 1)
                       and _is_shard(wd.placements[md], 0)):
        return settle((F.silu(x @ wg) * (x @ wu)) @ wd)
    base = batch_placements(x)
    col, row = [Replicate()] * len(base), [Replicate()] * len(base)
    col[md], row[md] = Shard(1), Shard(0)
    out = list(base)
    out[md] = Partial()
    bd = _batch_dims(x)

    def fn(xl, g, u, d):
        return (F.silu(xl @ g) * (xl @ u)) @ d

    y = _local_map(fn, tuple(out), (tuple(base), tuple(col), tuple(col),
                                    tuple(row)), x.device_mesh,
                   grads=(_partial_on(base, {md}), _partial_on(col, bd),
                          _partial_on(col, bd), _partial_on(row, bd)))(
        x, wg, wu, wd)
    return settle(y)


def _cache_names(c: dict) -> tuple:
    return ("k8", "v8", "ks", "vs") if "k8" in c else ("k", "v")


def _seq_shards(cache):
    """(the "model" mesh dim, shards, this rank's coordinate) when a
    cache view (B, slots, ...) is sharded on its slots, else (None, 1,
    0)."""
    mesh = cache.device_mesh
    md = _model_dim(mesh)
    if md is None or not _is_shard(cache.placements[md], 1):
        return None, 1, 0
    return md, mesh.size(md), mesh.get_local_rank(md)


def attn_decode_cached(p, x, c: dict, layer: int, cache_len: int,
                       cfg: ModelConfig, *, local: bool):
    """``model._attn_decode_cached`` on DTensors: the projections through
    DTensor, then on each rank its slots of layer ``layer``'s cache
    (sequence-sharded on "model", or whole): the token's K/V written
    where the rank holds its slot (codes and scales in an int8 cache; the
    attention reads the token at full precision, as the single-device
    path), scores over the rank's slots in float32, and the softmax's
    max, then its sum, then the weighted values all-reduced over "model".
    -> out (B,1,d)."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.models.attention import (NEG_INF, _proj_in, _proj_out,
                                              is_ring, write_slot)
    from repro_torch.models.layers import rope
    from repro_torch.models.model import _dequantize_kv, _quantize_kv
    from repro_torch.models.param import DTYPES
    mesh = x.device_mesh
    B = x.shape[0]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32,
                     device=x.to_local().device)
    q = rope(_proj_in(x, p["wq"]), pos, cfg.rope_theta)
    k = rope(_proj_in(x, p["wk"]), pos, cfg.rope_theta)
    v = _proj_in(x, p["wv"])
    names = _cache_names(c)
    views = [c[n][layer] for n in names]
    quant = len(names) == 4
    Smax = views[0].shape[1]
    H, KV, hd = q.shape[2], k.shape[2], k.shape[3]
    G = H // KV
    at = write_slot(cfg, Smax, cache_len, local)
    ring = is_ring(cfg, Smax, local)
    md, tp, m = _seq_shards(views[0])
    Sl = Smax // tp
    group = mesh.get_group(md) if md is not None else None
    dt = DTYPES[cfg.dtype]
    rep = tuple(batch_placements(views[0]))

    def fn(ql, kl, vl, *cl):
        lo = m * Sl
        mine = lo <= at < lo + Sl
        if quant:
            if mine:
                for (codes, scales), t in ((cl[0::2], kl), (cl[1::2], vl)):
                    q8, s = _quantize_kv(t)
                    codes[:, at - lo] = q8[:, 0]
                    scales[:, at - lo] = s[:, 0]
            ck = _dequantize_kv(cl[0], cl[2], dt)
            cv = _dequantize_kv(cl[1], cl[3], dt)
        else:
            ck, cv = cl
        if mine:
            ck[:, at - lo] = kl[:, 0]
            cv[:, at - lo] = vl[:, 0]
        b = ql.shape[0]
        qg = ql.reshape(b, KV, G, hd)
        s = torch.einsum("bkgh,bskh->bkgs", qg.float(), ck.float()) \
            * hd ** -0.5
        kpos = lo + torch.arange(Sl, device=ql.device)
        if ring:
            valid = kpos <= cache_len if cache_len < Smax else None
        else:
            valid = kpos <= cache_len
            if local:
                valid &= kpos > cache_len - cfg.attn.window
        if valid is not None:
            s = torch.where(valid, s, NEG_INF)
        mx = s.amax(-1, keepdim=True)
        if group is not None:
            mx = funcol.all_reduce(mx, "max", group)
        e = torch.exp(s - mx)
        den = e.sum(-1, keepdim=True)
        if group is not None:
            den = funcol.all_reduce(den, "sum", group)
        w = (e / den).to(cv.dtype)
        o = torch.einsum("bkgs,bskh->bkgh", w, cv)
        if group is not None:
            o = funcol.all_reduce(o, "sum", group)
        return o.reshape(b, 1, H, hd)

    o = _local_map(fn, rep, (rep, rep, rep) + tuple(
        tuple(t.placements) for t in views), mesh)(q, k, v, *views)
    return _proj_out(o, p["wo"])


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                quantize: bool, like):
    """``model.init_caches`` as zeroed DTensors on ``like``'s mesh and
    device, placed as the dry run's decode inputs (``specs._cache_pspec``:
    batch as ``like`` is sharded, attention caches on their slots over
    "model", SSM states on their inner dim): the JAX prefill's cache
    constraint."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.launch import op_cost
    from repro_torch.launch.specs import _cache_pspec, dtensor_placements
    from repro_torch.models.model import init_caches as plain
    mesh = like.device_mesh
    names = tuple(mesh.mesh_dim_names)
    baxes = tuple(a for a, pl in zip(names, like.placements)
                  if _is_shard(pl, 0))
    bspec = (baxes if len(baxes) > 1 else baxes[0]) if baxes else None
    dev = like.to_local().device
    with op_cost.uncounted():         # the shapes, not a step's work
        shapes = plain(cfg, batch, max_len, quantize=quantize, device="meta")
    out = []
    for si, stage in enumerate(shapes):
        st = {}
        for sub, leaves in stage.items():
            st[sub] = {}
            for name, t in leaves.items():
                pl = dtensor_placements(
                    (None,) + _cache_pspec(f"[{si}]['{sub}']['{name}']",
                                           t.shape[1:], mesh, bspec), mesh)
                local, _ = compute_local_shape_and_global_offset(
                    tuple(t.shape), mesh, pl)
                st[sub][name] = DTensor.from_local(
                    torch.zeros(local, dtype=t.dtype, device=dev), mesh, pl,
                    run_check=False, shape=t.shape, stride=t.stride())
        out.append(st)
    return out


def store_prompt_kv(c: dict, layer: int, k, v):
    """``model._store_prompt_kv`` on DTensors: each rank writes the
    prompt positions its slots of layer ``layer`` hold (the last min(C, S)
    positions, position p at slot p % C), quantized in an int8 cache."""
    from repro_torch.models.model import _quantize_kv
    names = _cache_names(c)
    views = [c[n][layer] for n in names]
    C, S = views[0].shape[1], k.shape[1]
    n = min(C, S)
    start = (S - n) % C
    first = min(n, C - start)
    # (first slot, first position, count) of the ring's one or two runs
    runs = [(start, S - n, first)] + ([(0, S - n + first, n - first)]
                                      if first < n else [])
    md, tp, m = _seq_shards(views[0])
    Sl = C // tp
    rep = tuple(batch_placements(views[0]))

    def fn(kl, vl, *cl):
        lo, hi = m * Sl, (m + 1) * Sl
        for slot, pos, cnt in runs:
            a, b = max(slot, lo), min(slot + cnt, hi)
            if a >= b:
                continue
            src = slice(pos + a - slot, pos + b - slot)
            for j, t in enumerate((kl[:, src], vl[:, src])):
                if len(cl) == 4:
                    q8, s = _quantize_kv(t)
                    cl[j][:, a - lo:b - lo] = q8
                    cl[j + 2][:, a - lo:b - lo] = s
                else:
                    cl[j][:, a - lo:b - lo] = t
        return kl[:, :0]

    _local_map(fn, rep, (rep, rep) + tuple(tuple(t.placements)
                                           for t in views),
               views[0].device_mesh)(k, v, *views)


def put_layer(dst, layer: int, t):
    """``dst[layer] = t`` for a stacked cache leaf ``dst``, ``t`` first
    placed as ``dst[layer]`` is."""
    view = dst[layer]
    view.copy_(t.redistribute(view.device_mesh, view.placements))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def apply_moe(p: dict, x, cfg: ModelConfig):
    """``moe.apply_moe`` on a DTensor x (B,S,d): expert parallel over
    "model" when x is not batch-sharded on it (each rank's experts
    Ep/tp of the (Ep, d, f) weights, FSDP shards gathered), the dispatch
    run on each rank's batch shard for its own experts; the shared expert
    through DTensor (tensor parallel). The aux loss from the router's
    summed probabilities and top-1 counts, Partial over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models.layers import apply_mlp
    from repro_torch.models.moe import _route, padded_experts
    mesh = x.device_mesh
    m_cfg = cfg.moe
    B, S, d = x.shape
    E, k = m_cfg.num_experts, m_cfg.top_k
    Ep = padded_experts(E)
    md, tp, m = _tp(x)
    if Ep % tp:
        md, tp, m = None, 1, 0
    base = batch_placements(x)
    rep = tuple(Replicate() for _ in base)
    wpl = [Replicate()] * len(base)
    out_pl = list(base)
    if md is not None:
        wpl[md] = Shard(0)
        out_pl[md] = Partial()
    # the router's load statistics: each rank's share, summed over the
    # batch axes, and over "model" where every rank routes the same
    # tokens (each then outputs 1/tp of them)
    split = {md} if md is not None else set()
    stat_pl = _partial_on([Replicate()] * len(base),
                          _batch_dims(x) | split)
    bd = _batch_dims(x)
    Eloc = Ep // tp
    e0 = m * Eloc
    sort = m_cfg.dispatch == "sort"

    def fn(xl, router, wg, wu, wd):
        b = xl.shape[0]
        gates, idx, _ = _route({"router": router}, xl, k)
        logits = xl.float() @ router
        probs = torch.softmax(logits, dim=-1)
        me_sum = probs.sum(dim=(0, 1))
        ce_sum = torch.nn.functional.one_hot(idx[..., 0], E).float() \
            .sum(dim=(0, 1))
        me_sum, ce_sum = me_sum / tp, ce_sum / tp
        w = {"w_gate": wg, "w_up": wu, "w_down": wd}
        if sort:
            y = _sort_local(w, xl, gates, idx, e0, Eloc)
        else:
            y = _scatter_local(w, xl, gates, idx, e0, Eloc, m_cfg, E)
        return y, me_sum, ce_sum

    wg = _partial_on(wpl, bd)
    y, me_sum, ce_sum = _local_map(
        fn, (tuple(out_pl), stat_pl, stat_pl),
        (tuple(base), rep, tuple(wpl), tuple(wpl), tuple(wpl)), mesh,
        grads=(_partial_on(base, split), _partial_on(rep, bd | split), wg,
               wg, wg))(x, p["router"], p["w_gate"], p["w_up"],
                        p["w_down"])
    n = float(B * S)
    aux = E * ((me_sum / n) * (ce_sum / n)).sum()
    if m_cfg.d_shared:
        y = y + apply_mlp(p["shared"], x)
    return settle(y), aux


def _sort_local(w, x, gates, idx, e0: int, Eloc: int):
    """The sort dispatch over experts e0 .. e0+Eloc-1: every routed row
    sorted by its local expert, the other experts' rows after them (the
    grouped matmul runs the tail with the last local expert's weights;
    their gates are zeroed), so no shape depends on the routing."""
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    B, S, d = x.shape
    k = idx.shape[-1]
    T = B * S * k
    eid = idx.reshape(T)
    mine = (eid >= e0) & (eid < e0 + Eloc)
    key = torch.where(mine, eid - e0, Eloc)
    gat = gates.reshape(T) * mine
    xe = x.reshape(B * S, d).repeat_interleave(k, dim=0)
    order = torch.argsort(key, stable=True)
    xs = xe[order]
    sizes = torch.zeros(Eloc + 1, dtype=torch.long, device=x.device) \
        .scatter_add_(0, key, torch.ones_like(key))[:Eloc]
    g = gmm_ops.grouped_matmul(xs, w["w_gate"], sizes)
    u = gmm_ops.grouped_matmul(xs, w["w_up"], sizes)
    ys = gmm_ops.grouped_matmul(F.silu(g) * u, w["w_down"], sizes)
    y_tok = torch.empty_like(ys)
    y_tok[order] = ys
    y_tok = y_tok * gat[:, None].to(ys.dtype)
    return y_tok.reshape(B, S, k, d).sum(dim=2)


def _scatter_local(w, x, gates, idx, e0: int, Eloc: int, m_cfg, E: int):
    """The capacity scatter over experts e0 .. e0+Eloc-1: the positions
    within each expert's group over all experts (as the single-device
    dispatch), the buffer holding the local experts' slots only."""
    import torch.nn.functional as F
    B, S, d = x.shape
    k = idx.shape[-1]
    C = max(8, int(round(m_cfg.capacity_factor * S * k / E + 7)) // 8 * 8)
    C = min(C, S * k)
    T = S * k
    eid = idx.reshape(B, T)
    gat = gates.reshape(B, T)
    onehot = F.one_hot(eid, E)
    pos = torch.gather(onehot.cumsum(1), 2, eid[..., None])[..., 0] - 1
    keep = (pos < C) & (eid >= e0) & (eid < e0 + Eloc)
    slot = torch.where(keep, (eid - e0) * C + pos, Eloc * C)
    xe = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    bidx = torch.arange(B, device=x.device)[:, None]
    slot_tok = torch.full((B, Eloc * C + 1), T, dtype=torch.long,
                          device=x.device)
    slot_tok[bidx, slot] = torch.arange(T, device=x.device).expand(B, T)
    xe_pad = torch.cat([xe, xe.new_zeros(B, 1, d)], dim=1)
    buf = torch.gather(xe_pad, 1, slot_tok[:, :Eloc * C, None]
                       .expand(B, Eloc * C, d)).reshape(B, Eloc, C, d)
    g = torch.einsum("becd,edf->becf", buf, w["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, w["w_up"])
    y = torch.einsum("becf,efd->becd", F.silu(g) * u, w["w_down"])
    y = torch.cat([y.reshape(B, Eloc * C, d), y.new_zeros(B, 1, d)], dim=1)
    y_tok = y[bidx, slot] * (gat * keep)[..., None].to(y.dtype)
    return y_tok.reshape(B, S, k, d).sum(dim=2)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def xent_chunk(embed_params, hs, ys):
    """``steps._xent_chunk`` on DTensors: vocab-parallel cross entropy.
    The logits stay sharded on the vocabulary over "model" (as the
    unembedding is); each rank's max, sum of exponentials and gold logit
    (zero where the label lies outside its vocabulary slice) are reduced
    over "model" (the max taken as a constant: the log-sum-exp does not
    depend on it). -> (the summed NLL, the count of unmasked labels)."""
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.models.layers import unembed
    logits = unembed(embed_params, hs).float()
    mesh = logits.device_mesh
    md, tp, m = _tp(hs)
    if logits.shape[-1] % tp:
        md, tp, m = None, 1, 0
    base = batch_placements(hs)
    lp = list(base)
    stat = list(base)
    if md is not None:
        lp[md] = Shard(2)
    lp, yp = tuple(lp), tuple(base)

    def local_max(lg):
        return lg.detach().amax(-1)

    if md is not None:
        stat[md] = Partial("max")
    mx = _local_map(local_max, tuple(stat), (lp,), mesh)(logits)
    if md is not None:
        stat[md] = Partial()
    V = logits.shape[-1] // tp

    def local_sums(lg, mxl, yl):
        se = torch.exp(lg - mxl[..., None]).sum(-1)
        mine = (yl >= m * V) & (yl < (m + 1) * V)
        idx = (yl.long() - m * V).clamp(0, V - 1)
        gold = torch.gather(lg, -1, idx[..., None])[..., 0] * mine
        return se, gold

    se, gold = _local_map(local_sums, (tuple(stat), tuple(stat)),
                          (lp, yp, yp), mesh)(logits, mx, ys)
    lse = torch.log(se) + mx
    mask = (ys >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


# ---------------------------------------------------------------------------
# SSM layers, microbatches
# ---------------------------------------------------------------------------


def apply_ssm(fn, p: dict, x, cfg: ModelConfig, state=None):
    """``fn(p, x, cfg)`` or ``fn(p, x, state, cfg)`` -> (out, state dict)
    (an SSM layer's forward or decode step) on each rank's batch shard,
    its weights gathered whole: data parallel. The state comes in and
    goes out batch-sharded as x (the caller places it as its cache)."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    base = tuple(batch_placements(x))
    rep = tuple(Replicate() for _ in base)
    pk = list(p)
    keys = (("conv", "ssm") if cfg.ssm.kind == "mamba1"
            else ("conv_x", "conv_B", "conv_C", "ssm"))

    def local(xl, *rest):
        pl = dict(zip(pk, rest[:len(pk)]))
        if state is None:
            out, st = fn(pl, xl, cfg)
        else:
            out, st = fn(pl, xl, dict(zip(keys, rest[len(pk):])), cfg)
        return (out,) + tuple(st[k] for k in keys)

    sin = [state[k] for k in keys] if state is not None else []
    ins = (base,) + (rep,) * len(pk) + (base,) * len(sin)
    wg = _partial_on(rep, _batch_dims(x))
    outs = _local_map(
        local, (base,) * (1 + len(keys)), ins, mesh,
        grads=(base,) + (wg,) * len(pk) + (base,) * len(sin))(
        x, *[p[k] for k in pk], *sin)
    return outs[0], dict(zip(keys, outs[1:]))


def microbatch(t, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a DTensor batch-sharded on dim 0:
    rows i*b .. (i+1)*b - 1 of each rank's b*n rows (the microbatches
    differ from the single-device split's, their mean gradient does
    not)."""
    pl = tuple(t.placements)

    def fn(tl):
        b = tl.shape[0] // n
        return tl[i * b:(i + 1) * b]

    return _local_map(fn, pl, (pl,), t.device_mesh)(t)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, *, causal_mode="masked_full",
                    microbatches: int = 1, peak_lr=3e-4, warmup=100,
                    total_steps=10000):
    """``steps.make_train_step`` on DTensors: ``microbatches``
    microbatches (at most one a row a rank holds) of each rank's rows,
    their gradients summed in float32 and averaged; each gradient then
    placed as its parameter (the gradient reduction: an all-reduce, or a
    reduce-scatter onto an FSDP shard), clipped to a global norm of 1.0;
    AdamW on each rank's shards."""
    from repro_torch.models.steps import loss_fn
    from repro_torch.optim import (adamw_update, clip_by_global_norm,
                                   cosine_schedule)
    from repro_torch.tree import tree_leaves

    def _grads(params, batch):
        """``steps._grads`` with the model reading ``Gathered(params)``:
        the gradients of the sharded leaves themselves."""
        leaves = tree_leaves(params)
        with torch.enable_grad():
            total, (ce, aux) = loss_fn(Gathered(params), batch, cfg,
                                       causal_mode=causal_mode)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return grads, ce.detach(), aux.detach()

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        rows = next(iter(batch.values())).to_local().shape[0]
        n = max(1, min(microbatches, rows))
        acc, ce, aux = None, 0.0, 0.0
        for i in range(n):
            mb = batch if n == 1 else \
                {key: microbatch(t, n, i) for key, t in batch.items()}
            g, c, a = _grads(params, mb)
            if n > 1:
                g = [x.float() for x in g]
            acc = g if acc is None else [s + x for s, x in zip(acc, g)]
            ce, aux = ce + c, aux + a
        if n > 1:
            acc = [s / n for s in acc]
            ce, aux = ce / n, aux / n
        leaves = tree_leaves(params)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(acc, leaves)]
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt_state["step"], peak_lr=peak_lr,
                             warmup=warmup, total=total_steps)
        with torch.no_grad():
            loc = lambda ts: [t.to_local() for t in ts]
            state = {"step": opt_state["step"].to_local(),
                     "m": loc(tree_leaves(opt_state["m"])),
                     "v": loc(tree_leaves(opt_state["v"]))}
            adamw_update(loc(grads), state, loc(leaves),
                         lr=lr.full_tensor())
        return params, opt_state, {"loss": ce, "aux": aux,
                                   "grad_norm": gnorm, "lr": lr}

    return train_step


def _greedy(logits):
    """Greedy ids of DTensor logits (B,1,V): the vocabulary gathered
    first (DTensor's own argmax over a sharded dim fails on a 3-D
    mesh)."""
    full = logits.redistribute(logits.device_mesh, batch_placements(logits))
    return full.argmax(-1).to(torch.int32)


def make_step(cfg: ModelConfig, kind: str, mesh, *,
              causal_mode: str = "masked_full", microbatches: int = 1):
    """The dry run's step function of ``kind`` ("train" | "prefill" |
    "decode") on DTensor arguments, run under DTensor's implicit
    replication (the plain tensors the model makes, positions and masks,
    count as replicated): ``steps``' train step (``make_train_step``), and
    its prefill (an encoder's encode step) and decode steps, their greedy
    ids from the gathered logits. The decode step writes the token at the
    caches' last slot (``cache_len`` = slots - 1) whatever its last
    argument holds."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.layers import unembed
    from repro_torch.models.model import forward_decode, forward_prefill
    from repro_torch.models.steps import make_prefill_step
    if kind == "train":
        step = make_train_step(cfg, causal_mode=causal_mode,
                               microbatches=microbatches)
    elif kind == "prefill" and cfg.is_encoder:
        step = make_prefill_step(cfg, causal_mode=causal_mode)
    elif kind == "prefill":
        @torch.no_grad()
        def step(params, batch):
            last_h, caches = forward_prefill(params, batch, cfg,
                                             causal_mode=causal_mode)
            logits = unembed(params["embed"], last_h)
            return _greedy(logits), caches, logits
    else:
        @torch.no_grad()
        def step(params, tokens, caches, cache_len):
            slots = [c[n].shape[2] for st in caches for c in st.values()
                     for n in ("k", "k8") if n in c]
            logits, caches = forward_decode(params, tokens, caches,
                                            min(slots, default=1) - 1, cfg)
            return _greedy(logits), caches, logits

    def run(params, *args):
        with implicit_replication():
            if kind != "train":       # the train step wraps its own
                params = Gathered(params)
            return step(params, *args)

    return run
