"""Mixture-of-Experts with the Pregelix dataflow mapping (see the JAX
package's ``models/moe.py``): routing is a join + group-by of (expert,
token) messages, with two physical group-by plans.

* ``scatter`` — hash group-by analogue: tokens scatter into per-expert
  capacity slots (overflow dropped); plain torch.
* ``sort`` — sort-based group-by: tokens stably argsorted by expert id
  and multiplied by a grouped matmul (the hand-written kernel on CUDA
  tensors, with its backward's dX through the same kernel; its plain
  version under autograd on CPU tensors). The paper-faithful plan.

Both train: the gates and the Switch-style aux loss carry gradients to
the router as ``_route`` gives them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.layers import apply_mlp, mlp_specs
from repro_torch.models import sharded
from repro_torch.models.param import Spec


def padded_experts(E: int, tp: int = 16) -> int:
    """The expert count padded to a multiple of 16 (qwen2's 60 -> 64), as
    the JAX package pads it for expert parallelism. Pad experts have no
    router column, so they are never selected."""
    return ((E + tp - 1) // tp) * tp


def moe_specs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_expert
    Ep = padded_experts(E)
    ep = ("model", None, None)          # experts sharded on "model"
    out = {
        "router": Spec((d, E), fan_in=d, dtype=torch.float32,
                       placement=(None, None)),
        "w_gate": Spec((Ep, d, f), fan_in=d, placement=ep),
        "w_up": Spec((Ep, d, f), fan_in=d, placement=ep),
        "w_down": Spec((Ep, f, d), fan_in=f, placement=ep),
    }
    if m.d_shared:
        out["shared"] = mlp_specs(d, m.d_shared)
    return out


def _route(p: dict, x: torch.Tensor, k: int):
    """Router in f32: softmax, top-k, renormalised gates, and the
    Switch-style load-balance aux loss."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)       # (B,S,k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    E = logits.shape[-1]
    me = probs.mean(dim=(0, 1))                      # (E,)
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (me * ce).sum()
    return gates, idx, aux


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """x: (B,S,d) -> (out, aux_loss)."""
    if sharded.is_dtensor(x):         # the dry run's sharded model
        return sharded.apply_moe(p, x, cfg)
    if cfg.moe.dispatch == "sort":
        return _apply_moe_sort(p, x, cfg)
    return _apply_moe_scatter(p, x, cfg)


def _apply_moe_scatter(p: dict, x: torch.Tensor, cfg: ModelConfig):
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    Ep = padded_experts(E)
    gates, idx, aux = _route(p, x, k)
    C = max(8, int(round(m.capacity_factor * S * k / E + 7)) // 8 * 8)
    C = min(C, S * k)
    T = S * k
    eid = idx.reshape(B, T)
    gat = gates.reshape(B, T)
    # position of each token within its expert's group (hash group-by)
    onehot = F.one_hot(eid, E)                       # (B,T,E)
    pos = torch.gather(onehot.cumsum(1), 2, eid[..., None])[..., 0] - 1
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, Ep * C)  # overflow -> drop row
    xe = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    bidx = torch.arange(B, device=x.device)[:, None]
    slot_tok = torch.full((B, Ep * C + 1), T, dtype=torch.long,
                          device=x.device)
    slot_tok[bidx, slot] = torch.arange(T, device=x.device).expand(B, T)
    xe_pad = torch.cat([xe, xe.new_zeros(B, 1, d)], dim=1)
    buf = torch.gather(xe_pad, 1, slot_tok[:, :Ep * C, None]
                       .expand(B, Ep * C, d)).reshape(B, Ep, C, d)
    g = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, p["w_up"])
    y = torch.einsum("becf,efd->becd", F.silu(g) * u, p["w_down"])
    y = torch.cat([y.reshape(B, Ep * C, d), y.new_zeros(B, 1, d)], dim=1)
    y_tok = y[bidx, slot] * (gat * keep)[..., None].to(y.dtype)
    out = y_tok.reshape(B, S, k, d).sum(dim=2)
    if m.d_shared:
        out = out + apply_mlp(p["shared"], x)
    return out, aux


def _apply_moe_sort(p: dict, x: torch.Tensor, cfg: ModelConfig):
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    gates, idx, aux = _route(p, x, k)
    T = B * S * k
    eid = idx.reshape(T)
    gat = gates.reshape(T)
    xe = x.reshape(B * S, d).repeat_interleave(k, dim=0)   # (T,d)
    order = torch.argsort(eid, stable=True)          # sort-based group-by
    xs = xe[order]
    group_sizes = torch.bincount(eid, minlength=padded_experts(E))
    g = gmm_ops.grouped_matmul(xs, p["w_gate"], group_sizes)
    u = gmm_ops.grouped_matmul(xs, p["w_up"], group_sizes)
    ys = gmm_ops.grouped_matmul(F.silu(g) * u, p["w_down"], group_sizes)
    y_tok = torch.empty_like(ys)
    y_tok[order] = ys                                # inverse permutation
    y_tok = y_tok * gat[:, None].to(ys.dtype)
    out = y_tok.reshape(B, S, k, d).sum(dim=2)
    if m.d_shared:
        out = out + apply_mlp(p["shared"], x)
    return out, aux
