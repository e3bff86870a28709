"""State-space layers: Mamba1 (the sequential selective scan) and Mamba2
(the SSD chunked matmul form), their decode states and single-token
steps, in plain torch.

The JAX package computes these in XLA with no Pallas kernel, so the port
runs them as torch operations on either device. The Mamba1 scan walks the
tokens one at a time inside chunks of 128, as ``_mamba1_scan`` does: each
chunk builds its decay ``exp(dt * A)`` and input terms at once (never the
whole sequence's, which at falcon-mamba-7b's width and batch 8 would be
8.6 GB a layer), then one fused multiply-add a token carries the state.
The SSD form takes any sequence length: a tail that does not fill a chunk
is padded with dt = 0 (decay 1, no input), which leaves the state as it
was. Both train under autograd as they stand; only the scan changes
with gradients on, keeping each token's state as a new tensor where
serving writes it in place. On ``meta`` tensors (the operator counter's
dry run) the Mamba1 scan's token loop is not walked: ``Mamba1ScanMeta``
returns its outputs' shapes and charges its work.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded
from repro_torch.models.param import Spec

SCAN_CHUNK = 128              # tokens a chunk of the Mamba1 scan
M = "model"                   # the tensor-parallel mesh axis

# ---------------------------------------------------------------------------
# Depthwise causal conv1d (k small; k shifted adds)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C), w: (C,k), b: (C)."""
    k = w.shape[1]
    S = x.shape[1]
    out = x * w[:, -1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[:, -1 - i]
    return out + b


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor):
    """Single decode step. x_t: (B,C); conv_state: (B,k-1,C) past
    inputs. -> (y (B,C), new conv_state)."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)      # (B,k,C)
    y = torch.einsum("bkc,ck->bc", full, w) + b
    return y, full[:, 1:]


def _conv_tail(a: torch.Tensor, k: int) -> torch.Tensor:
    """The last k inputs (B,k,C), zero-padded in front when S < k."""
    if a.shape[1] < k:
        return F.pad(a, (0, 0, k - a.shape[1], 0))
    return a[:, -k:]


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def mamba1_specs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    r = s.dt_rank or d // 16
    return {
        "in_proj": Spec((d, 2 * d_in), fan_in=d, placement=(None, M)),
        "conv_w": Spec((d_in, s.d_conv), init="normal", fan_in=s.d_conv,
                       placement=(M, None)),
        "conv_b": Spec((d_in,), "zeros", placement=(M,)),
        "x_proj": Spec((d_in, r + 2 * s.d_state), fan_in=d_in,
                       placement=(M, None)),
        "dt_proj": Spec((r, d_in), fan_in=r, placement=(None, M)),
        "dt_bias": Spec((d_in,), "ssm_dt_bias", dtype=torch.float32,
                        placement=(M,)),
        "A_log": Spec((d_in, s.d_state), "ssm_a_log", dtype=torch.float32,
                      placement=(M, None)),
        "D": Spec((d_in,), "ones", dtype=torch.float32, placement=(M,)),
        "out_proj": Spec((d_in, d), fan_in=d_in, placement=(M, None)),
    }


# the operator counter's by_op key of the Mamba1 scan on meta tensors
SCAN_META_OP = "mamba1_scan.meta"


class Mamba1ScanMeta(torch.autograd.Function):
    """The selective scan on meta tensors: y (B,S,d_in) and the final
    state (B,d_in,N) with no data, the work ``_mamba1_scan`` does charged
    to the running counter: a token's decay, input term, state update and
    output (about 8 flops an element of (B,S,d_in,N)), its chunk's decay
    and state terms written and read once in float32, the inputs read and
    y written once; the backward twice that."""

    @staticmethod
    def forward(ctx, A_log, D, xc, z, dt, Bc, Cc):
        from repro_torch.launch import op_cost
        B, S, d_in = xc.shape
        N = Bc.shape[-1]
        y = torch.empty((B, S, d_in), dtype=xc.dtype, device=xc.device)
        h = torch.empty((B, d_in, N), dtype=torch.float32, device=xc.device)
        io = sum(t.numel() * t.element_size()
                 for t in (A_log, D, xc, z, dt, Bc, Cc, y, h))
        ctx.cost = (float(io + 4 * 2 * B * S * d_in * N * 4),
                    8.0 * B * S * d_in * N)
        op_cost.charge(SCAN_META_OP, *ctx.cost)
        ctx.like = [(t.shape, t.dtype)
                    for t in (A_log, D, xc, z, dt, Bc, Cc)]
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        from repro_torch.launch import op_cost
        op_cost.charge(SCAN_META_OP + ".backward", 2 * ctx.cost[0],
                       2 * ctx.cost[1])
        return tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in ctx.like)


def _mamba1_scan(p, xc, z, dt, Bc, Cc, chunk: int = SCAN_CHUNK):
    """The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t =
    h_t . C_t, in float32, a chunk at a time. xc, z: (B,S,d_in); dt:
    (B,S,d_in) f32; Bc, Cc: (B,S,N). -> (y in xc's dtype, final state
    (B,d_in,N))."""
    if xc.device.type == "meta":
        return Mamba1ScanMeta.apply(p["A_log"], p["D"], xc, z, dt, Bc, Cc)
    A = -torch.exp(p["A_log"])                        # (d_in, N) f32
    B, S, d_in = xc.shape
    N = Bc.shape[-1]
    h = torch.zeros((B, d_in, N), dtype=torch.float32, device=xc.device)
    y = torch.empty((B, S, d_in), dtype=torch.float32, device=xc.device)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        dtc = dt[:, c0:c1].float().transpose(0, 1)            # (T,B,d_in)
        xcc = xc[:, c0:c1].float().transpose(0, 1)
        bcc = Bc[:, c0:c1].float().transpose(0, 1)            # (T,B,N)
        dA = torch.exp(dtc[..., None] * A)                    # (T,B,d_in,N)
        hs = (dtc * xcc)[..., None] * bcc[:, :, None, :]      # dBx, then h
        if torch.is_grad_enabled():
            # autograd keeps every state, so none is written in place
            states = []
            for t in range(c1 - c0):
                h = torch.addcmul(hs[t], dA[t], h)
                states.append(h)
            hs = torch.stack(states)
        else:
            for t in range(c1 - c0):
                h = hs[t].addcmul_(dA[t], h)
        y[:, c0:c1] = torch.einsum("tbdn,btn->btd", hs,
                                   Cc[:, c0:c1].float())
        del dA, hs
    y = y + xc.float() * p["D"]
    return (y * F.silu(z.float())).to(xc.dtype), h.clone()


def _mamba1_inputs(p, x, cfg):
    s = cfg.ssm
    r = s.dt_rank or cfg.d_model // 16
    xz = x @ p["in_proj"]
    x_, z = xz.chunk(2, dim=-1)
    xc = F.silu(causal_conv1d(x_, p["conv_w"], p["conv_b"]))
    proj = xc @ p["x_proj"]
    dt_r = proj[..., :r]
    Bc = proj[..., r:r + s.d_state]
    Cc = proj[..., r + s.d_state:]
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    return x_, z, xc, dt, Bc, Cc


def apply_mamba1(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The output alone, as ``repro.models.ssm.apply_mamba1`` gives it."""
    return apply_mamba1_with_state(p, x, cfg)[0]


def apply_mamba1_with_state(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,d) -> (out (B,S,d), decode state: the conv tail and the
    final recurrent state)."""
    if sharded.is_dtensor(x):         # the dry run's sharded model
        return sharded.apply_ssm(apply_mamba1_with_state, p, x, cfg)
    x_, z, xc, dt, Bc, Cc = _mamba1_inputs(p, x, cfg)
    y, h = _mamba1_scan(p, xc, z, dt, Bc, Cc)
    out = y @ p["out_proj"]
    return out, {"conv": _conv_tail(x_, cfg.ssm.d_conv - 1), "ssm": h}


def mamba1_init_state(cfg: ModelConfig, batch: int, dtype, device):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_in, s.d_state),
                               dtype=torch.float32, device=device)}


def apply_mamba1_decode(p: dict, x_t: torch.Tensor, state: dict,
                        cfg: ModelConfig):
    """x_t: (B,1,d). -> (y_t (B,1,d), new state)."""
    if sharded.is_dtensor(x_t):
        return sharded.apply_ssm(apply_mamba1_decode, p, x_t, cfg, state)
    s = cfg.ssm
    r = s.dt_rank or cfg.d_model // 16
    xz = (x_t @ p["in_proj"])[:, 0]
    x_, z = xz.chunk(2, dim=-1)
    xc, conv_state = conv1d_step(x_, state["conv"], p["conv_w"],
                                 p["conv_b"])
    xc = F.silu(xc)
    proj = xc @ p["x_proj"]
    dt_r, Bc, Cc = (proj[..., :r], proj[..., r:r + s.d_state],
                    proj[..., r + s.d_state:])
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., None] * Bc.float()[:, None, :]
    h = dA * state["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cc.float())
    y = y + xc.float() * p["D"]
    y = (y * F.silu(z.float())).to(x_t.dtype)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv": conv_state, "ssm": h}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_specs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    return {
        "wz": Spec((d, d_in), fan_in=d, placement=(None, M)),
        "wx": Spec((d, d_in), fan_in=d, placement=(None, M)),
        "wB": Spec((d, s.d_state), fan_in=d, placement=(None, None)),
        "wC": Spec((d, s.d_state), fan_in=d, placement=(None, None)),
        "wdt": Spec((d, H), fan_in=d, placement=(None, M)),
        "conv_w": Spec((d_in, s.d_conv), fan_in=s.d_conv,
                       placement=(M, None)),
        "conv_b": Spec((d_in,), "zeros", placement=(M,)),
        "convB_w": Spec((s.d_state, s.d_conv), fan_in=s.d_conv,
                        placement=(None, None)),
        "convB_b": Spec((s.d_state,), "zeros", placement=(None,)),
        "convC_w": Spec((s.d_state, s.d_conv), fan_in=s.d_conv,
                        placement=(None, None)),
        "convC_b": Spec((s.d_state,), "zeros", placement=(None,)),
        "dt_bias": Spec((H,), "ssm_dt_bias", dtype=torch.float32,
                        placement=(M,)),
        "A_log": Spec((H,), "ssm_a_log", dtype=torch.float32,
                      placement=(M,)),
        "D": Spec((H,), "ones", dtype=torch.float32, placement=(M,)),
        "norm_scale": Spec((d_in,), "ones", dtype=torch.float32,
                           placement=(M,)),
        "out_proj": Spec((d_in, d), fan_in=d_in, placement=(M, None)),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L): out[t, s] = sum_{r=s+1..t} x[r] for t
    >= s, -inf otherwise."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(xh, dt, A, Bc, Cc, chunk: int, init_state=None):
    """SSD (mamba2) chunked scan. xh: (B,S,H,Ph) head inputs; dt: (B,S,H)
    (post-softplus, f32); A: (H,) negative decay (f32); Bc/Cc: (B,S,N).
    -> (y (B,S,H,Ph) f32, final_state (B,H,Ph,N)). S need not be a
    multiple of ``chunk``: the tail is padded with dt = 0 and zero inputs,
    which leave the state unchanged, and its outputs dropped."""
    Bsz, S, H, Ph = xh.shape
    N = Bc.shape[-1]
    pad = -S % chunk
    if pad:
        xh, dt, Bc, Cc = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                          for t in (xh, dt, Bc, Cc))
    nc = (S + pad) // chunk
    L = chunk
    xc = xh.reshape(Bsz, nc, L, H, Ph).float()
    dtc = dt.reshape(Bsz, nc, L, H).float()
    Bcc = Bc.reshape(Bsz, nc, L, N).float()
    Ccc = Cc.reshape(Bsz, nc, L, N).float()
    dA = dtc * A                                    # (B,nc,L,H)
    dAh = dA.permute(0, 1, 3, 2)                    # (B,nc,H,L)
    cum = torch.cumsum(dAh, dim=-1)                 # (B,nc,H,L)
    # --- intra-chunk (diagonal blocks) ---
    Lmat = torch.exp(_segsum(dAh))                  # (B,nc,H,L,L)
    scores = torch.einsum("bcln,bcsn->bcls", Ccc, Bcc)
    G = scores[:, :, None] * Lmat                   # (B,nc,H,L,L)
    del Lmat
    xdt = xc * dtc[..., None]                       # (B,nc,L,H,Ph)
    y_diag = torch.einsum("bchls,bcshp->bclhp", G, xdt)
    del G
    # --- per-chunk end states ---
    decay_to_end = torch.exp(cum[..., -1:] - cum)   # (B,nc,H,L)
    st = torch.einsum("bchl,bcln,bclhp->bchpn", decay_to_end, Bcc, xdt)
    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(cum[..., -1])           # (B,nc,H)
    carry = (torch.zeros((Bsz, H, Ph, N), dtype=torch.float32,
                         device=xh.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)                          # state BEFORE chunk c
        carry = chunk_decay[:, c, :, None, None] * carry + st[:, c]
    prev_states = torch.stack(prev, dim=1)          # (B,nc,H,Ph,N)
    # --- off-diagonal contribution from previous chunks ---
    decay_from_start = torch.exp(cum)               # (B,nc,H,L)
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", Ccc, prev_states,
                         decay_from_start)
    y = (y_diag + y_off).reshape(Bsz, nc * L, H, Ph)[:, :S]
    return y, carry


def _mamba2_inputs(p, x, cfg):
    z = x @ p["wz"]
    xi = x @ p["wx"]
    Bi = x @ p["wB"]
    Ci = x @ p["wC"]
    dti = x @ p["wdt"]
    return z, xi, Bi, Ci, dti


def _mamba2_out(p, y, xh, z, x_dtype, cfg):
    """D skip, the silu(z) gate and the gated RMSNorm, then out_proj."""
    d_in = cfg.ssm.expand * cfg.d_model
    y = y + xh.float() * p["D"][:, None]
    y = y.reshape(*y.shape[:-2], d_in)
    y = y * F.silu(z.float())
    ms = y.square().mean(-1, keepdim=True)
    y = (y * torch.rsqrt(ms + 1e-6) * p["norm_scale"]).to(x_dtype)
    return y @ p["out_proj"]


def apply_mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The output alone, as ``repro.models.ssm.apply_mamba2`` gives it."""
    return apply_mamba2_with_state(p, x, cfg)[0]


def apply_mamba2_with_state(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,d) -> (out (B,S,d), decode state: the three conv tails and
    the final SSD state)."""
    if sharded.is_dtensor(x):
        return sharded.apply_ssm(apply_mamba2_with_state, p, x, cfg)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    z, xi, Bi, Ci, dti = _mamba2_inputs(p, x, cfg)
    xc = F.silu(causal_conv1d(xi, p["conv_w"], p["conv_b"]))
    Bc = F.silu(causal_conv1d(Bi, p["convB_w"], p["convB_b"]))
    Cc = F.silu(causal_conv1d(Ci, p["convC_w"], p["convC_b"]))
    dt = F.softplus(dti.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(*xc.shape[:2], H, s.head_dim)
    y, final = ssd_chunked(xh, dt, A, Bc, Cc, min(s.chunk, x.shape[1]))
    out = _mamba2_out(p, y, xh, z, x.dtype, cfg)
    k = s.d_conv - 1
    return out, {"conv_x": _conv_tail(xi, k), "conv_B": _conv_tail(Bi, k),
                 "conv_C": _conv_tail(Ci, k), "ssm": final}


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype, device):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    return {"conv_x": z(batch, s.d_conv - 1, d_in),
            "conv_B": z(batch, s.d_conv - 1, s.d_state),
            "conv_C": z(batch, s.d_conv - 1, s.d_state),
            "ssm": z(batch, H, s.head_dim, s.d_state, dt=torch.float32)}


def apply_mamba2_decode(p: dict, x_t: torch.Tensor, state: dict,
                        cfg: ModelConfig):
    """x_t: (B,1,d). -> (y_t (B,1,d), new state)."""
    if sharded.is_dtensor(x_t):
        return sharded.apply_ssm(apply_mamba2_decode, p, x_t, cfg, state)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    z, xi, Bi, Ci, dti = _mamba2_inputs(p, x_t[:, 0], cfg)
    xc, cx = conv1d_step(xi, state["conv_x"], p["conv_w"], p["conv_b"])
    Bc, cB = conv1d_step(Bi, state["conv_B"], p["convB_w"], p["convB_b"])
    Cc, cC = conv1d_step(Ci, state["conv_C"], p["convC_w"], p["convC_b"])
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)
    dt = F.softplus(dti.float() + p["dt_bias"])              # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                   # (B,H)
    xh = xc.reshape(-1, H, s.head_dim).float()
    dBx = (dt[..., None] * xh)[..., None] * Bc.float()[:, None, None, :]
    h = dA[..., None, None] * state["ssm"] + dBx             # (B,H,Ph,N)
    y = torch.einsum("bhpn,bn->bhp", h, Cc.float())
    out = _mamba2_out(p, y, xh, z, x_t.dtype, cfg)[:, None]
    return out, {"conv_x": cx, "conv_B": cB, "conv_C": cC, "ssm": h}
