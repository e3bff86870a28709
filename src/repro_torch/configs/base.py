"""Model / run configuration system (a copy of the JAX package's).

Every assigned architecture pins an exact published shape via ``ModelConfig``.
``reduced()`` produces the same-family tiny config used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    d_shared: int = 0             # shared-expert FFN hidden size (0 = none)
    every_k_layers: int = 1       # MoE layer every k layers (1 = all layers)
    capacity_factor: float = 1.25
    dispatch: str = "einsum"      # "einsum" (GShard-style) | "sort" (group-by)


@dataclass(frozen=True)
class SSMConfig:
    kind: str                     # "mamba1" | "mamba2"
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 only
    dt_rank: int = 0              # mamba1 only; 0 -> d_model // 16
    chunk: int = 128              # mamba2 SSD chunk length


@dataclass(frozen=True)
class AttnConfig:
    # layer attention pattern, cycled over depth: "global" | "local"
    pattern: tuple = ("global",)
    window: int = 4096            # sliding window for "local" layers
    causal: bool = True           # False for encoder-only archs


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int                     # dense FFN hidden (0 = no FFN, e.g. mamba)
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    norm: str = "rmsnorm"
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): ssm backbone with a shared attn+mlp block
    # applied every `shared_attn_every` layers (0 = never)
    shared_attn_every: int = 0
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_len: int = 0         # prepended frontend positions (vision)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    rope_theta: float = 10000.0
    source: str = ""              # provenance note [source; tier]

    # ---- derived --------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_encoder(self) -> bool:
        return not self.attn.causal

    def layer_kind(self, i: int) -> str:
        """'attn_global' | 'attn_local' | 'ssm' for backbone layer i."""
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            return "ssm"
        pat = self.attn.pattern
        return "attn_" + pat[i % len(pat)]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.every_k_layers) == (self.moe.every_k_layers - 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND rooflines."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embedding (tied output head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "ssm":
                n += _ssm_params(self, self.ssm)
            else:
                n += _attn_params(d, self.num_heads, self.num_kv_heads, hd)
            if self.moe is not None and self.is_moe_layer(i):
                m = self.moe
                n += m.num_experts * 3 * d * m.d_expert
                if m.d_shared:
                    n += 3 * d * m.d_shared
                n += d * m.num_experts  # router
            elif self.d_ff:
                n += 3 * d * self.d_ff  # SwiGLU
            n += 2 * d  # norms
        if self.shared_attn_every:
            # one shared attn+mlp block (zamba2-style)
            n += _attn_params(d, self.num_heads, self.num_kv_heads, hd)
            n += 3 * d * self.d_ff + 2 * d
        if self.frontend == "vision":
            n += d * d  # projector
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k); for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        inactive = n_moe_layers * (m.num_experts - m.top_k) * 3 * d * m.d_expert
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, 8),
                top_k=min(moe.top_k, 2), d_expert=64,
                d_shared=64 if moe.d_shared else 0)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=min(ssm.d_state, 16),
                                      head_dim=32, chunk=16)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4) if not self.shared_attn_every
            else 4,
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            moe=moe, ssm=ssm,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_len=min(self.frontend_len, 8),
            dtype="float32",
        )


def _attn_params(d: int, h: int, kv: int, hd: int) -> int:
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def _ssm_params(cfg: ModelConfig, s: SSMConfig) -> int:
    d = cfg.d_model
    d_in = s.expand * d
    if s.kind == "mamba1":
        dt_rank = s.dt_rank or d // 16
        n = 2 * d * d_in                    # in_proj (x, z)
        n += d_in * s.d_conv                # conv
        n += d_in * (dt_rank + 2 * s.d_state)  # x_proj -> (dt, B, C)
        n += dt_rank * d_in + d_in          # dt_proj
        n += d_in * s.d_state + d_in        # A_log, D
        n += d_in * d                       # out_proj
        return n
    # mamba2
    nheads = d_in // s.head_dim
    n = d * (2 * d_in + 2 * s.d_state + nheads)  # in_proj (z,x,B,C,dt)
    n += (d_in + 2 * s.d_state) * s.d_conv
    n += nheads * 2                          # A_log, D
    n += d_in * d                            # out_proj
    return n


# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def runnable_cells(cfg: ModelConfig) -> dict:
    """Which of the four shape cells run for this arch; value = reason if
    skipped else None."""
    out = {}
    subquadratic = (
        cfg.family in ("ssm", "hybrid")
        or "local" in cfg.attn.pattern
    )
    for name, cell in SHAPES.items():
        reason = None
        if cell.kind == "decode" and cfg.is_encoder:
            reason = "encoder-only arch: no decode step"
        elif name == "long_500k" and not subquadratic:
            reason = "pure full-attention arch: long_500k needs sub-quadratic attention"
        out[name] = reason
    return out


# registry populated by configs/__init__.py
REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        import repro_torch.configs  # noqa: F401  (populate registry)
    return REGISTRY[name]
