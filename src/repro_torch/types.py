"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``repro/types.py`` (which imports no JAX): the
port keeps its own so that it never imports the reference package. Field
names, defaults and derived properties are identical, so a config built by
either package compares field for field (tests/test_torch_configs.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


# ---------------------------------------------------------------------------
# FedAttn protocol configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FedAttnConfig:
    """Configuration of the FedAttn collaborative-inference protocol.

    Attributes:
      n_participants: number of participants N (= sequence shards in the
        SPMD realization). ``1`` disables FedAttn (centralized attention).
      sync_interval: H, the number of local forwards per communication
        round. Sync layers are every H-th block (uniform schedule) unless
        ``schedule`` overrides.
      schedule: name of the sync schedule ('uniform', 'shallow_half',
        'deep_half', 'progressive', 'regressive', 'custom', 'none',
        'all'). 'none' == LocAttn (H=M); 'all' == CenAttn (H=1).
      kv_exchange_ratio: fraction of local KV rows each participant
        contributes at a sync layer (sparse KV exchange, eq. 37-38).
        1.0 == full exchange (eq. 20).
      kv_selection: how sparse-exchanged KVs are chosen:
        'random' | 'strided' | 'keynorm' | 'recency' | 'sink_recency'.
      local_sparsity: fraction of local tokens kept for local
        self-attention (sparse local attention, eq. 34). 1.0 == dense.
      kv_quant: wire/pool codec for sync-layer KV exchange and the paged
        pool: 'none' (f32/compute dtype), 'int8' (symmetric per-head
        scales) or 'fp8' (e4m3 emulation); the port runs 'none' only so far.
      publisher_index: which participant is the task publisher (poses the
        query, decodes the answer). Defaults to the last participant, as in
        the paper's experiments.
      causal: causal (decoder) vs bidirectional (encoder) attention.
    """

    n_participants: int = 1
    sync_interval: int = 1
    schedule: str = "uniform"
    kv_exchange_ratio: float = 1.0
    kv_selection: str = "random"
    kv_quant: str = "none"
    local_sparsity: float = 1.0
    publisher_index: int = -1
    causal: bool = True

    def __post_init__(self) -> None:
        if self.n_participants < 1:
            raise ValueError(f"n_participants must be >= 1, got {self.n_participants}")
        if self.sync_interval < 1:
            raise ValueError(f"sync_interval must be >= 1, got {self.sync_interval}")
        if not (0.0 < self.kv_exchange_ratio <= 1.0):
            raise ValueError("kv_exchange_ratio must be in (0, 1]")
        if not (0.0 < self.local_sparsity <= 1.0):
            raise ValueError("local_sparsity must be in (0, 1]")
        if self.kv_quant not in ("none", "int8", "fp8"):
            raise ValueError(
                f"kv_quant must be 'none', 'int8' or 'fp8', got {self.kv_quant!r}"
            )

    @property
    def enabled(self) -> bool:
        return self.n_participants > 1

    def replace(self, **kw: Any) -> "FedAttnConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Layer / model configuration
# ---------------------------------------------------------------------------

LAYER_KINDS = ("attn", "mamba", "rwkv")


@dataclass(frozen=True)
class LayerSpec:
    """One entry of a model's repeating layer pattern.

    Attributes:
      kind: 'attn' (softmax attention), 'mamba' (selective SSM), or
        'rwkv' (RWKV6 data-dependent-decay linear attention).
      window: sliding-window size for attention layers (None = full span).
      sync: whether this layer is a FedAttn sync (global attention /
        state-handoff) layer in scan mode.
      moe: whether this layer's FFN is a Mixture-of-Experts.
    """

    kind: str = "attn"
    window: Optional[int] = None
    sync: bool = False
    moe: bool = False

    def __post_init__(self) -> None:
        if self.kind not in LAYER_KINDS:
            raise ValueError(f"unknown layer kind {self.kind!r}")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture.

    The model is ``n_layers`` deep, built by repeating ``pattern``
    (a period of heterogeneous layers) ``n_layers // len(pattern)`` times;
    ``n_layers`` must be a multiple of ``len(pattern)`` unless
    ``pattern_remainder`` supplies the trailing layers.
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None  # default: d_model // n_heads

    # Repeating layer pattern (period). Default: all-attention dense.
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    pattern_remainder: tuple[LayerSpec, ...] = ()

    # Attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None  # for sliding-window layers
    qk_norm: bool = False
    attn_soft_cap: Optional[float] = None
    logit_soft_cap: Optional[float] = None

    # FFN
    ffn_activation: str = "swiglu"  # swiglu | gelu | relu

    # MoE
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_d_ff: Optional[int] = None  # expert hidden size (default d_ff)
    n_shared_experts: int = 0
    router_aux_loss_coef: float = 0.01

    # SSM (mamba) dims
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV dims
    rwkv_head_dim: int = 64

    # Encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    # Modality frontend (stub): 'none' | 'audio' | 'vision'
    frontend: str = "none"
    frontend_tokens: int = 0  # patches / frames occupying the sequence prefix

    # Norm & misc
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # FedAttn protocol defaults for this architecture
    fedattn: FedAttnConfig = field(default_factory=FedAttnConfig)

    # Citation / provenance for the assigned-architecture pool
    source: str = ""

    def __post_init__(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} must be a multiple of "
                f"n_kv_heads={self.n_kv_heads}"
            )
        period = len(self.pattern)
        body = self.n_layers - len(self.pattern_remainder)
        if body % period != 0:
            raise ValueError(
                f"{self.name}: n_layers-remainder ({body}) not a multiple of "
                f"pattern period ({period})"
            )

    # -- derived ------------------------------------------------------------

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding: embedding/head tables round the
        vocab up to a multiple of 512 so the vocab dim shards on any mesh
        axis combination (an unshardable vocab forces GSPMD to replicate
        every logits tensor — §Perf iteration 7). Logits columns >= vocab
        _size are masked to -inf by the head."""
        if self.vocab_size % 512 == 0 or self.vocab_size < 512:
            return self.vocab_size
        return self.vocab_size + (-self.vocab_size) % 512

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def n_periods(self) -> int:
        return (self.n_layers - len(self.pattern_remainder)) // len(self.pattern)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_specs(self) -> list[LayerSpec]:
        """Flat per-layer specs for the decoder stack (python-loop mode)."""
        specs = list(self.pattern) * self.n_periods + list(self.pattern_remainder)
        assert len(specs) == self.n_layers
        return specs

    def encoder_layer_specs(self) -> list[LayerSpec]:
        if not self.is_encoder_decoder:
            return []
        period = len(self.encoder_pattern)
        if self.n_encoder_layers % period != 0:
            raise ValueError("encoder layers not a multiple of encoder pattern")
        return list(self.encoder_pattern) * (self.n_encoder_layers // period)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, dh = self.d_model, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * (nq * dh) + 2 * d * (nkv * dh) + (nq * dh) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * dh
        if self.ffn_activation == "swiglu":
            dense_ffn = 3 * self.d_model * self.d_ff
            moe_ffn_per_e = 3 * self.d_model * self.expert_d_ff
        else:
            dense_ffn = 2 * self.d_model * self.d_ff
            moe_ffn_per_e = 2 * self.d_model * self.expert_d_ff

        def layer_params(spec: LayerSpec) -> int:
            if spec.kind == "attn":
                mix = attn
            elif spec.kind == "mamba":
                d_in = self.mamba_expand * d
                mix = (
                    d * 2 * d_in  # in_proj
                    + d_in * self.mamba_d_conv  # conv
                    + d_in * (self.mamba_d_state * 2 + 1)  # x_proj (B,C,dt)
                    + d_in  # dt_proj-ish (rank-collapsed)
                    + d_in * self.mamba_d_state  # A
                    + d_in  # D
                    + d_in * d  # out_proj
                )
            else:  # rwkv
                mix = 4 * d * d + 6 * d  # r,k,v,o projections + decays/mixers
            if spec.moe:
                ffn = self.n_experts * moe_ffn_per_e + d * self.n_experts
                ffn += self.n_shared_experts * moe_ffn_per_e
            else:
                ffn = dense_ffn
            return mix + ffn + 2 * d  # + norms

        total = sum(layer_params(s) for s in self.layer_specs())
        total += sum(layer_params(s) for s in self.encoder_layer_specs())
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE-aware) for 6·N_active·D."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        per_e = (3 if self.ffn_activation == "swiglu" else 2) * self.d_model * self.expert_d_ff
        inactive = 0
        for s in self.layer_specs() + self.encoder_layer_specs():
            if s.moe:
                inactive += (self.n_experts - self.n_experts_per_token) * per_e
        return full - inactive

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(config: ModelConfig, **overrides: Any) -> ModelConfig:
    """A smoke-test-sized variant of the same architecture family.

    Shrinks every size knob while preserving the structural features
    (pattern, GQA ratio, MoE top-k, enc-dec, frontend).
    """
    d_model = min(config.d_model, 256)
    n_heads = min(config.n_heads, 4)
    n_kv = max(1, n_heads // max(1, config.q_per_kv))
    n_experts = min(config.n_experts, 4) if config.is_moe else 0
    topk = min(config.n_experts_per_token, max(1, n_experts // 2)) if n_experts else 0
    period = len(config.pattern)
    n_layers = period if period > 1 else 2
    kw: dict[str, Any] = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=64 if config.d_head else None,
        d_ff=min(config.d_ff, 512),
        vocab_size=min(config.vocab_size, 512),
        n_experts=n_experts,
        n_experts_per_token=topk,
        moe_d_ff=min(config.expert_d_ff, 256) if config.is_moe else None,
        pattern_remainder=(),
        dtype="float32",
        mamba_d_state=8,
        frontend_tokens=min(config.frontend_tokens, 16),
    )
    if config.is_encoder_decoder:
        kw["n_encoder_layers"] = max(1, len(config.encoder_pattern))
    kw.update(overrides)
    return config.replace(**kw)
