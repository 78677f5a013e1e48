"""Shared neural-net layers of the port: norms, RoPE, FFN, embeddings, head.

Port of the JAX package's ``models/layers.py`` (dense path). Functions on
tensors over plain parameter dicts; weights keep the JAX ``(in, out)``
layout so the weight bridge is a copy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.core import NEG_INF
from repro_torch.types import ModelConfig

Params = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(config: ModelConfig) -> torch.dtype:
    return _DTYPES[config.dtype]


def dense_init(
    generator: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Truncated-normal fan-in init on the generator's device: N(0, 1)
    truncated to [-2, 2], times ``scale`` (default ``fan_in ** -0.5``)."""
    std = scale if scale is not None else shape[0] ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(config: ModelConfig, device) -> Params:
    d, dt = config.d_model, torch_dtype(config)
    p = {"scale": torch.ones((d,), dtype=dt, device=device)}
    if config.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """RMSNorm or LayerNorm, computed in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    if config.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + config.norm_eps)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + config.norm_eps)
        y = y + p["bias"].to(torch.float32)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm for QK-norm. x: (..., d_head)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX split-half rotary embedding. x: (..., L, n_heads, d_head);
    positions: (L,) or (..., L)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions.to(torch.float32)[..., :, None] * freqs  # (..., L, d/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., L, 1, d/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN (dense)
# ---------------------------------------------------------------------------


def init_ffn(generator: torch.Generator, config: ModelConfig) -> Params:
    d, f, dt = config.d_model, config.d_ff, torch_dtype(config)
    if config.ffn_activation == "swiglu":
        return {
            "w_gate": dense_init(generator, (d, f), dt),
            "w_up": dense_init(generator, (d, f), dt),
            "w_down": dense_init(generator, (f, d), dt),
        }
    return {"w_up": dense_init(generator, (d, f), dt), "w_down": dense_init(generator, (f, d), dt)}


def apply_ffn(p: Params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """SwiGLU (SiLU in f32) or GELU/ReLU FFN."""
    if config.ffn_activation == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = x @ p["w_up"]
        # jax.nn.gelu defaults to the tanh approximation
        act = (lambda t: F.gelu(t, approximate="tanh")) if config.ffn_activation == "gelu" else F.relu
        h = act(h.to(torch.float32)).to(x.dtype)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def init_embedding(generator: torch.Generator, config: ModelConfig) -> Params:
    # padded_vocab: extra rows are never indexed (token ids < vocab_size)
    shape = (config.padded_vocab, config.d_model)
    return {"tok": dense_init(generator, shape, torch_dtype(config), scale=1.0)}


def embed_tokens(p: Params, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    x = p["tok"][tokens.long()]
    # sqrt(d) embedding scale under rmsnorm, as in the JAX package
    if config.norm == "rmsnorm":
        x = x * torch.tensor(math.sqrt(config.d_model), dtype=x.dtype, device=x.device)
    return x


def init_lm_head(generator: torch.Generator, config: ModelConfig) -> Params:
    if config.tie_embeddings:
        return {}
    shape = (config.d_model, config.padded_vocab)
    return {"w": dense_init(generator, shape, torch_dtype(config))}


def apply_lm_head(head: Params, embed: Params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Logits in f32 over exactly ``vocab_size`` columns: tied or untied
    head, optional logit soft-cap, padded-vocab columns masked to NEG_INF
    and sliced away."""
    if config.tie_embeddings:
        logits = x @ embed["tok"].T
    else:
        logits = x @ head["w"]
    logits = logits.to(torch.float32)
    if config.logit_soft_cap:
        c = config.logit_soft_cap
        logits = torch.tanh(logits / c) * c
    Vp, V = config.padded_vocab, config.vocab_size
    if Vp != V:
        col = torch.arange(Vp, device=logits.device)
        logits = torch.where(col < V, logits, NEG_INF)[..., :V]
    return logits
