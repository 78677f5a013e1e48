"""Decoder-only TransformerLM of the port — dense GQA attention stacks.

Port of the JAX package's ``models/transformer.py`` in loop mode for
``kind="attn"`` layers with a dense FFN. (Scan mode exists in JAX only to
bound traced-program size and has no PyTorch counterpart.) Parameters are
plain nested dicts of tensors with the JAX tree's paths and layouts:
``embed/tok``, ``layers/i/{norm1,attn,norm2,ffn}``, ``final_norm``, ``head``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.fedattn import FedAttnContext
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.types import LayerSpec, ModelConfig

Params = dict


def check_supported(config: ModelConfig) -> None:
    """Raise unless every layer is what the port runs so far: softmax
    attention with a dense FFN, decoder-only, no modality frontend."""
    bad = [s for s in config.layer_specs() if s.kind != "attn" or s.moe]
    if bad or config.is_encoder_decoder or config.frontend != "none":
        raise NotImplementedError(
            f"{config.name}: the port runs dense attention-only decoders so far"
        )


def init_layer(generator: torch.Generator, spec: LayerSpec, config: ModelConfig) -> Params:
    dev = generator.device
    return {
        "norm1": L.init_norm(config, dev),
        "attn": A.init_attention(generator, config),
        "norm2": L.init_norm(config, dev),
        "ffn": L.init_ffn(generator, config),
    }


def apply_layer(
    p: Params,
    x: torch.Tensor,
    ctx: FedAttnContext,
    layer_idx: int,
    spec: LayerSpec,
    config: ModelConfig,
    *,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """One pre-LN block (eq. 19 update rule)."""
    h = L.apply_norm(p["norm1"], x, config)
    x = x + A.attention_block(p["attn"], h, ctx, layer_idx, spec, config, backend=backend)
    h2 = L.apply_norm(p["norm2"], x, config)
    return x + L.apply_ffn(p["ffn"], h2, config)


def init_layer_cache(config: ModelConfig, batch: int, capacity: int, dtype, device) -> Params:
    shape = (batch, capacity, config.n_kv_heads, config.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def apply_layer_decode(
    p: Params,
    cache: Params,
    x: torch.Tensor,  # (B, S_new, D)
    cache_len: int,
    ctx: FedAttnContext,  # decode-step context
    layer_idx: int,
    spec: LayerSpec,
    config: ModelConfig,
    *,
    backend: Optional[str] = None,
    contributed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode block; writes this layer's new K/V rows into ``cache``
    in place. ``contributed`` is the layer's sparse-exchange row during
    bulk prefill-via-decode."""
    h = L.apply_norm(p["norm1"], x, config)
    x = x + A.attention_decode_block(
        p["attn"], h, cache["k"], cache["v"], cache_len, ctx, layer_idx, spec,
        config, backend=backend, contributed=contributed,
    )
    h2 = L.apply_norm(p["norm2"], x, config)
    return x + L.apply_ffn(p["ffn"], h2, config)


@dataclass(frozen=True)
class TransformerLM:
    config: ModelConfig

    def __post_init__(self) -> None:
        check_supported(self.config)

    def init(self, generator: torch.Generator) -> Params:
        """Random weights on ``generator.device``, drawn in a fixed order
        from the explicit generator (not JAX's bits: tests that compare with
        the JAX package go through :mod:`repro_torch.checkpoint.bridge`)."""
        cfg = self.config
        dev = generator.device
        return {
            "embed": L.init_embedding(generator, cfg),
            "layers": [init_layer(generator, s, cfg) for s in cfg.layer_specs()],
            "final_norm": L.init_norm(cfg, dev),
            "head": L.init_lm_head(generator, cfg),
        }

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_tokens(params["embed"], tokens, self.config)

    def apply(
        self,
        params: Params,
        tokens: torch.Tensor,  # (B, L)
        ctx: FedAttnContext,
        *,
        backend: Optional[str] = None,
    ) -> torch.Tensor:
        """Logits (B, L, V) of the prefill/training forward."""
        cfg = self.config
        x = self._embed(params, tokens)
        for m, (p, spec) in enumerate(zip(params["layers"], cfg.layer_specs())):
            x = apply_layer(p, x, ctx, m, spec, cfg, backend=backend)
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.apply_lm_head(params["head"], params["embed"], x, cfg)

    def init_cache(self, batch: int, capacity: int, *, device) -> list[Params]:
        """Per-layer dense KV caches, zero-filled, in the config dtype."""
        dt = L.torch_dtype(self.config)
        return [
            init_layer_cache(self.config, batch, capacity, dt, device)
            for _ in self.config.layer_specs()
        ]

    def decode_step(
        self,
        params: Params,
        cache: list[Params],
        tokens: torch.Tensor,  # (B, S_new)
        cache_len: int,
        ctx: FedAttnContext,  # prefill-shaped context; converted internally
        step: int = 0,
        *,
        backend: Optional[str] = None,
        dctx: Optional[FedAttnContext] = None,
    ) -> torch.Tensor:
        """One autoregressive step; returns logits (B, S_new, V) and updates
        ``cache`` in place. Callers running a decode loop pass ``dctx``, a
        context advanced from ``ctx.decode_template(capacity)``."""
        cfg = self.config
        x = self._embed(params, tokens)
        if dctx is None:
            dctx = ctx.for_decode_step(cache[0]["k"].shape[1], step)
        for m, (p, spec) in enumerate(zip(params["layers"], cfg.layer_specs())):
            x = apply_layer_decode(p, cache[m], x, cache_len, dctx, m, spec, cfg, backend=backend)
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.apply_lm_head(params["head"], params["embed"], x, cfg)
