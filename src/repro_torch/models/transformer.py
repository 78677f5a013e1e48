"""Decoder-only TransformerLM of the port — dense GQA attention stacks.

Port of the JAX package's ``models/transformer.py`` in loop mode for
``kind="attn"`` layers with a dense FFN. (Scan mode exists in JAX only to
bound traced-program size and has no PyTorch counterpart.) Parameters are
plain nested dicts of tensors with the JAX tree's paths and layouts:
``embed/tok``, ``layers/i/{norm1,attn,norm2,ffn}``, ``final_norm``, ``head``.

Decode caches are per-layer dicts updated in place: dense ``k``/``v``
(B, capacity, nkv, dh), or the serving pool's paged leaves — ``pk``/``pv``
(num_pages, page_size, nkv, dh) shared by every slot, ``sk``/``sv``
(num_pages, nkv) f32 scales of an int8/fp8 pool, and ``am`` (slots,
capacity) f32, the 'attnmass' accumulator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.fedattn import FedAttnContext
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.serving import quant
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


def init_paged_layer_cache(
    config: ModelConfig, batch: int, num_pages: int, page_size: int, dtype, device,
    kv_quant: Optional[str] = None, mass_width: Optional[int] = None,
) -> Params:
    """One attention layer's share of the serving pool: ``pk``/``pv``
    (num_pages, page_size, nkv, dh), no batch dim — slots address it
    through page tables. With ``kv_quant`` ('int8'/'fp8') the pool holds
    codes plus ``sk``/``sv`` (num_pages, nkv) f32 scales; with
    ``mass_width`` (the slot capacity, for the 'attnmass' policy) an ``am``
    (batch, mass_width) f32 accumulator rides along."""
    shape = (num_pages, page_size, config.n_kv_heads, config.head_dim)
    sd = quant.storage_dtype(kv_quant)
    c = {
        "pk": torch.zeros(shape, dtype=sd or dtype, device=device),
        "pv": torch.zeros(shape, dtype=sd or dtype, device=device),
    }
    if sd is not None:
        c["sk"] = torch.zeros((num_pages, config.n_kv_heads), dtype=torch.float32, device=device)
        c["sv"] = torch.zeros((num_pages, config.n_kv_heads), dtype=torch.float32, device=device)
    if mass_width is not None:
        c["am"] = torch.zeros((batch, mass_width), dtype=torch.float32, device=device)
    return c


def init_paged_cache(
    config: ModelConfig, batch: int, num_pages: int, page_size: int, *, device,
    kv_quant: Optional[str] = None, mass_width: Optional[int] = None,
) -> list[Params]:
    """Block-paged decode caches, one :func:`init_paged_layer_cache` per
    layer."""
    return [
        init_paged_layer_cache(
            config, batch, num_pages, page_size, L.torch_dtype(config), device,
            kv_quant, mass_width,
        )
        for _ in config.layer_specs()
    ]


def _scatter_pool(pool: torch.Tensor, dense: torch.Tensor, dst_pages: torch.Tensor) -> None:
    """Write dense per-slot caches (B, P'*ps, nkv, dh) into the pool at
    ``dst_pages`` (B, P'), in place; sentinel entries drop, so padding
    beyond a slot's allocation never lands."""
    N, ps = pool.shape[0], pool.shape[1]
    B, Pp = dst_pages.shape
    blk = dense.reshape(B * Pp, ps, *dense.shape[2:])
    idx = dst_pages.reshape(-1).long()
    keep = idx < N
    pool[idx[keep]] = blk[keep].to(pool.dtype)


def _scatter_pool_quant(pool, scales, dense, dst_pages) -> None:
    """Quantized :func:`_scatter_pool`: each written page quantize-RESETS
    (:func:`repro_torch.serving.quant.quantize_block`) and codes and scales
    scatter with the same drop rule, so shared prefix pages (kept at the
    sentinel by admission) stay immutable."""
    N, ps = pool.shape[0], pool.shape[1]
    B, Pp = dst_pages.shape
    idx = dst_pages.reshape(-1).long()
    keep = idx < N
    blk = dense.reshape(B * Pp, ps, *dense.shape[2:])[keep]
    codes, s = quant.quantize_block(blk, pool.dtype)
    pool[idx[keep]] = codes
    scales[idx[keep]] = s


def gather_paged_cache(cache: list[Params], pages: torch.Tensor) -> list[Params]:
    """Dense transient caches (B, P'*ps, nkv, dh) of a batch of slots,
    gathered through ``pages`` (B, P'); quantized pools dequantize to f32
    inside the gather (the suffix prefill of prefix-cache hits)."""
    return [
        {"k": ops._gather_pages(c["pk"], pages, c.get("sk")),
         "v": ops._gather_pages(c["pv"], pages, c.get("sv"))}
        for c in cache
    ]


def paged_slot_write(cache: list[Params], batch: list[Params], dst_pages: torch.Tensor,
                     slots: torch.Tensor) -> None:
    """Write an admitted group's dense transient caches into the pool in
    place: K/V page blocks at ``dst_pages`` ((B, P') int32, sentinel entries
    drop); the admitted slots' ``am`` rows restart at zero (``slots`` (B,),
    out-of-range padding rows drop)."""
    for pc, bc in zip(cache, batch):
        if "sk" in pc:
            _scatter_pool_quant(pc["pk"], pc["sk"], bc["k"], dst_pages)
            _scatter_pool_quant(pc["pv"], pc["sv"], bc["v"], dst_pages)
        else:
            _scatter_pool(pc["pk"], bc["k"], dst_pages)
            _scatter_pool(pc["pv"], bc["v"], dst_pages)
        if "am" in pc:
            rows = slots[slots < pc["am"].shape[0]].long()
            pc["am"][rows] = 0.0


def apply_layer_decode(
    p: Params,
    cache: Params,
    x: torch.Tensor,  # (B, S_new, D)
    cache_len,  # int, or (B,) per-row frontiers
    ctx: FedAttnContext,  # decode-step context
    layer_idx: int,
    spec: LayerSpec,
    config: ModelConfig,
    *,
    backend: Optional[str] = None,
    contributed: Optional[torch.Tensor] = None,
    pages: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode block; writes this layer's new K/V rows into ``cache``
    in place (dense ``k``/``v``, or through ``pages`` into the pool's
    ``pk``/``pv``). ``contributed`` is the layer's sparse-exchange row
    during bulk prefill-via-decode."""
    h = L.apply_norm(p["norm1"], x, config)
    if "pk" in cache:
        kv_scales = (cache["sk"], cache["sv"]) if "sk" in cache else None
        o = A.attention_decode_block(
            p["attn"], h, cache["pk"], cache["pv"], cache_len, ctx, layer_idx, spec,
            config, backend=backend, contributed=contributed, pages=pages,
            kv_scales=kv_scales, attn_mass=cache.get("am"),
        )
    else:
        o = A.attention_decode_block(
            p["attn"], h, cache["k"], cache["v"], cache_len, ctx, layer_idx, spec,
            config, backend=backend, contributed=contributed,
        )
    x = x + o
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
        cache_len,  # int, or (B,) per-row frontiers
        ctx: FedAttnContext,  # prefill-shaped context; converted internally
        step: int = 0,
        *,
        backend: Optional[str] = None,
        dctx: Optional[FedAttnContext] = None,
        pages: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One autoregressive step; returns logits (B, S_new, V) and updates
        ``cache`` in place. Callers running a decode loop pass ``dctx``, a
        context advanced from ``ctx.decode_template(capacity)``.

        Continuous batching: ``cache_len`` may be a (B,) vector — each row
        (pool slot) writes at its own frontier — with per-row (B, S_new)
        positions/segments and (B, capacity) kv vectors in ``dctx``. With
        ``pages`` ((B, P') int32) the attention caches are the shared paged
        pool. ``S_new > 1`` with a vector ``cache_len`` is one speculative
        verify block: every layer writes all rows before attending."""
        cfg = self.config
        x = self._embed(params, tokens)
        if dctx is None:
            dctx = ctx.for_decode_step(cache[0]["k"].shape[1], step)
        for m, (p, spec) in enumerate(zip(params["layers"], cfg.layer_specs())):
            x = apply_layer_decode(
                p, cache[m], x, cache_len, dctx, m, spec, cfg, backend=backend, pages=pages,
            )
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.apply_lm_head(params["head"], params["embed"], x, cfg)
