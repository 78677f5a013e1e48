"""GQA softmax attention layer, FedAttn-aware.

Port of the JAX package's ``models/attention.py``, single-device path:
prefill, decode against a dense cache, and decode / verify against the
serving pool's paged (optionally quantized) KV. Depending on ``sync`` (from the SyncSchedule) the attention runs

  * Phase I  (local):  queries see only same-participant KV (eq. 18), or
  * Phase II (global): queries see the aggregated global KV (eq. 21),
    optionally thinned by the sparse-exchange contribution mask (eq. 37).

Both blocks call :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.aggregation import decode_exchange_mask
from repro_torch.core.fedattn import FedAttnContext
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.serving import paging, quant
from repro_torch.types import LayerSpec, ModelConfig

Params = dict


def init_attention(generator: torch.Generator, config: ModelConfig) -> Params:
    d, dh = config.d_model, config.head_dim
    nq, nkv = config.n_heads, config.n_kv_heads
    dt, dev = L.torch_dtype(config), generator.device
    p: Params = {
        "wq": L.dense_init(generator, (d, nq * dh), dt),
        "wk": L.dense_init(generator, (d, nkv * dh), dt),
        "wv": L.dense_init(generator, (d, nkv * dh), dt),
        "wo": L.dense_init(generator, (nq * dh, d), dt),
    }
    if config.qkv_bias:
        p["bq"] = torch.zeros((nq * dh,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((nkv * dh,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((nkv * dh,), dtype=dt, device=dev)
    if config.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=dev)
    return p


def _project_qkv(p: Params, x: torch.Tensor, config: ModelConfig, positions: torch.Tensor, rope_theta: float):
    B, S, _ = x.shape
    nq, nkv, dh = config.n_heads, config.n_kv_heads, config.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if config.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, nq, dh)
    k = k.reshape(B, S, nkv, dh)
    v = v.reshape(B, S, nkv, dh)
    if config.qk_norm:
        q = L.rms_head_norm(p["q_norm"], q, config.norm_eps)
        k = L.rms_head_norm(p["k_norm"], k, config.norm_eps)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


def _rope_theta_for(spec: LayerSpec, config: ModelConfig) -> float:
    if spec.window is not None and config.rope_theta_local is not None:
        return config.rope_theta_local
    return config.rope_theta


def attention_block(
    p: Params,
    x: torch.Tensor,  # (B, S, D) — normalized input
    ctx: FedAttnContext,
    layer_idx: int,
    spec: LayerSpec,
    config: ModelConfig,
    *,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Prefill attention over the whole sequence."""
    q, k, v = _project_qkv(p, x, config, ctx.positions, _rope_theta_for(spec, config))
    sync = ctx.schedule.is_sync(layer_idx)
    contributed = None
    if sync and ctx.contributed is not None:
        contributed = ctx.contributed[ctx._round_of_layer(layer_idx) % ctx.contributed.shape[0]]
    kv_pos = ctx.kv_positions if ctx.kv_positions is not None else ctx.positions
    kv_seg = ctx.kv_segments if ctx.kv_segments is not None else ctx.segments
    out = ops.attention(
        q, k, v,
        q_pos=ctx.positions,
        kv_pos=kv_pos,
        q_seg=ctx.segments if ctx.enabled else None,
        kv_seg=kv_seg if ctx.enabled else None,
        causal=ctx.config.causal,
        local_only=(not sync) and ctx.enabled,
        contributed=contributed,
        window=spec.window,
        soft_cap=config.attn_soft_cap,
        backend=backend,
    )
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"]


def attention_decode_block(
    p: Params,
    x: torch.Tensor,  # (B, S_new, D) — normalized input (usually S_new = 1)
    k_cache: torch.Tensor,  # (B, C, nkv, dh) dense, or (N, ps, nkv, dh) pool
    v_cache: torch.Tensor,
    cache_len,  # int, or (B,) per-row write frontiers
    ctx: FedAttnContext,  # built via for_decode_step
    layer_idx: int,
    spec: LayerSpec,
    config: ModelConfig,
    *,
    backend: Optional[str] = None,
    contributed: Optional[torch.Tensor] = None,
    pages: Optional[torch.Tensor] = None,
    kv_scales: Optional[tuple] = None,
    attn_mass: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode-step attention against the cache. Writes the new K/V rows
    IN PLACE (the JAX version returns updated copies; in place saves a
    cache copy per layer) BEFORE attending, so an ``S_new > 1`` verify
    block sees its own earlier rows while causality hides the later ones.

    ``cache_len`` is a scalar (the whole batch at one frontier) or a (B,)
    vector (continuous batching: each row at its own frontier; rows past
    the capacity drop). With a vector the context's vectors are per row.

    Paged pool: with ``pages`` ((B, P') int32 page tables), ``k_cache`` /
    ``v_cache`` are the shared (num_pages, page_size, nkv, dh) pool. New
    rows scatter through the tables — entries >= num_pages, and positions
    past the table, drop — and the read goes through
    :func:`repro_torch.kernels.ops.paged_decode_attention`. With
    ``kv_scales`` (the ``(sk, sv)`` scale pair of an int8/fp8 pool) the
    write re-encodes through the scale scatter-max
    (:func:`repro_torch.serving.quant.paged_write`) and the read
    dequantizes.

    ``attn_mass`` ((B, capacity) f32, paged pool only) accumulates this
    step's per-column softmax mass IN PLACE; at sync layers with
    ``kv_selection='attnmass'`` and a ratio below 1 it also derives this
    step's ``contributed`` mask when the caller supplied none.

    ``contributed`` is this layer's sparse-exchange row during bulk
    prefill-via-decode, (capacity,) shared or (B, capacity) per row."""
    q, k_new, v_new = _project_qkv(p, x, config, ctx.positions, _rope_theta_for(spec, config))
    B, S_new = x.shape[:2]
    if pages is not None:
        _paged_write(k_cache, v_cache, k_new, v_new, pages, cache_len, kv_scales)
    elif torch.is_tensor(cache_len) and cache_len.dim() == 1:
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S_new)
        cols = cache_len.to(x.device).long()[:, None] + torch.arange(S_new, device=x.device)[None, :]
        keep = cols < k_cache.shape[1]
        k_cache[rows[keep], cols[keep]] = k_new[keep].to(k_cache.dtype)
        v_cache[rows[keep], cols[keep]] = v_new[keep].to(v_cache.dtype)
    else:
        k_cache[:, cache_len:cache_len + S_new] = k_new.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + S_new] = v_new.to(v_cache.dtype)
    sync = ctx.schedule.is_sync(layer_idx)
    kw = dict(
        q_pos=ctx.positions,
        kv_pos=ctx.kv_positions,
        q_seg=ctx.segments if ctx.enabled else None,
        kv_seg=ctx.kv_segments if ctx.enabled else None,
        causal=True,
        local_only=(not sync) and ctx.enabled,
        window=spec.window,
        soft_cap=config.attn_soft_cap,
        backend=backend,
    )
    if pages is None:
        out = ops.decode_attention(
            q, k_cache, v_cache,
            contributed=contributed if (sync and ctx.enabled) else None, **kw,
        )
    else:
        fed = ctx.config
        want_mass = attn_mass is not None
        if (want_mass and sync and ctx.enabled and contributed is None
                and fed.kv_selection == "attnmass" and fed.kv_exchange_ratio < 1.0):
            contributed = decode_exchange_mask(attn_mass, fed.kv_exchange_ratio)
        k_scales, v_scales = kv_scales if kv_scales is not None else (None, None)
        out = ops.paged_decode_attention(
            q, k_cache, v_cache, pages,
            contributed=contributed if (sync and ctx.enabled) else None,
            k_scales=k_scales, v_scales=v_scales, return_mass=want_mass, **kw,
        )
        if want_mass:
            out, mass = out
            attn_mass += mass
    return out.reshape(B, S_new, -1) @ p["wo"]


def _paged_write(k_pool, v_pool, k_new, v_new, pages, cache_len, kv_scales) -> None:
    """Scatter a block's new K/V rows into the pool through the page tables,
    in place. Positions past the table are forced to the sentinel page so
    they drop instead of clamping into a real page."""
    N, ps = k_pool.shape[0], k_pool.shape[1]
    B, S_new = k_new.shape[:2]
    Cp = pages.shape[1] * ps
    dev = k_new.device
    pos = torch.as_tensor(cache_len, device=dev).reshape(-1, 1).long() + torch.arange(S_new, device=dev)
    pos = pos.expand(B, S_new)
    pslot, off = paging.page_split(torch.clamp(pos, max=Cp - 1), ps)
    page_idx = torch.gather(pages.long(), 1, pslot)
    page_idx = torch.where(pos < Cp, page_idx, N)
    if kv_scales is not None:
        quant.paged_write(k_pool, kv_scales[0], k_new, page_idx, off)
        quant.paged_write(v_pool, kv_scales[1], v_new, page_idx, off)
        return
    keep = page_idx < N
    k_pool[page_idx[keep], off[keep]] = k_new[keep].to(k_pool.dtype)
    v_pool[page_idx[keep], off[keep]] = v_new[keep].to(v_pool.dtype)
