"""GQA softmax attention layer, FedAttn-aware.

Port of the JAX package's ``models/attention.py``, single-device dense-cache
path. Depending on ``sync`` (from the SyncSchedule) the attention runs

  * Phase I  (local):  queries see only same-participant KV (eq. 18), or
  * Phase II (global): queries see the aggregated global KV (eq. 21),
    optionally thinned by the sparse-exchange contribution mask (eq. 37).

Both blocks call :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fedattn import FedAttnContext
from repro_torch.kernels import ops
from repro_torch.models import layers as L
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
    k_cache: torch.Tensor,  # (B, C, nkv, dh)
    v_cache: torch.Tensor,
    cache_len: int,  # number of valid cache slots; the new rows go there
    ctx: FedAttnContext,  # built via for_decode_step
    layer_idx: int,
    spec: LayerSpec,
    config: ModelConfig,
    *,
    backend: Optional[str] = None,
    contributed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode-step attention against a dense cache. Writes the new K/V rows
    into ``k_cache``/``v_cache`` IN PLACE at ``cache_len`` (the JAX version
    returns updated copies; in place saves a cache copy per layer), then
    attends over the whole fixed-capacity cache — slots past the frontier
    sit in every query's causal future. ``contributed`` is this layer's
    sparse-exchange row during bulk prefill-via-decode."""
    q, k_new, v_new = _project_qkv(p, x, config, ctx.positions, _rope_theta_for(spec, config))
    S_new = x.shape[1]
    k_cache[:, cache_len:cache_len + S_new] = k_new.to(k_cache.dtype)
    v_cache[:, cache_len:cache_len + S_new] = v_new.to(v_cache.dtype)
    sync = ctx.schedule.is_sync(layer_idx)
    out = ops.decode_attention(
        q, k_cache, v_cache,
        q_pos=ctx.positions,
        kv_pos=ctx.kv_positions,
        q_seg=ctx.segments if ctx.enabled else None,
        kv_seg=ctx.kv_segments if ctx.enabled else None,
        causal=True,
        local_only=(not sync) and ctx.enabled,
        contributed=contributed if (sync and ctx.enabled) else None,
        window=spec.window,
        soft_cap=config.attn_soft_cap,
        backend=backend,
    )
    B = x.shape[0]
    return out.reshape(B, S_new, -1) @ p["wo"]
