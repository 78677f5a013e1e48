"""Attention entry points of the port, with backend dispatch.

Backends (counterparts of the JAX package's ``kernels/ops.py``):
  'cuda'   the hand-written Hopper kernel (:mod:`.flash_attention`) — the
           counterpart of 'pallas' and the default for CUDA tensors. Given
           CPU tensors, the kernel's wrapper runs its plain version.
  'torch'  the chunked online softmax in plain torch — the counterpart of
           'xla' and the default for CPU tensors. Small problems
           (``Lq * Lk <= PAGED_READ.densify_elems``) take the O(L²) oracle.
  'ref'    the O(L²) oracle (:mod:`.ref`).

All entry points share the FedAttn masking vocabulary of
:mod:`repro_torch.kernels.core`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import core as _core
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

NEG_INF = _core.NEG_INF
BACKENDS = ("cuda", "torch", "ref")


@dataclass(frozen=True)
class PagedReadConfig:
    """Cache-read thresholds: ``densify_elems`` — the 'torch' backend takes
    the O(L²) oracle whenever ``Lq * Lk <= densify_elems``; ``chunk_tokens``
    — the decode-path KV chunk width, clamped to the cache extent."""

    densify_elems: int = 256 * 256
    chunk_tokens: int = 2048


PAGED_READ = PagedReadConfig()


def default_backend(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "torch"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    causal: bool = True,
    local_only: bool = False,
    contributed: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    backend: Optional[str] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """FedAttn-aware multi-head attention, (B, Lq, nq, dh). Position/segment
    vectors may be shared (1-D) or per batch row (2-D) on every backend."""
    backend = backend or default_backend(q.device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    kw = dict(
        q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg, causal=causal,
        local_only=local_only, contributed=contributed, window=window,
        soft_cap=soft_cap, sm_scale=sm_scale,
    )
    if backend == "cuda":
        return _fa.flash_attention(q, k, v, **kw)
    if backend == "ref" or q.shape[1] * k.shape[1] <= PAGED_READ.densify_elems:
        return _ref.attention_ref(q, k, v, **kw)
    return _chunked_attention(q, k, v, chunk=chunk, **kw)


def _chunked_attention(
    q, k, v, *, q_pos, kv_pos, q_seg=None, kv_seg=None, causal=True,
    local_only=False, contributed=None, window=None, soft_cap=None,
    sm_scale=None, chunk,
):
    """Online-softmax attention over KV chunks, O(Lq · chunk) memory.

    The KV sequence is padded to a multiple of ``chunk`` (clamped to Lk
    first); padded slots carry the ``PAD_POS``/``KERNEL_PAD_SEGMENT``
    sentinels, so the masks remove them."""
    dh = q.shape[3]
    Lk = k.shape[1]
    g = q.shape[2] // k.shape[2]
    scale = sm_scale if sm_scale is not None else dh**-0.5
    spec = _core.AttnSpec(
        q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg,
        contributed=contributed, causal=causal, local_only=local_only,
        window=window, soft_cap=soft_cap, sm_scale=sm_scale,
    )
    chunk = max(1, min(chunk, Lk))
    pad = (-Lk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        spec = spec.pad_kv(pad)
    n_chunks = (Lk + pad) // chunk
    fetch = lambda i: (k[:, i * chunk:(i + 1) * chunk], v[:, i * chunk:(i + 1) * chunk])
    return _online_attention(q, fetch, spec, chunk, n_chunks, g=g, soft_cap=soft_cap, scale=scale)


def _online_attention(q, fetch, spec, chunk, n_chunks, *, g, soft_cap, scale):
    """Online-softmax (flash-style) accumulation over KV chunks; ``fetch(i)``
    supplies chunk ``i``'s (kc, vc)."""
    B, Lq, nq, dh = q.shape
    qf = q.to(torch.float32) * scale
    m = torch.full((B, nq, Lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nq, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Lq, nq, dh), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        kc, vc = fetch(i)
        kcf = torch.repeat_interleave(kc.to(torch.float32), g, dim=2)
        vcf = torch.repeat_interleave(vc.to(torch.float32), g, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kcf)  # (B, nq, Lq, chunk)
        if soft_cap:
            s = torch.tanh(s / soft_cap) * soft_cap
        vis = spec.chunk_kv(i * chunk, chunk).mask()[:, None]  # (Bm, 1, Lq, chunk)
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(vis, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, vcf)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, S, nq, dh) with small S (usually 1)
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    **kw,
) -> torch.Tensor:
    """Decode-step attention against a KV cache; same masking vocabulary."""
    kw.setdefault("chunk", PAGED_READ.chunk_tokens)
    return attention(q, k_cache, v_cache, **kw)
