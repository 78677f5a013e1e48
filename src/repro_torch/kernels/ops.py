"""Attention entry points of the port, with backend dispatch: dense
attention (prefill and dense-cache decode) and paged attention (decode and
verify through the serving pool's page tables).

Backends (counterparts of the JAX package's ``kernels/ops.py``):
  'cuda'   the hand-written Hopper kernels — K1 (:mod:`.flash_attention`)
           for dense attention, K2 (:mod:`.flash_decode`) for paged decode —
           the counterpart of 'pallas' and the default for CUDA tensors.
           Given CPU tensors, a kernel's wrapper runs its plain version.
  'torch'  plain torch, the counterpart of 'xla' and the default for CPU
           tensors: the chunked online softmax (the paged form gathers page
           groups per chunk); problems with ``Lq * Lk <=
           PAGED_READ.densify_elems`` take the O(L²) oracle.
  'ref'    the O(L²) oracle (:mod:`.ref`); paged reads densify the pool
           first.

All entry points share the FedAttn masking vocabulary of
:mod:`repro_torch.kernels.core`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import core as _core
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref as _ref
from repro_torch.serving import paging as _paging
from repro_torch.serving import quant as _quant

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


# ---------------------------------------------------------------------------
# Paged attention (block-paged KV pool, serving/paging.py conventions)
# ---------------------------------------------------------------------------


def _gather_pages(pool, pages, scales=None):
    """(num_pages, page_size, nkv, dh) pool + (B, P') tables → dense
    (B, P'*page_size, nkv, dh). The gather CLAMPS sentinel entries to the
    last physical page; callers mask those columns via kv_pos/kv_seg.
    ``scales`` (num_pages, nkv) marks a quantized pool: the codes
    dequantize to f32 inside this gather."""
    N, ps = pool.shape[0], pool.shape[1]
    B, Pp = pages.shape
    idx = torch.clamp(pages.long(), max=N - 1)
    out = pool[idx].reshape(B, Pp * ps, pool.shape[2], pool.shape[3])
    if scales is None:
        return out
    s = torch.repeat_interleave(scales[idx], ps, dim=1)  # (B, Pp*ps, nkv)
    return _quant.dequantize(out, s)


def _mask_sentinel_columns(pages, N, ps, kv_pos, kv_seg):
    """Per-row kv_pos/kv_seg with sentinel-page columns forced to
    ``PAD_POS``/``KERNEL_PAD_SEGMENT`` — before any visibility decision."""
    B, Pp = pages.shape
    Lk = Pp * ps
    col_valid = torch.repeat_interleave(pages < N, ps, dim=1)
    kv_pos = torch.where(col_valid, _core._as2(kv_pos).expand(B, Lk), _core.PAD_POS)
    if kv_seg is not None:
        kv_seg = torch.where(
            col_valid, _core._as2(kv_seg).expand(B, Lk), _core.KERNEL_PAD_SEGMENT
        )
    return kv_pos, kv_seg


def paged_attention(
    q: torch.Tensor,  # (B, S, nq, dh)
    pk: torch.Tensor,  # (num_pages, page_size, nkv, dh) — shared pool
    pv: torch.Tensor,
    pages: torch.Tensor,  # (B, P') int32 page tables; entries >= num_pages are holes
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,  # (P'*ps,) or (B, P'*ps) linear positions
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
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FedAttn attention reading KV through per-row page tables, in plain
    torch. Sentinel columns are masked first; the small / 'ref' path
    densifies the pool per row and hands it to :func:`attention`, the large
    'torch' path gathers page groups chunk by chunk inside the online
    softmax. On 'cuda' the paged read is K2's alone: call
    :func:`paged_decode_attention`."""
    backend = backend or default_backend(q.device)
    if backend not in ("torch", "ref"):
        raise ValueError(f"paged_attention runs backends 'torch' and 'ref', not {backend!r}: "
                         "the 'cuda' paged read is paged_decode_attention's K2")
    N, ps = pk.shape[0], pk.shape[1]
    Lk = pages.shape[1] * ps
    kv_pos, kv_seg = _mask_sentinel_columns(pages, N, ps, kv_pos, kv_seg)
    kw = dict(
        q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg, causal=causal,
        local_only=local_only, contributed=contributed, window=window,
        soft_cap=soft_cap, sm_scale=sm_scale,
    )
    if backend != "torch" or q.shape[1] * Lk <= PAGED_READ.densify_elems:
        k = _gather_pages(pk, pages, k_scales)
        v = _gather_pages(pv, pages, v_scales)
        return attention(q, k, v, backend=backend, **kw)
    return _chunked_paged_attention(
        q, pk, pv, pages, chunk=chunk, k_scales=k_scales, v_scales=v_scales, **kw
    )


def _chunked_paged_attention(
    q, pk, pv, pages, *, q_pos, kv_pos, q_seg, kv_seg, causal, local_only,
    contributed, window, soft_cap, sm_scale, chunk, k_scales=None, v_scales=None,
):
    """Online-softmax attention over page *groups*: each step gathers
    ``G = chunk // page_size`` pages and reuses :func:`_online_attention`.
    ``kv_pos``/``kv_seg`` arrive per row with sentinel columns masked."""
    dh = q.shape[3]
    N, ps, nkv = pk.shape[0], pk.shape[1], pk.shape[2]
    Pp = pages.shape[1]
    g = q.shape[2] // nkv
    scale = sm_scale if sm_scale is not None else dh**-0.5
    chunk = max(1, min(chunk, Pp * ps))
    G = max(1, min(_paging.pages_for(chunk, ps), Pp))
    chunk = G * ps
    padp = (-Pp) % G
    if padp:
        pad = lambda a, val: torch.nn.functional.pad(a, (0, padp * ps), value=val)
        pages = torch.nn.functional.pad(pages, (0, padp), value=N)
        kv_pos = pad(kv_pos, _core.PAD_POS)
        if kv_seg is not None:
            kv_seg = pad(kv_seg, _core.KERNEL_PAD_SEGMENT)
        if contributed is not None:
            contributed = pad(contributed.bool(), False)
    n_groups = (Pp + padp) // G
    spec = _core.AttnSpec(
        q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg,
        contributed=contributed, causal=causal, local_only=local_only,
        window=window, soft_cap=soft_cap, sm_scale=sm_scale,
    )

    def fetch(i):
        pg = pages[:, i * G:(i + 1) * G]
        return _gather_pages(pk, pg, k_scales), _gather_pages(pv, pg, v_scales)

    return _online_attention(q, fetch, spec, chunk, n_groups, g=g, soft_cap=soft_cap, scale=scale)


def _paged_attention_with_mass(
    q, pk, pv, pages, *, q_pos, kv_pos, q_seg=None, kv_seg=None, causal=True,
    local_only=False, contributed=None, window=None, soft_cap=None,
    sm_scale=None, k_scales=None, v_scales=None,
):
    """Plain ``return_mass`` path: one densified
    ``masked_attention(return_stats=True, return_probs=True)`` pass yields
    the normalized output and each pool column's normalized softmax mass
    (B, P'*ps) — the quantity K2's stats emit."""
    N, ps = pk.shape[0], pk.shape[1]
    kv_pos, kv_seg = _mask_sentinel_columns(pages, N, ps, kv_pos, kv_seg)
    k = _gather_pages(pk, pages, k_scales)
    v = _gather_pages(pv, pages, v_scales)
    mask = _core.visibility(
        q_pos, kv_pos, q_seg, kv_seg, causal=causal, local_only=local_only,
        contributed=contributed, window=window,
    )
    m, l, acc, p = _core.masked_attention(
        q, k, v, mask, soft_cap=soft_cap, sm_scale=sm_scale,
        return_stats=True, return_probs=True,
    )
    denom = torch.clamp(l, min=1e-20)  # (B, nq, Lq)
    out = (acc / denom.transpose(1, 2)[..., None]).to(q.dtype)
    mass = (p / denom[..., None]).sum(dim=(1, 2))  # (B, Lk)
    return out, mass


def paged_decode_attention(
    q: torch.Tensor,
    pk: torch.Tensor,
    pv: torch.Tensor,
    pages: torch.Tensor,
    **kw,
):
    """Decode-step attention through page tables, including the ``S > 1``
    multi-query verify form. Backend 'cuda' routes to K2
    (:func:`repro_torch.kernels.flash_decode.paged_flash_decode`: in-kernel
    page loads, dequant at load, split-KV combine); 'torch' and 'ref' gather
    the pages in plain torch. ``return_mass=True`` also returns each pool
    column's normalized attention mass (B, P'*ps) — the ``'attnmass'``
    selection's feed."""
    kw.setdefault("chunk", PAGED_READ.chunk_tokens)
    return_mass = kw.pop("return_mass", False)
    backend = kw.get("backend") or default_backend(q.device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if backend == "cuda":
        kw.pop("backend", None)
        kw.pop("chunk", None)
        return _fd.paged_flash_decode(q, pk, pv, pages, return_mass=return_mass, **kw)
    if return_mass:
        kw.pop("backend", None)
        kw.pop("chunk", None)
        return _paged_attention_with_mass(q, pk, pv, pages, **kw)
    return paged_attention(q, pk, pv, pages, **kw)
