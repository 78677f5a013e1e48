"""Quantized KV codecs — the one home of scale arithmetic in the port.

Port of the JAX package's ``serving/quant.py``. Two codecs, selected by the
*storage dtype* of the paged pool; the dtype IS the mode:

=========  ======================  ======================  ===================
mode       storage dtype           scale                   elementwise error
=========  ======================  ======================  ===================
``int8``   ``torch.int8``          amax / 127 per          <= scale / 2
                                   (page, kv-head)
``fp8``    ``torch.float8_e4m3fn`` amax / 448 per          <= max(|x| * 2^-4,
                                   (page, kv-head)         scale * 2^-10)
=========  ======================  ======================  ===================

Scales are sibling ``(num_pages, nkv)`` f32 tensors beside the pool.
Dequantization happens at the read (the page gather of the plain paths,
the load of the K2 kernel), so every attention consumer sees the dense f32
contract and visibility is never decided by quantized values.

Write discipline:

* frontier writes (:func:`paged_write`) scatter-MAX the scales — untouched
  pages keep bit-exact scales and codes; pages whose amax grew rescale
  their resident codes once, then the new rows land encoded under the
  updated scale;
* admission block writes (:func:`quantize_block`) RESET per page — a freed
  page reused by a new slot must not inherit the previous resident's amax.

Every encode clips to the code range before the cast (a cast to e4m3 above
+-448 does not saturate), and int8 rounds half to even (``torch.round``,
like ``jnp.round``).
"""
from __future__ import annotations

from typing import Optional

import torch

#: the opt-in pool/exchange codecs ("none"/None disables quantization)
MODES = ("int8", "fp8")

_TINY = float(torch.finfo(torch.float32).tiny)
_CODE_MAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def storage_dtype(mode) -> Optional[torch.dtype]:
    """Pool storage dtype for a ``kv_quant`` mode (None when disabled)."""
    if mode in (None, "none"):
        return None
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown kv_quant mode {mode!r}: expected one of {MODES} or 'none'")


def code_max(dtype: torch.dtype) -> float:
    """Largest representable code magnitude (127 for int8, 448 for e4m3)."""
    if dtype not in _CODE_MAX:
        raise ValueError(f"{dtype} is not a KV quantization storage dtype")
    return _CODE_MAX[dtype]


def _encode(x: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Encode ``x`` (..., dh) under ``scales`` (broadcastable against
    ``x[..., 0]``); clip before the cast."""
    cmax = code_max(dtype)
    y = x.to(torch.float32) / torch.clamp(scales, min=_TINY)[..., None]
    y = torch.clamp(y, -cmax, cmax)
    if dtype == torch.int8:
        y = torch.round(y)
    return y.to(dtype)


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """codes (..., dh) int8/fp8 + scales (...) f32 aligned with
    ``codes[..., 0]`` → f32. The one place codes meet scales on the plain
    read paths (the K2 kernel applies the same ``code * scale``)."""
    return codes.to(torch.float32) * scales[..., None]


def quantize_rows(x: torch.Tensor, dtype: torch.dtype):
    """Per-row-per-head codec: x (..., nkv, dh) → (codes, scales (..., nkv)).
    The exchange codec: each KV row crosses as dh codes plus nkv scales."""
    amax = x.to(torch.float32).abs().amax(dim=-1)
    scales = amax / code_max(dtype)
    return _encode(x, scales, dtype), scales


def quantize_block(x: torch.Tensor, dtype: torch.dtype):
    """Per-page-per-head codec: x (..., ps, nkv, dh) → (codes, scales
    (..., nkv)); amax pools over the page's rows AND the head dim. Fresh
    RESET semantics — the admission-scatter codec."""
    amax = x.to(torch.float32).abs().amax(dim=(-3, -1))
    scales = amax / code_max(dtype)
    return _encode(x, scales[..., None, :], dtype), scales


def paged_write(pool: torch.Tensor, scales: torch.Tensor, new: torch.Tensor,
                page_idx: torch.Tensor, off: torch.Tensor):
    """Scatter new KV rows into a quantized pool at the decode frontier,
    IN PLACE (the JAX version returns updated copies).

    ``pool`` (N, ps, nkv, dh) codes + ``scales`` (N, nkv) f32; ``new``
    (B, S, nkv, dh) compute dtype; ``page_idx``/``off`` (B, S) int —
    entries >= N drop (the paging sentinel convention).

    Scales scatter-max first, so an untouched page keeps its scales and
    codes bit-exact; a page whose amax grew rescales its resident codes
    once by old/new before the new rows land encoded under the grown
    scale. Only the written pages are re-encoded: every other page's
    re-encode ratio is exactly 1.0, the identity, so the result equals the
    whole-pool rescale of the JAX version. Returns ``(pool, scales)``."""
    cmax = code_max(pool.dtype)
    N = pool.shape[0]
    x = new.to(torch.float32)
    row_scales = x.abs().amax(dim=-1) / cmax  # (B, S, nkv)
    keep = page_idx < N
    idx = page_idx[keep].long()
    s_old = scales[idx]
    src = row_scales[keep]
    scales.scatter_reduce_(0, idx[:, None].expand_as(src), src, "amax", include_self=True)
    s_new = scales[idx]
    # a page written by several rows is re-encoded once per row, each time
    # from the same old codes to the same values
    ratio = torch.where(s_new == s_old, 1.0, s_old / torch.clamp(s_new, min=_TINY))
    body = pool[idx].to(torch.float32) * ratio[:, None, :, None]
    if pool.dtype == torch.int8:
        body = torch.round(body)
    pool[idx] = torch.clamp(body, -cmax, cmax).to(pool.dtype)
    s_rows = scales[torch.clamp(page_idx.long(), max=N - 1)]  # (B, S, nkv)
    codes = _encode(x, s_rows, pool.dtype)
    pool[idx, off[keep].long()] = codes[keep]
    return pool, scales
