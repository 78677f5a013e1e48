"""Plain-torch attention oracles of the port (O(L²) memory).

Port of ``attention_ref``/``decode_attention_ref`` from the JAX package's
``kernels/ref.py``: the smallest composition of the shared visibility mask
with the shared masked-softmax body. Inputs of any float dtype, computed
in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.core import AttnSpec, masked_attention


def attention_ref(
    q: torch.Tensor,  # (B, Lq, nq, dh)
    k: torch.Tensor,  # (B, Lk, nkv, dh)
    v: torch.Tensor,  # (B, Lk, nkv, dh)
    *,
    q_pos: torch.Tensor,  # (Lq,) or (B, Lq)
    kv_pos: torch.Tensor,  # (Lk,) or (B, Lk)
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    causal: bool = True,
    local_only: bool = False,
    contributed: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked multi-head attention oracle, returns (B, Lq, nq, dh)."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"n_heads {q.shape[2]} not a multiple of n_kv {k.shape[2]}")
    spec = AttnSpec(
        q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg,
        contributed=contributed, causal=causal, local_only=local_only,
        window=window, soft_cap=soft_cap, sm_scale=sm_scale,
    )
    return masked_attention(q, k, v, spec.mask(), soft_cap=soft_cap, sm_scale=sm_scale)


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, nq, dh)
    k_cache: torch.Tensor,  # (B, C, nkv, dh)
    v_cache: torch.Tensor,
    **kw,
) -> torch.Tensor:
    return attention_ref(q, k_cache, v_cache, **kw)
