"""The shared attention core of the port: ONE visibility/masking spec.

Port of the JAX package's ``kernels/core.py`` (the attention half). Every
attention implementation of the port — the O(L²) oracle
(:mod:`repro_torch.kernels.ref`), the chunked online softmax
(:mod:`repro_torch.kernels.ops`), the CUDA kernel's plain version
(:mod:`repro_torch.kernels.flash_attention`) — composes these primitives;
the CUDA kernel re-states the same rules in ``csrc/flash_attention.cu``.

Vector contract: every position/segment/contribution vector is either 1-D
``(L,)`` — shared across the batch — or 2-D ``(B, L)`` — one row per batch
row. The mask's leading dim broadcasts to ``Bm = max`` of the leading dims.

Sentinels: ``kv_pos == PAD_POS`` (int32 max, chunk/tile padding) and
``kv_seg < 0`` (shape bucketing pads with ``PAD_SEGMENT``, kernels pad with
``KERNEL_PAD_SEGMENT``) are never visible to any query.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F

# The sentinel scheme, with the JAX package's values.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
PAD_POS = torch.iinfo(torch.int32).max  # padded KV slot position sentinel
PAD_SEGMENT = -1  # shape-bucketing / inactive-slot segment sentinel
KERNEL_PAD_SEGMENT = -2  # kernel-internal chunk/tile padding sentinel


def _as2(a: torch.Tensor) -> torch.Tensor:
    return a if a.dim() == 2 else a[None]


def visibility(
    q_pos: torch.Tensor,  # (Lq,) or (B, Lq)
    kv_pos: torch.Tensor,  # (Lk,) or (B, Lk)
    q_seg: Optional[torch.Tensor] = None,  # (Lq,) or (B, Lq)
    kv_seg: Optional[torch.Tensor] = None,  # (Lk,) or (B, Lk)
    *,
    causal: bool = True,
    local_only: bool = False,
    contributed: Optional[torch.Tensor] = None,  # (Lk,) or (B, Lk)
    window: Optional[int] = None,
    publisher_lo=None,  # int / scalar / (B,) — decode-time publisher rule
) -> torch.Tensor:
    """FedAttn visibility as a ``(Bm, Lq, Lk)`` bool mask. Rules, in order:

    * ``causal``: ``q_pos >= kv_pos``; bidirectional drops only the
      position-sentinel padded rows.
    * ``window``: relative-position sliding window on top.
    * ``publisher_lo``: only ``kv_pos >= publisher_lo`` is visible.
    * segments (when both given): padded rows (``kv_seg < 0``) are never
      visible; ``local_only`` restricts to the segment diagonal (Phase I,
      eq. 18); otherwise ``contributed`` thins the off-diagonal to the
      exchanged rows (Phase II, eqs. 20-21 / 37).
    """
    qp, kp = _as2(q_pos), _as2(kv_pos)
    if causal:
        mask = qp[:, :, None] >= kp[:, None, :]
    else:
        mask = (kp[:, None, :] < PAD_POS).expand(
            max(qp.shape[0], kp.shape[0]), qp.shape[1], kp.shape[1]
        )
    if window is not None:
        mask = mask & ((qp[:, :, None] - kp[:, None, :]) < window)
    if publisher_lo is not None:
        lo = torch.as_tensor(publisher_lo, device=kp.device).reshape(-1, 1, 1)
        mask = mask & (kp[:, None, :] >= lo)
    if q_seg is not None and kv_seg is not None:
        qs, ks = _as2(q_seg), _as2(kv_seg)
        mask = mask & (ks[:, None, :] >= 0)
        same = qs[:, :, None] == ks[:, None, :]
        if local_only:
            mask = mask & same
        elif contributed is not None:
            mask = mask & (same | _as2(contributed)[:, None, :].bool())
    return mask


@dataclass(frozen=True)
class AttnSpec:
    """Everything that determines attention visibility and logit shaping:
    the static flags plus the position/segment/contribution operands (each
    1-D shared or 2-D per-row). ``pad_kv``/``chunk_kv`` derive specs whose
    KV-side operands are padded with the sentinels / sliced to one chunk."""

    q_pos: torch.Tensor
    kv_pos: torch.Tensor
    q_seg: Optional[torch.Tensor] = None
    kv_seg: Optional[torch.Tensor] = None
    contributed: Optional[torch.Tensor] = None
    causal: bool = True
    local_only: bool = False
    window: Optional[int] = None
    soft_cap: Optional[float] = None
    sm_scale: Optional[float] = None
    publisher_lo: Optional[int | torch.Tensor] = None

    def mask(self) -> torch.Tensor:
        """(Bm, Lq, Lk) visibility of this spec (see :func:`visibility`)."""
        return visibility(
            self.q_pos, self.kv_pos, self.q_seg, self.kv_seg,
            causal=self.causal, local_only=self.local_only,
            contributed=self.contributed, window=self.window,
            publisher_lo=self.publisher_lo,
        )

    def pad_kv(self, pad: int) -> "AttnSpec":
        """Spec with KV-side operands padded by ``pad`` sentinel slots."""
        if pad == 0:
            return self
        last = lambda a, val: F.pad(a, (0, pad), value=val)
        return replace(
            self,
            kv_pos=last(self.kv_pos, PAD_POS),
            kv_seg=None if self.kv_seg is None else last(self.kv_seg, KERNEL_PAD_SEGMENT),
            contributed=(
                None if self.contributed is None
                else last(self.contributed.bool(), False)
            ),
        )

    def chunk_kv(self, start: int, size: int) -> "AttnSpec":
        """Spec restricted to KV slots ``[start, start + size)``."""
        sl = lambda a: a[..., start:start + size]
        return replace(
            self,
            kv_pos=sl(self.kv_pos),
            kv_seg=None if self.kv_seg is None else sl(self.kv_seg),
            contributed=None if self.contributed is None else sl(self.contributed),
        )


def masked_attention(
    q: torch.Tensor,  # (B, Lq, nq, dh)
    k: torch.Tensor,  # (B, Lk, nkv, dh)
    v: torch.Tensor,
    mask: torch.Tensor,  # (Lq, Lk) or (Bm, Lq, Lk), Bm ∈ {1, B}
    *,
    soft_cap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    return_stats: bool = False,
    return_probs: bool = False,
):
    """The ONE masked-softmax attention body (GQA-aware, f32 accumulation).

    With ``return_stats`` it returns the partial-softmax statistics
    ``(m, l, acc)`` — ``m`` (B, nq, Lq) row max, ``l`` row mass, ``acc``
    (B, Lq, nq, dh) unnormalized value sum — the combinable flash-decoding
    form. ``return_probs`` (stats form only) appends ``p`` (B, nq, Lq, Lk),
    the masked softmax numerators relative to ``m`` — the per-column
    attention-mass ingredient of the ``'attnmass'`` selection.
    Fully-masked rows yield zero output (``l`` guarded), never NaN.
    """
    B, Lq, nq, dh = q.shape
    g = nq // k.shape[2]
    scale = sm_scale if sm_scale is not None else dh**-0.5
    if mask.dim() == 2:
        mask = mask[None]
    qf = q.to(torch.float32) * scale
    kf = torch.repeat_interleave(k.to(torch.float32), g, dim=2)
    vf = torch.repeat_interleave(v.to(torch.float32), g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    vis = mask[:, None]
    s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1)  # (B, nq, Lq)
    p = torch.exp(s - m[..., None])
    p = torch.where(vis, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    if return_stats:
        return (m, l, acc, p) if return_probs else (m, l, acc)
    out = acc / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)
