"""K2 — paged flash-decode: the hand-written Hopper kernel and its plain
version.

Replaces the TPU kernel ``paged_flash_decode`` of the JAX package
(``src/repro/kernels/flash_decode.py:153``): the serving pool's decode
(``S = 1``) and speculative-verify (``S = k + 1``) attention, reading K/V
straight from the block-paged pool ``(num_pages, page_size, nkv, dh)``
through per-row page tables ``(B, P')``. The CUDA source is
``csrc/paged_flash_decode.cu`` (its header says what bounds it on the card
and how it is laid out); :func:`paged_flash_decode` is its wrapper:

* CUDA tensors launch the kernel (a split pass and a combine, counted as
  one launch in ``paged_flash_decode.launches``) — there is no fallback: a
  shape, dtype or layout the kernel does not take raises, and so does a
  failed build or launch.
* CPU tensors go to :func:`paged_flash_decode_plain`, the port of the JAX
  package's ``paged_flash_decode_ref``: gather each table entry's clamped
  page, attend per page (:func:`_block_attend`), combine the per-page stats
  (:func:`_finish`). The tests and ``chip_smoke.py`` use it;
  ``paged_flash_decode_plain.calls`` counts calls.

Pools may be bf16 / f32, or int8 / fp8 codes with ``(num_pages, nkv)`` f32
``k_scales``/``v_scales`` dequantized at load. Sentinel-page columns (table
entries outside ``[0, num_pages)``) are forced to ``PAD_POS`` /
``KERNEL_PAD_SEGMENT`` before any visibility decision. Outputs: the
normalized ``(B, S, nq, dh)`` attention in q's dtype, or with
``return_stats`` the combinable ``(m, l, acc)``; ``return_mass`` appends the
per-column normalized softmax mass ``(B, P'*ps)`` (stats form: the raw
``p_rel`` numerators ``(B, nq, S, P'*ps)`` relative to the returned ``m``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.core import KERNEL_PAD_SEGMENT, NEG_INF, PAD_POS, _as2, visibility

HEAD_DIMS = (64, 128)
MAX_ROWS = 64  # g * S query rows per KV head (csrc: one block serves them all)
MAX_PAGE_SIZE = 64
BLOCKS_IN_FLIGHT = 4 * 132  # split-pass blocks to aim for: four per H100 SM
COMBINE_BLOCKS = 264
_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}


def _prep(q, pk, pages, q_pos, kv_pos, q_seg, kv_seg, contributed, local_only):
    """Broadcast the vectors to the per-row form and force sentinel-page
    columns behind ``PAD_POS``/``KERNEL_PAD_SEGMENT`` before any visibility
    decision (the JAX package's ``_prep``)."""
    B, S = q.shape[:2]
    N, ps = pk.shape[0], pk.shape[1]
    Lk = pages.shape[1] * ps
    col_valid = torch.repeat_interleave((pages >= 0) & (pages < N), ps, dim=1)
    qp = _as2(q_pos).expand(B, S)
    kp = torch.where(col_valid, _as2(kv_pos).expand(B, Lk), PAD_POS)
    qs = ks = ct = None
    if q_seg is not None and kv_seg is not None:
        qs = _as2(q_seg).expand(B, S)
        ks = torch.where(col_valid, _as2(kv_seg).expand(B, Lk), KERNEL_PAD_SEGMENT)
        if not local_only and contributed is not None:
            ct = _as2(contributed).expand(B, Lk).bool()
    return qp, kp, qs, ks, ct


def _block_attend(q, k, v, mask, soft_cap):
    """Attention stats of every (query rows × page) tile at once.

    ``q`` (B, nkv, g, S, dh) pre-scaled f32; ``k``/``v`` (B, nkv, P', ps,
    dh) f32 (dequantized); ``mask`` (B, P', S, ps). Returns ``m``/``l`` (B,
    nq, P', S), ``acc`` (B, nq, P', S, dh) and ``p`` (B, nq, P', S, ps), the
    masked numerators relative to each page's ``m``; query head ``h`` is
    ``kv_head * g + j`` (KV head ``h // g``)."""
    B, nkv, g, S, dh = q.shape
    Pp, ps = k.shape[2], k.shape[3]
    s = torch.einsum("bkgsd,bkpcd->bkgpsc", q, k).reshape(B, nkv * g, Pp, S, ps)
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    vis = mask[:, None]
    s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum(
        "bkgpsc,bkpcd->bkgpsd", p.reshape(B, nkv, g, Pp, S, ps), v
    ).reshape(B, nkv * g, Pp, S, dh)
    return m, l, acc, p


def _finish(q_dtype, m_p, l_p, acc_p, p_p, *, return_stats, return_mass):
    """Combine per-page partial stats: global max over pages, correction of
    each page's ``l``/``acc``, sum (the JAX package's ``_finish``)."""
    B, nq, Pp, S = m_p.shape
    m_g = m_p.amax(dim=2)  # (B, nq, S)
    corr = torch.exp(m_p - m_g[:, :, None])  # (B, nq, P', S)
    l_g = (l_p * corr).sum(dim=2)
    acc_g = (acc_p * corr[..., None]).sum(dim=2)  # (B, nq, S, dh)
    p_rel = None
    if p_p is not None:
        ps = p_p.shape[-1]
        p_rel = (p_p * corr[..., None]).permute(0, 1, 3, 2, 4).reshape(B, nq, S, Pp * ps)
    if return_stats:
        acc_out = acc_g.transpose(1, 2)  # (B, S, nq, dh)
        return (m_g, l_g, acc_out, p_rel) if return_mass else (m_g, l_g, acc_out)
    denom = torch.clamp(l_g, min=1e-20)
    out = (acc_g / denom[..., None]).transpose(1, 2).to(q_dtype)
    if return_mass:
        return out, (p_rel / denom[..., None]).sum(dim=(1, 2))  # (B, Lk)
    return out


def paged_flash_decode_plain(
    q, pk, pv, pages, *, q_pos, kv_pos, q_seg=None, kv_seg=None, causal=True,
    local_only=False, contributed=None, window=None, soft_cap=None,
    sm_scale=None, publisher_lo=None, k_scales=None, v_scales=None,
    return_stats=False, return_mass=False,
):
    """The kernel's plain version: the JAX package's ``paged_flash_decode_ref``
    — the same per-page partition and combine, on whole tensors."""
    paged_flash_decode_plain.calls += 1
    B, S, nq, dh = q.shape
    N, ps, nkv, _ = pk.shape
    Pp = pages.shape[1]
    g = nq // nkv
    scale = sm_scale if sm_scale is not None else dh**-0.5
    qp, kp, qs, ks, ct = _prep(q, pk, pages, q_pos, kv_pos, q_seg, kv_seg, contributed, local_only)
    mask = visibility(
        qp, kp, qs, ks, causal=causal, local_only=local_only, contributed=ct,
        window=window, publisher_lo=publisher_lo,
    )  # (B, S, Lk)
    maskb = mask.reshape(B, S, Pp, ps).permute(0, 2, 1, 3)  # (B, P', S, ps)
    idx = torch.clamp(pages.long(), 0, N - 1)
    kb, vb = pk[idx].to(torch.float32), pv[idx].to(torch.float32)  # (B, P', ps, nkv, dh)
    if k_scales is not None:
        kb = kb * k_scales[idx][:, :, None, :, None]
        vb = vb * v_scales[idx][:, :, None, :, None]
    kh, vh = (t.permute(0, 3, 1, 2, 4) for t in (kb, vb))  # (B, nkv, P', ps, dh)
    qh = (q.to(torch.float32) * scale).reshape(B, S, nkv, g, dh).permute(0, 2, 3, 1, 4)
    m_p, l_p, acc_p, p_p = _block_attend(qh, kh, vh, maskb, soft_cap)
    return _finish(
        q.dtype, m_p, l_p, acc_p, p_p if return_mass else None,
        return_stats=return_stats, return_mass=return_mass,
    )


paged_flash_decode_plain.calls = 0


def _vector(name, a, B, L, dtype) -> Optional[torch.Tensor]:
    """Normalize a vector to a contiguous ``(Bv, L)`` tensor, Bv ∈ {1, B}."""
    if a is None:
        return None
    a2 = _as2(a)
    if a2.dim() != 2 or a2.shape[0] not in (1, B) or a2.shape[1] != L:
        raise ValueError(f"paged_flash_decode: {name} expected ({{1,{B}}}, {L}), got {tuple(a.shape)}")
    return a2.to(dtype).contiguous()


def split_count(B: int, nkv: int, Pp: int) -> tuple[int, int]:
    """(splits, pages per split): enough (slot, KV head, split) blocks for
    about four per SM, never more splits than pages."""
    want = max(1, min(Pp, math.ceil(BLOCKS_IN_FLIGHT / max(1, B * nkv))))
    per = math.ceil(Pp / want)
    return math.ceil(Pp / per), per


def paged_flash_decode(
    q: torch.Tensor,  # (B, S, nq, dh) — S=1 decode or S=k+1 verify rows
    pk: torch.Tensor,  # (num_pages, page_size, nkv, dh) physical pool
    pv: torch.Tensor,
    pages: torch.Tensor,  # (B, P') int32 tables; entries >= num_pages are holes
    *,
    q_pos: torch.Tensor,  # (S,) or (B, S)
    kv_pos: torch.Tensor,  # (P'*ps,) or (B, P'*ps)
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    causal: bool = True,
    local_only: bool = False,
    contributed: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    publisher_lo=None,  # int, or (B,) per row
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, nkv) f32 — quantized pool
    v_scales: Optional[torch.Tensor] = None,
    return_stats: bool = False,
    return_mass: bool = False,
):
    """Paged decode/verify attention (module docstring for the outputs)."""
    kw = dict(
        q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg, causal=causal,
        local_only=local_only, contributed=contributed, window=window,
        soft_cap=soft_cap, sm_scale=sm_scale, publisher_lo=publisher_lo,
        k_scales=k_scales, v_scales=v_scales, return_stats=return_stats,
        return_mass=return_mass,
    )
    devices = {t.device.type for t in (q, pk, pv, pages, q_pos, kv_pos)}
    if devices == {"cpu"}:
        return paged_flash_decode_plain(q, pk, pv, pages, **kw)
    if devices != {"cuda"}:
        raise ValueError(f"paged_flash_decode: tensors on {sorted(devices)}; expected one CUDA device")

    if q.dim() != 4 or pk.dim() != 4 or pv.shape != pk.shape or pages.dim() != 2:
        raise ValueError(
            f"paged_flash_decode: bad shapes q{tuple(q.shape)} pk{tuple(pk.shape)} "
            f"pv{tuple(pv.shape)} pages{tuple(pages.shape)}"
        )
    B, S, nq, dh = q.shape
    N, ps, nkv, _ = pk.shape
    Pp = pages.shape[1]
    Lk = Pp * ps
    if pk.shape[3] != dh or nkv == 0 or nq % nkv or pages.shape[0] != B:
        raise ValueError(f"paged_flash_decode: q{tuple(q.shape)}, pool{tuple(pk.shape)} and "
                         f"pages{tuple(pages.shape)} do not match")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_flash_decode: head dim {dh} not in {HEAD_DIMS}")
    if (nq // nkv) * S > MAX_ROWS or ps > MAX_PAGE_SIZE or S == 0 or Pp == 0 or B == 0:
        raise ValueError(f"paged_flash_decode: needs 1 <= g*S <= {MAX_ROWS} and page size <= "
                         f"{MAX_PAGE_SIZE}, got g*S={(nq // nkv) * S}, page size {ps}")
    if q.dtype not in _Q_TYPES or pk.dtype not in _KV_TYPES or pv.dtype != pk.dtype:
        raise ValueError(f"paged_flash_decode: dtypes q {q.dtype}, pool {pk.dtype}/{pv.dtype}")
    quant = k_scales is not None
    if quant != (pk.dtype in (torch.int8, torch.float8_e4m3fn)) or (v_scales is None) == quant:
        raise ValueError("paged_flash_decode: int8/fp8 pools need k_scales and v_scales, "
                         "and only they take them")
    if quant:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.shape != (N, nkv) or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"paged_flash_decode: {name} must be contiguous f32 ({N}, {nkv})")
    if not (q.is_contiguous() and pk.is_contiguous() and pv.is_contiguous()):
        raise ValueError("paged_flash_decode: q and the pool must be contiguous")
    dev = q.device
    tensors = [q, pk, pv, pages, q_pos, kv_pos] + [t for t in (k_scales, v_scales) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_flash_decode: tensors on different CUDA devices")

    tbl = pages.to(torch.int32).contiguous()
    qp = _vector("q_pos", q_pos, B, S, torch.int32)
    kp = _vector("kv_pos", kv_pos, B, Lk, torch.int32)
    use_seg = q_seg is not None and kv_seg is not None
    local = local_only and use_seg
    use_contrib = contributed is not None and not local and use_seg
    qs = _vector("q_seg", q_seg, B, S, torch.int32) if use_seg else None
    ks = _vector("kv_seg", kv_seg, B, Lk, torch.int32) if use_seg else None
    kc = _vector("contributed", contributed, B, Lk, torch.uint8) if use_contrib else None
    lo = None
    if publisher_lo is not None:
        lo = torch.as_tensor(publisher_lo, device=dev).reshape(-1).to(torch.int32).contiguous()
        if lo.shape[0] not in (1, B):
            raise ValueError(f"paged_flash_decode: publisher_lo expected 1 or {B} values")
    for t in (qs, ks, kc, lo):
        if t is not None and t.device != dev:
            raise ValueError("paged_flash_decode: vectors on a different device than q")
    stride = lambda t, L: 0 if t is None or t.shape[0] == 1 else L
    ptr = lambda t: None if t is None else t.data_ptr()

    n_split, per_split = split_count(B, nkv, Pp)
    n_chunks = max(1, min(64, math.ceil(COMBINE_BLOCKS / B)))
    f32 = dict(dtype=torch.float32, device=dev)
    m_p = torch.empty((n_split, B, nq, S), **f32)
    l_p = torch.empty((n_split, B, nq, S), **f32)
    acc_p = torch.empty((n_split, B, nq, S, dh), **f32)
    sc = torch.empty((B, nq, S, Lk), **f32) if return_mass else None
    out = m_out = l_out = acc_out = mass = None
    if return_stats:
        m_out, l_out = torch.empty((B, nq, S), **f32), torch.empty((B, nq, S), **f32)
        acc_out = torch.empty((B, S, nq, dh), **f32)
        mass = torch.empty((B, nq, S, Lk), **f32) if return_mass else None
    else:
        out = torch.empty_like(q)
        mass = torch.empty((B, Lk), **f32) if return_mass else None

    lib = _library()
    err = lib.repro_paged_flash_decode(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), ptr(k_scales), ptr(v_scales),
        tbl.data_ptr(), qp.data_ptr(), kp.data_ptr(), ptr(qs), ptr(ks), ptr(kc), ptr(lo),
        m_p.data_ptr(), l_p.data_ptr(), acc_p.data_ptr(), ptr(sc),
        ptr(out), ptr(m_out), ptr(l_out), ptr(acc_out), ptr(mass),
        B, S, nq, nkv, N, ps, Pp, dh, _Q_TYPES[q.dtype], _KV_TYPES[pk.dtype],
        stride(qp, S), stride(kp, Lk), stride(qs, S), stride(ks, Lk), stride(kc, Lk),
        stride(lo, 1),
        int(causal), int(use_seg), int(local), int(use_contrib),
        int(window is not None), int(window or 0), int(lo is not None),
        n_split, per_split, n_chunks, int(return_stats),
        float(soft_cap or 0.0), float(sm_scale if sm_scale is not None else dh**-0.5),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "paged_flash_decode launch")
    paged_flash_decode.launches += 1
    if return_stats:
        return (m_out, l_out, acc_out, mass) if return_mass else (m_out, l_out, acc_out)
    return (out, mass) if return_mass else out


paged_flash_decode.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("paged_flash_decode")
    fn = lib.repro_paged_flash_decode
    if not fn.argtypes:
        # 21 pointers; B, S, nq, nkv, N, ps, Pp, dh, q_type, kv_type; 6 vector
        # strides; 7 flags/window; n_split, pages_per_split, n_chunks,
        # return_stats; soft_cap, sm_scale; the stream
        fn.argtypes = (
            [ctypes.c_void_p] * 21 + [ctypes.c_int] * (10 + 6 + 7 + 4)
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
