"""K1 — FedAttn flash attention: the hand-written Hopper kernel and its
plain version.

Replaces the TPU kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flash_attention.py:140``). The CUDA source is
``csrc/flash_attention.cu`` (its header says what bounds it on the card and
how it is laid out); :func:`flash_attention` is its wrapper:

* CUDA tensors launch the kernel — there is no fallback: a shape, dtype or
  layout the kernel does not take raises, and so does a failed build or
  launch. ``flash_attention.launches`` counts the launches.
* CPU tensors go to :func:`flash_attention_plain`, the same blockwise
  online softmax (64-wide KV tiles) in plain torch. The tests and
  ``chip_smoke.py`` use it; ``flash_attention_plain.calls`` counts calls.

Vector contract: every position/segment/contribution vector may be shared
(1-D ``(L,)``) or per batch row (2-D ``(B, L)``); the kernel reads a row
stride of 0 or L. Flag semantics follow the TPU kernel: segments are used
only when both are given, ``local_only`` only with segments, ``contributed``
only when not ``local_only`` and segments are on.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

BLOCK_Q = 64  # query rows per thread block (csrc/flash_attention.cu: BQ)
BLOCK_K = 64  # KV rows per tile (csrc/flash_attention.cu: BK)
HEAD_DIMS = (64, 128)
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _vector(name: str, a: Optional[torch.Tensor], B: int, L: int, dtype) -> Optional[torch.Tensor]:
    """Normalize a vector to a contiguous ``(Bv, L)`` tensor, Bv ∈ {1, B}."""
    if a is None:
        return None
    a2 = a if a.dim() == 2 else a[None]
    if a2.dim() != 2 or a2.shape[0] not in (1, B) or a2.shape[1] != L:
        raise ValueError(f"{name}: expected ({{1,{B}}}, {L}), got {tuple(a.shape)}")
    return a2.to(dtype).contiguous()


def flash_attention(
    q: torch.Tensor,  # (B, Lq, nq, dh)
    k: torch.Tensor,  # (B, Lk, nkv, dh)
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # (Lq,) or (B, Lq)
    kv_pos: torch.Tensor,  # (Lk,) or (B, Lk)
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    causal: bool = True,
    local_only: bool = False,
    contributed: Optional[torch.Tensor] = None,  # (Lk,) or (B, Lk) bool
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """FedAttn-masked attention, returns (B, Lq, nq, dh) in q's dtype."""
    kw = dict(
        q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg, causal=causal,
        local_only=local_only, contributed=contributed, window=window,
        soft_cap=soft_cap, sm_scale=sm_scale,
    )
    devices = {t.device.type for t in (q, k, v, q_pos, kv_pos)}
    if devices == {"cpu"}:
        return flash_attention_plain(q, k, v, **kw)
    if devices != {"cuda"}:
        raise ValueError(f"flash_attention: tensors on {sorted(devices)}; expected one CUDA device")

    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Lq, nq, dh = q.shape
    _, Lk, nkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != dh or nkv == 0 or nq % nkv:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} and k{tuple(k.shape)} do not match")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in _IS_BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; expected float32 or bfloat16")
    if Lq == 0 or Lk == 0:
        raise ValueError("flash_attention: empty query or key sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if len({t.device for t in (q, k, v, q_pos, kv_pos)}) != 1:
        raise ValueError("flash_attention: tensors on different CUDA devices")

    qp = _vector("q_pos", q_pos, B, Lq, torch.int32)
    kp = _vector("kv_pos", kv_pos, B, Lk, torch.int32)
    use_seg = q_seg is not None and kv_seg is not None
    local = local_only and use_seg
    use_contrib = contributed is not None and not local and use_seg
    qs = _vector("q_seg", q_seg, B, Lq, torch.int32) if use_seg else None
    ks = _vector("kv_seg", kv_seg, B, Lk, torch.int32) if use_seg else None
    kc = _vector("contributed", contributed, B, Lk, torch.uint8) if use_contrib else None
    for t in (qs, ks, kc):
        if t is not None and t.device != q.device:
            raise ValueError("flash_attention: vectors on a different device than q")
    stride = lambda t, L: 0 if t is None or t.shape[0] == 1 else L
    ptr = lambda t: None if t is None else t.data_ptr()

    out = torch.empty_like(q)
    lib = _library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qp.data_ptr(), kp.data_ptr(), ptr(qs), ptr(ks), ptr(kc),
        B, Lq, Lk, nq, nkv, dh, _IS_BF16[q.dtype],
        stride(qp, Lq), stride(kp, Lk), stride(qs, Lq), stride(ks, Lk), stride(kc, Lk),
        int(causal), int(use_seg), int(local), int(use_contrib),
        int(window is not None), int(window or 0),
        float(soft_cap or 0.0), float(sm_scale if sm_scale is not None else dh**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_plain(q, k, v, **kw) -> torch.Tensor:
    """The kernel's plain version: blockwise online softmax over ``BLOCK_K``
    KV tiles with f32 ``m/l/acc`` — the chunked attention of
    :mod:`repro_torch.kernels.ops` at the kernel's tile width, so the two
    share one implementation of the arithmetic."""
    from repro_torch.kernels import ops

    flash_attention_plain.calls += 1
    return ops._chunked_attention(q, k, v, chunk=BLOCK_K, **kw)


flash_attention_plain.calls = 0


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    if not fn.argtypes:
        # 9 pointers; B, Lq, Lk, nq, nkv, dh, is_bf16; 5 vector strides;
        # 6 flags/window; soft_cap, sm_scale; the stream
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * (7 + 5 + 6)
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
