#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; it builds the kernels from ``src/repro_torch/csrc``
into ``build/repro_torch`` and imports nothing of JAX or of the JAX package.

Phases, each printing one JSON line (any failure raises; the script then
exits nonzero and prints no result):

  device   the card, its power limit, torch and CUDA versions
  build    nvcc of every kernel source, in parallel, with its seconds
  k1       the flash-attention kernel against its plain version on the card,
           at Qwen2.5-7B's prefill and decode shapes and every mask kind,
           with kernel / plain / library times and the card's bound
  parity   Qwen2.5-7B widths at 4 layers (one sync period) in f32:
           ``generate`` with backend 'cuda' equals backend 'torch'
  k2       the paged flash-decode kernel against its plain version on the
           card, at the serving pool's shape (16 slots, 128 pages of 16,
           Qwen2.5-7B heads) and every option: Phase I / II, verify rows,
           int8 / fp8 / f32 pools, holes and inactive slots, attention mass,
           publisher_lo, dh 64 with window and soft-cap; kernel / plain /
           yardstick times and the card's bound
  main     the dense main path: full 28-layer Qwen2.5-7B in bf16, random
           weights, ``FedAttnEngine.generate`` with B=4, L=1000, n_new=32,
           N=4, H=4, full and 0.5-strided KV exchange, once each, launch
           counts asserted; then one traced call (device busy share)
  pool_parity  Qwen2.5-7B widths at 4 layers in f32: a churning
           ``ContinuousBatchingScheduler`` with backend 'cuda' equals
           backend 'torch' (and, with f32 KV, standalone ``generate``) —
           f32, int8, spec_k=4 (scripted drafts: full, partial and zero
           accepts, each as planned) and prefix-cache pools
  pool     the serving path: full 28-layer Qwen2.5-7B in bf16 behind
           ``ContinuousBatchingScheduler`` (16 slots, pages of 16), 32
           requests of 256-1536 prompt tokens and 64 new tokens; bf16 (twice),
           0.5-strided, int8, fp8, spec_k=4, prefix-cache and attnmass runs,
           K2 launches = layers x ticks asserted; then one traced run
  serve    ``repro_torch.launch.serve.main`` once plain and once ``--stream``

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``. Every run runs every phase.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# bf16 and fp8/int8 tensor cores, f32 CUDA cores (K2 bounds a quantized pool
# by its code type)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "float8_e4m3fn": 1979e12}
F32_TOL = 2e-5  # f32: the kernel and its plain version differ by summation order only
# bf16: both sides compute in f32 and round once, so each element may differ
# by one bf16 ulp of its expected value; the floor covers f32 summation noise
# on outputs near 0, where that ulp is tiny
BF16_ATOL_FLOOR = 2.0**-14
PARITY_LOGPROB_ATOL = 1e-3  # f32 end to end through 4 full-width layers and the head
# K2's mass against its plain version: the kernel takes exp(s - m) at the
# combined max where the plain version rebases per-page numerators, so the
# two differ by a few f32 roundings relative to each value
MASS_RTOL, MASS_ATOL = 1e-4, 1e-7
SPEC_SCRIPT = [4, 1, 0, 2, 3]  # pool_parity's accepts per verify tick (spec_k=4)
STATS_TOL = 2e-5  # K2's f32 (m, l, acc) stats: summation order only, relative


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


# ---------------------------------------------------------------------------
# K1 cases
# ---------------------------------------------------------------------------


def main_path_vectors(L: int, Lp: int, capacity: int, n: int, device):
    """The prefill vectors the engine gives K1 for an L-token prompt split
    over n participants, bucketed to Lp, against a capacity-slot cache."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.aggregation import contribution_mask
    from repro_torch.core.partition import Partition
    from repro_torch.kernels.core import PAD_SEGMENT

    part = Partition.contiguous(L, n)
    seg = part.segment_ids
    kv_seg = torch.cat([seg, torch.full((capacity - L,), n - 1, dtype=torch.int32)])
    contrib = F.pad(contribution_mask(part, 0.5, "strided"), (0, capacity - L), value=False)
    return dict(
        q_pos=torch.arange(Lp, dtype=torch.int32, device=device),
        q_seg=F.pad(seg, (0, Lp - L), value=PAD_SEGMENT).to(device),
        kv_pos=torch.arange(capacity, dtype=torch.int32, device=device),
        kv_seg=kv_seg.to(device),
        contributed=contrib.to(device),
    )


def k1_cases(device):
    """(name, q, k, v, kwargs): the main path's shapes and every mask kind."""
    import torch

    from repro_torch.kernels.core import PAD_POS, PAD_SEGMENT

    gen = torch.Generator(device=device).manual_seed(1234)

    def qkv(B, Lq, Lk, nq, nkv, dh, dtype):
        r = lambda *s: torch.randn(*s, generator=gen, device=device, dtype=torch.float32).to(dtype)
        return r(B, Lq, nq, dh), r(B, Lk, nkv, dh), r(B, Lk, nkv, dh)

    bf16, f32 = torch.bfloat16, torch.float32
    L, Lp, cap, n = 1000, 1024, 1056, 4  # B=4, L=1000 → bucket 1024, n_new=32
    vec = main_path_vectors(L, Lp, cap, n, device)
    prefill = {k: vec[k] for k in ("q_pos", "kv_pos", "q_seg", "kv_seg")}
    step = 15
    decode = dict(
        q_pos=torch.tensor([L + step], dtype=torch.int32, device=device),
        q_seg=torch.tensor([n - 1], dtype=torch.int32, device=device),
        kv_pos=vec["kv_pos"], kv_seg=vec["kv_seg"],
    )
    cases = [
        ("prefill_local", *qkv(4, Lp, cap, 28, 4, 128, bf16), dict(prefill, local_only=True)),
        ("prefill_sync", *qkv(4, Lp, cap, 28, 4, 128, bf16), dict(prefill)),
        ("prefill_contributed", *qkv(4, Lp, cap, 28, 4, 128, bf16),
         dict(prefill, contributed=vec["contributed"])),
        ("decode_local", *qkv(4, 1, cap, 28, 4, 128, bf16), dict(decode, local_only=True)),
        ("decode_sync", *qkv(4, 1, cap, 28, 4, 128, bf16), dict(decode)),
        ("f32_contributed", *qkv(2, 300, 333, 28, 4, 128, f32),
         dict(q_pos=vec["q_pos"][:300], kv_pos=vec["kv_pos"][:333], q_seg=vec["q_seg"][:300],
              kv_seg=vec["kv_seg"][:333], contributed=vec["contributed"][:333])),
        ("dh64_window_softcap", *qkv(2, 200, 260, 4, 1, 64, bf16),
         dict(q_pos=vec["q_pos"][60:260], kv_pos=vec["kv_pos"][:260], window=37, soft_cap=20.0)),
    ]
    # per-row (B, L) vectors: each row its own frontier, partition and PAD
    # columns; row 2's query rows all carry PAD_SEGMENT (fully masked)
    B, Lq, Lk = 3, 130, 200
    q_pos = torch.stack([torch.arange(Lk - Lq, Lk) - 7 * b for b in range(B)]).int()
    kv_pos = torch.arange(Lk).repeat(B, 1).int()
    kv_pos[:, -9:] = PAD_POS
    kv_seg = torch.stack([(torch.arange(Lk) * (b + 2) // Lk) for b in range(B)]).int()
    kv_seg[0, 5:20] = PAD_SEGMENT
    q_seg = kv_seg[:, Lk - Lq:].clone()
    q_seg[2] = PAD_SEGMENT
    contrib = torch.rand(B, Lk, generator=torch.Generator().manual_seed(5)) < 0.3
    per_row = dict(q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg)
    per_row = {k: v.to(device) for k, v in per_row.items()}
    cases += [
        ("per_row_local", *qkv(B, Lq, Lk, 28, 4, 128, bf16), dict(per_row, local_only=True)),
        ("per_row_contributed", *qkv(B, Lq, Lk, 28, 4, 128, f32),
         dict(per_row, contributed=contrib.to(device))),
    ]
    return cases


def k1_visibility(kw):
    """The (1 or B, Lq, Lk) boolean mask K1 applies for these arguments."""
    from repro_torch.kernels.core import visibility

    return visibility(
        kw["q_pos"], kw["kv_pos"], kw.get("q_seg"), kw.get("kv_seg"),
        causal=kw.get("causal", True), local_only=kw.get("local_only", False),
        contributed=kw.get("contributed"), window=kw.get("window"),
    )


def k1_bound(q, k, v, kw) -> tuple[float, str]:
    """Least time for the same work on an H100: q and the vectors read once,
    the K/V rows that some query of the batch row can see read once, the
    output written once, over HBM's rate; against 4·dh operations for each
    (row, head, visible key) pair over the peak rate of the input type."""
    B, Lq, nq, dh = q.shape
    vis = k1_visibility(kw)
    rep = B // vis.shape[0]
    pairs = int(vis.sum()) * rep
    ops = 4.0 * dh * nq * pairs
    kv_rows = int(vis.any(dim=1).sum()) * rep
    kv_bytes = 2 * kv_rows * k.shape[2] * dh * k.element_size()
    vec_bytes = sum(t.numel() * t.element_size() for n_, t in kw.items()
                    if n_ in ("q_pos", "kv_pos", "q_seg", "kv_seg", "contributed"))
    moved = 2 * q.numel() * q.element_size() + kv_bytes + vec_bytes
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_tolerance(want):
    """Per-element tolerance of K1 against its plain version."""
    import torch

    if want.dtype == torch.float32:
        return torch.full_like(want, F32_TOL)
    a = want.float().abs()
    return torch.exp2(torch.floor(torch.log2(a)) - 7) + BF16_ATOL_FLOOR  # log2(0) → ulp 0


def flex_softcap(vis, cap: float, Lq: int, Lk: int):
    """Compiled ``flex_attention`` with the logit soft-cap ``tanh(s/c)·c`` as
    its score_mod and the (1 or B, Lq, Lk) mask ``vis`` as its block mask
    (SDPA has no soft-cap). Returns ``fn(q, k, v)`` on (B, heads, L, dh)."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    row = (lambda b: b) if vis.shape[0] > 1 else (lambda b: 0)

    def mask_mod(b, h, q_idx, kv_idx):
        return vis[row(b), q_idx, kv_idx]

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap

    block_mask = create_block_mask(mask_mod, vis.shape[0] if vis.shape[0] > 1 else None, None,
                                   Lq, Lk, device=vis.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: flex(q, k, v, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)


def k1_library(q, k, v, kw):
    """One PyTorch call computing K1's function, timed as a yardstick only:
    SDPA with K1's boolean mask, or, with a logit soft-cap, compiled
    ``flex_attention`` (:func:`flex_softcap`). Returns the call."""
    import torch.nn.functional as F

    vis = k1_visibility(kw)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kw.get("soft_cap") is None:
        g = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis[:, None])
    flex = flex_softcap(vis, float(kw["soft_cap"]), q.shape[1], k.shape[1])
    return lambda: flex(qt, kt, vt)


def phase_k1(device) -> list[dict]:
    import torch

    from repro_torch.kernels import flash_attention as fa

    results = []
    for name, q, k, v, kw in k1_cases(device):
        out = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"k1 {name}: non-finite kernel output")
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        worst = (diff / k1_tolerance(want)).max().item()
        if not worst <= 1.0:
            raise AssertionError(f"k1 {name}: an element exceeds its tolerance {worst:.3g}-fold")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 5, warmup=1)
        library = k1_library(q, k, v, kw)
        lib_diff = (library().transpose(1, 2).float() - want.float()).abs()
        seen = k1_visibility(kw).any(-1)[..., None, None]  # the library gives NaN on rows with no key
        library_err = torch.where(seen, lib_diff, 0.0).max().item()
        library_ms = time_ms(library, 10)
        bound_ms, bound_by = k1_bound(q, k, v, kw)
        row = dict(
            name=name, shape=[list(q.shape), list(k.shape)], dtype=str(q.dtype).removeprefix("torch."),
            max_abs_err=err, err_over_tol=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library_max_abs_err=library_err, bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("k1", **row)
        results.append(row)
    return results


# ---------------------------------------------------------------------------
# K2 cases
# ---------------------------------------------------------------------------

POOL_SLOTS, POOL_PAGE, POOL_CAP = 16, 16, 2048  # the pool phase's geometry


def pool_tables(B, Pp, N, lens, device, gen, inactive=()):
    """Page tables, kv segments and query positions of B slots whose prompts
    have ``lens`` tokens and have decoded 40 more: each slot owns the pages
    of its span (drawn without replacement from N), the rest of its table is
    the hole sentinel N; inactive slots have all-sentinel tables and
    PAD_SEGMENT rows, as a retired slot does in the pool."""
    import torch

    from repro_torch.core.partition import Partition
    from repro_torch.kernels.core import PAD_SEGMENT
    from repro_torch.serving import paging

    ps = POOL_PAGE
    perm = torch.randperm(N, generator=gen)
    pages = torch.full((B, Pp), N, dtype=torch.int32)
    kv_seg = torch.full((B, Pp * ps), PAD_SEGMENT, dtype=torch.int32)
    q_pos = torch.zeros(B, dtype=torch.int32)
    used = 0
    for b, L in enumerate(lens):
        if b in inactive:
            continue
        n = paging.pages_for(L + 41, ps)
        pages[b, :n] = perm[used:used + n].int()
        used += n
        seg = Partition.contiguous(L, 4).segment_ids
        kv_seg[b] = torch.cat([seg, torch.full((kv_seg.shape[1] - L,), 3, dtype=torch.int32)])
        q_pos[b] = L + 40
    return pages.to(device), kv_seg.to(device), q_pos.to(device)


def k2_cases(device):
    """(name, q, pk, pv, pages, kwargs): the pool phase's shapes and every
    option of the kernel."""
    import torch

    from repro_torch.core.aggregation import contribution_mask
    from repro_torch.core.partition import Partition
    from repro_torch.kernels.core import PAD_SEGMENT
    from repro_torch.serving import quant

    gen = torch.Generator().manual_seed(4321)
    B, Pp, N = POOL_SLOTS, POOL_CAP // POOL_PAGE, POOL_SLOTS * POOL_CAP // POOL_PAGE
    lens = torch.randint(POOL_CAP // 8, POOL_CAP * 3 // 4 + 1, (B,), generator=gen).tolist()  # 256-1536
    r = lambda *shape, dtype=torch.bfloat16: torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)

    def pool(dtype, n=N, ps=POOL_PAGE, nkv=4, dh=128):
        if dtype in (torch.int8, torch.float8_e4m3fn):
            codes, scales = zip(*(quant.quantize_block(r(n, ps, nkv, dh, dtype=torch.float32), dtype)
                                  for _ in range(2)))
            return codes[0], codes[1], dict(k_scales=scales[0].contiguous(), v_scales=scales[1].contiguous())
        return r(n, ps, nkv, dh, dtype=dtype), r(n, ps, nkv, dh, dtype=dtype), {}

    pages, kv_seg, q_pos = pool_tables(B, Pp, N, lens, device, gen)
    kv_pos = torch.arange(POOL_CAP, dtype=torch.int32, device=device)
    pub = torch.full((B, 1), 3, dtype=torch.int32, device=device)
    base = dict(q_pos=q_pos[:, None], kv_pos=kv_pos, q_seg=pub, kv_seg=kv_seg)
    cases = []
    pk, pv, _ = pool(torch.bfloat16)
    cases += [
        ("pool_phase1", r(B, 1, 28, 128), pk, pv, pages, dict(base, local_only=True)),
        ("pool_phase2", r(B, 1, 28, 128), pk, pv, pages, dict(base)),
    ]
    S = 5
    verify = dict(base, q_pos=q_pos[:, None] + torch.arange(S, device=device)[None].int(),
                  q_seg=pub.expand(B, S).contiguous())
    cases.append(("verify_S5", r(B, S, 28, 128), pk, pv, pages, verify))
    for dt, name in ((torch.int8, "int8_pool"), (torch.float8_e4m3fn, "fp8_pool")):
        qk, qv, sc = pool(dt)
        cases.append((name, r(B, 1, 28, 128), qk, qv, pages, dict(base, **sc)))
    # holes and inactive slots: slots 3, 7 and 11 retired — their rows are
    # all PAD_SEGMENT and their tables all sentinel, so their output is 0
    ipages, ikv_seg, iq_pos = pool_tables(B, Pp, N, lens, device, gen, inactive=(3, 7, 11))
    iq_seg = pub.clone()
    iq_seg[[3, 7, 11]] = PAD_SEGMENT
    cases.append(("holes_inactive", r(B, 1, 28, 128), pk, pv, ipages,
                  dict(q_pos=iq_pos[:, None], kv_pos=kv_pos, q_seg=iq_seg, kv_seg=ikv_seg)))
    contrib = torch.zeros(B, POOL_CAP, dtype=torch.bool)
    for b, L in enumerate(lens):
        contrib[b, :L] = contribution_mask(Partition.contiguous(L, 4), 0.5, "strided")
    mass = dict(base, contributed=contrib.to(device), return_mass=True)
    cases += [
        ("mass_contributed", r(B, 1, 28, 128), pk, pv, pages, mass),
        ("stats_mass", r(B, 1, 28, 128), pk, pv, pages, dict(mass, return_stats=True)),
        ("publisher_lo", r(B, 1, 28, 128), pk, pv, pages,
         dict(base, publisher_lo=torch.tensor([L * 3 // 4 for L in lens], device=device))),
    ]
    # dh 64, g = 4, an odd page size, sliding window and logit soft-cap
    sB, sps, sPp = 4, 7, 40
    sN = sB * sPp
    spk, spv, _ = pool(torch.bfloat16, n=sN, ps=sps, nkv=2, dh=64)
    spages = torch.randperm(sN, generator=gen)[: sB * sPp].reshape(sB, sPp).int().to(device)
    spages[:, -3:] = sN
    cases.append(("dh64_window_softcap_ps7", r(sB, 2, 8, 64), spk, spv, spages, dict(
        q_pos=torch.tensor([[250, 251]] * sB, dtype=torch.int32, device=device),
        kv_pos=torch.arange(sPp * sps, dtype=torch.int32, device=device), window=61, soft_cap=20.0)))
    fk, fv, _ = pool(torch.float32)
    cases.append(("f32_pool", r(B, 1, 28, 128, dtype=torch.float32), fk, fv, pages, dict(base)))
    return cases


def k2_visibility(q, pk, pages, kw):
    """(B, S, Lk) mask K2 applies, sentinel columns already hidden."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.core import visibility

    qp, kp, qs, ks, ct = fd._prep(q, pk, pages, kw["q_pos"], kw["kv_pos"], kw.get("q_seg"),
                                  kw.get("kv_seg"), kw.get("contributed"), kw.get("local_only", False))
    return visibility(qp, kp, qs, ks, local_only=kw.get("local_only", False), contributed=ct,
                      window=kw.get("window"), publisher_lo=kw.get("publisher_lo"))


def k2_bound(q, pk, pages, kw, outs) -> tuple[float, str]:
    """Least time for the same work on an H100: q, the tables and vectors,
    every page some query row of its slot can see (K and V, all KV heads,
    with its scales) read once, the outputs written once, over HBM's rate;
    against 4·dh operations per (query row, head, visible key) over the
    peak rate of the pool's type."""
    B, S, nq, dh = q.shape
    N, ps, nkv, _ = pk.shape
    vis = k2_visibility(q, pk, pages, kw)  # (B, S, Lk)
    pages_seen = int(vis.reshape(B, S, -1, ps).any(dim=(1, 3)).sum())
    kv_bytes = pages_seen * 2 * ps * nkv * dh * pk.element_size()
    if kw.get("k_scales") is not None:
        kv_bytes += pages_seen * 2 * nkv * 4
    vec_bytes = sum(t.numel() * t.element_size() for n_, t in kw.items()
                    if n_ in ("q_pos", "kv_pos", "q_seg", "kv_seg", "contributed", "publisher_lo")
                    and hasattr(t, "numel"))
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    moved = q.numel() * q.element_size() + pages.numel() * 4 + kv_bytes + vec_bytes + out_bytes
    ops = 4.0 * dh * (nq // nkv) * nkv * int(vis.sum())
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(pk.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_library(q, pk, pv, pages, kw):
    """The yardstick: the pages gathered by ``index_select`` (and, for a
    quantized pool, dequantized), then ``scaled_dot_product_attention`` with
    K2's mask, or, with a logit soft-cap, compiled ``flex_attention``
    (:func:`flex_softcap`). Timed only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    B, S, nq, dh = q.shape
    N, ps, nkv, _ = pk.shape
    idx = torch.clamp(pages.reshape(-1).long(), max=N - 1)
    vis = k2_visibility(q, pk, pages, kw)
    qt = q.transpose(1, 2)
    flex = flex_softcap(vis, float(kw["soft_cap"]), S, pages.shape[1] * ps) if kw.get("soft_cap") else None

    def run():
        k = torch.index_select(pk, 0, idx)
        v = torch.index_select(pv, 0, idx)
        if kw.get("k_scales") is not None:
            k = k.float() * torch.index_select(kw["k_scales"], 0, idx)[:, None, :, None]
            v = v.float() * torch.index_select(kw["v_scales"], 0, idx)[:, None, :, None]
        k = k.to(q.dtype).reshape(B, -1, nkv, dh).transpose(1, 2)
        v = v.to(q.dtype).reshape(B, -1, nkv, dh).transpose(1, 2)
        if flex is not None:
            return flex(qt, k, v)
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=vis[:, None], enable_gqa=True)

    return run


def phase_k2(device) -> list[dict]:
    import torch

    from repro_torch.kernels import flash_decode as fd

    results, failed = [], []  # every case runs and prints before a failure raises
    for name, q, pk, pv, pages, kw in k2_cases(device):
        got = fd.paged_flash_decode(q, pk, pv, pages, **kw)
        want = fd.paged_flash_decode_plain(q, pk, pv, pages, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        row = dict(name=name, q=list(q.shape), pool=list(pk.shape), pool_dtype=str(pk.dtype).removeprefix("torch."),
                   pages=list(pages.shape))
        # each rule takes the expected tensor in its own dtype: bf16 outputs
        # get the bf16 ulp rule, f32 outputs and stats the f32 ones
        if kw.get("return_stats"):
            tols = [lambda w: STATS_TOL * (1 + w.abs())] * 3
        else:
            tols = [k1_tolerance]
        if kw.get("return_mass"):
            tols.append(lambda w: MASS_RTOL * w.abs() + MASS_ATOL)
        worst, errs = 0.0, []
        for g, w, tol in zip(got, want, tols):
            if not torch.isfinite(g).all():
                raise AssertionError(f"k2 {name}: non-finite kernel output")
            diff = (g.float() - w.float()).abs()
            errs.append(diff.max().item())
            worst = max(worst, (diff / tol(w)).max().item())
        if not worst <= 1.0:
            failed.append(f"{name}: an element exceeds its tolerance {worst:.3g}-fold")
        if name == "holes_inactive" and not (got[0][[3, 7, 11]] == 0).all():
            failed.append("holes_inactive: inactive slots' output is not exactly 0")
        ms = time_ms(lambda: fd.paged_flash_decode(q, pk, pv, pages, **kw), 20)
        plain_ms = time_ms(lambda: fd.paged_flash_decode_plain(q, pk, pv, pages, **kw), 5, warmup=1)
        lib = k2_library(q, pk, pv, pages, kw)
        lib_err = None
        if not kw.get("return_stats"):  # the library gives NaN on rows with no key
            seen = k2_visibility(q, pk, pages, kw).any(-1)[..., None, None]
            lib_diff = (lib().transpose(1, 2).float() - want[0].float()).abs()
            lib_err = torch.where(seen, lib_diff, 0.0).max().item()
        library_ms = time_ms(lib, 10)
        bound_ms, bound_by = k2_bound(q, pk, pages, kw, got)
        row.update(max_abs_err=errs[0], max_abs_err_all=errs, err_over_tol=worst, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library="index_select + " + ("flex_attention" if kw.get("soft_cap") else "scaled_dot_product_attention"),
                   library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by,
                   splits=list(fd.split_count(pages.shape[0], pk.shape[2], pages.shape[1])))
        emit("k2", **row)
        results.append(row)
    if failed:
        raise AssertionError("k2: " + "; ".join(failed))
    return results


# ---------------------------------------------------------------------------
# End-to-end phases
# ---------------------------------------------------------------------------


def phase_parity(device) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import FedAttnEngine

    cfg = get_config("qwen2.5-7b").replace(n_layers=4, dtype="float32")
    params = TransformerLM(cfg).init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(
        3, cfg.vocab_size, (2, 300), generator=torch.Generator(device=device).manual_seed(1),
        device=device,
    )
    for ratio in (1.0, 0.5):
        fed = cfg.fedattn.replace(kv_exchange_ratio=ratio, kv_selection="strided")
        got = FedAttnEngine(cfg, params, fedattn=fed, backend="cuda").generate(tokens, 8)
        want = FedAttnEngine(cfg, params, fedattn=fed, backend="torch").generate(tokens, 8)
        diff = float(np.abs(got.logprobs - want.logprobs).max())
        emit("parity", layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.dtype,
             kv_exchange_ratio=ratio, tokens_equal=bool((got.tokens == want.tokens).all()),
             logprob_max_diff=diff, atol=PARITY_LOGPROB_ATOL)
        if not (got.tokens == want.tokens).all():
            raise AssertionError(f"parity: tokens differ\n{got.tokens}\n{want.tokens}")
        if not diff <= PARITY_LOGPROB_ATOL:
            raise AssertionError(f"parity: logprob diff {diff} > {PARITY_LOGPROB_ATOL}")
    del params
    torch.cuda.empty_cache()


def phase_main(device) -> int:
    """Returns K1's launch count over the measured generate calls."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import FedAttnEngine

    cfg = get_config("qwen2.5-7b")
    B, L, n_new = 4, 1000, 32
    t0 = time.perf_counter()
    params = TransformerLM(cfg).init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    tokens = torch.randint(
        3, cfg.vocab_size, (B, L), generator=torch.Generator(device=device).manual_seed(1),
        device=device,
    )
    engines = {
        "full": FedAttnEngine(cfg, params),
        "strided_0.5": FedAttnEngine(
            cfg, params, fedattn=cfg.fedattn.replace(kv_exchange_ratio=0.5, kv_selection="strided"),
        ),
    }
    prefill_s = {}
    for name, eng in engines.items():  # warm-up; the second call times the prefill alone
        for _ in range(2):
            t0 = time.perf_counter()
            eng.generate(tokens, 1)
            prefill_s[name] = time.perf_counter() - t0

    per_call = cfg.n_layers * n_new  # 1 prefill + n_new-1 decode steps per layer
    fa.flash_attention.launches = 0
    fa.flash_attention_plain.calls = 0
    torch.cuda.reset_peak_memory_stats()
    for rnd in range(1):  # one round per run: the pool phase below needs the time
        for name, eng in engines.items():
            before = fa.flash_attention.launches
            t0 = time.perf_counter()
            res = eng.generate(tokens, n_new)  # returns host arrays: ends synchronized
            wall = time.perf_counter() - t0
            launches = fa.flash_attention.launches - before
            if launches != per_call:
                raise AssertionError(f"main {name}: {launches} K1 launches, expected {per_call}")
            if res.tokens.shape != (B, n_new) or not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
                raise AssertionError(f"main {name}: bad tokens {res.tokens}")
            if not (np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()):
                raise AssertionError(f"main {name}: bad logprobs {res.logprobs}")
            decode_s = wall - prefill_s[name]
            emit("main", run=name, round=rnd, arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                 batch=B, prompt_len=L, n_new=n_new, participants=eng.fed.n_participants,
                 sync_layers=sum(s.sync for s in cfg.layer_specs()), weights_gb=weight_gb,
                 init_s=init_s, wall_s=wall, tok_per_s=B * n_new / wall, prefill_s=prefill_s[name],
                 decode_s=decode_s, decode_ms_per_step=decode_s / (n_new - 1) * 1e3,
                 k1_launches=launches, plain_calls=fa.flash_attention_plain.calls,
                 max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                 first_tokens=res.tokens[:, :8].tolist())
    total = fa.flash_attention.launches
    if fa.flash_attention_plain.calls != 0:
        raise AssertionError(f"main: plain version called {fa.flash_attention_plain.calls} times")
    phase_trace(engines["full"], tokens, n_new)
    del params, engines, eng
    torch.cuda.empty_cache()
    return total


def phase_trace(eng, tokens, n_new: int) -> None:
    """Where one generate call's device time goes: torch.profiler over one
    full-exchange call; the device's busy share is its kernel time over the
    traced wall time (tracing slows the host, so the share is a floor)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(tokens, n_new)
        wall = time.perf_counter() - t0
    emit("trace", run="full", **kernel_summary(prof, wall))


def kernel_summary(prof, wall: float) -> dict:
    """Device kernel time of a profile, its share of the traced wall time,
    and the top kernels by time."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # operator events also carry their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    return dict(traced_wall_s=wall, device_kernel_s=device_s, device_busy_share=device_s / wall,
                top=[dict(name=key[:100], ms=us / 1e3, count=count) for us, count, key in rows[:12]])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_serve() -> None:
    from repro_torch.launch import serve

    for argv in (["--n-new", "8"], ["--stream", "--stream-requests", "16", "--arrival-rate", "50"]):
        t0 = time.perf_counter()
        serve.main(["--arch", "qwen2-7b", "--device", "cuda", *argv])
        emit("serve", arch="qwen2-7b (reduced)", argv=argv, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The serving pool
# ---------------------------------------------------------------------------


def pool_requests(n, lo, hi, n_new, seed, vocab, *, prefix=0, sampled=False):
    """``n`` requests with prompt lengths uniform in [lo, hi] from ``seed``.
    With ``prefix`` every prompt starts with the same ``prefix`` tokens and
    participants 0-2 hold ``prefix / 4`` tokens each, so the shared span has
    the same partition in every request (the prefix cache keys on both)."""
    import numpy as np
    import torch

    from repro_torch.core.partition import Partition
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    stem = rng.integers(3, vocab, prefix)
    out = []
    for i in range(n):
        L = int(rng.integers(lo, hi + 1))
        toks = np.concatenate([stem, rng.integers(3, vocab, L - prefix)])
        part = Partition.from_sizes([prefix // 4] * 3 + [L - 3 * (prefix // 4)]) if prefix else None
        out.append(Request(tokens=toks, n_new=n_new if np.isscalar(n_new) else int(n_new[i]),
                           partition=part, temperature=0.7 if sampled and i % 2 else 0.0,
                           generator=torch.Generator().manual_seed(50 + i) if sampled else None))
    return out


def phase_pool_parity(device) -> None:
    """Qwen2.5-7B widths at 4 layers in f32: the pool on the card through K1
    and K2 against the plain-torch pool, and (f32 KV) against standalone
    ``generate`` per request."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import FedAttnEngine
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    from repro_torch.serving.spec import ScriptedDrafter

    cfg = get_config("qwen2.5-7b").replace(n_layers=4, dtype="float32")
    params = TransformerLM(cfg).init(torch.Generator(device=device).manual_seed(0))
    n_new = [1, 9, 4, 12, 2, 7, 5, 10, 3, 8]
    runs = {
        "f32": (pool_requests(10, 40, 300, n_new, 11, cfg.vocab_size, sampled=True), {}),
        "int8": (pool_requests(10, 40, 300, n_new, 12, cfg.vocab_size), dict(kv_quant="int8")),
        "spec_k4": (pool_requests(10, 40, 300, n_new, 13, cfg.vocab_size, sampled=True), dict(spec_k=4)),
        "prefix": (pool_requests(10, 140, 300, n_new, 14, cfg.vocab_size, prefix=128),
                   dict(prefix_cache=True)),
    }
    gen_eng = FedAttnEngine(cfg, params, backend="cuda")
    for name, (reqs, kw) in runs.items():
        wants = []
        for r in reqs:
            g = torch.Generator().manual_seed(r.generator.initial_seed()) if r.generator else None
            wants.append(gen_eng.generate(torch.as_tensor(r.tokens)[None], r.n_new, partition=r.partition,
                                          temperature=r.temperature, generator=g))
        res, drafters = {}, {}
        for backend in ("cuda", "torch"):
            if kw.get("spec_k"):
                # drafts from generate's own tokens: full, partial and zero accepts
                drafters[backend] = ScriptedDrafter({tuple(r.tokens): w.tokens[0] for r, w in zip(reqs, wants)},
                                                    SPEC_SCRIPT, cfg.vocab_size)
            eng = FedAttnEngine(cfg, params, backend=backend)
            sched = ContinuousBatchingScheduler(
                eng, max_slots=4, capacity=ContinuousBatchingScheduler.capacity_for(eng, reqs),
                drafter=drafters.get(backend), **kw)
            launches = fd.paged_flash_decode.launches
            res[backend] = sched.run(reqs)
            if backend == "cuda" and fd.paged_flash_decode.launches - launches != cfg.n_layers * sched.stats["ticks"]:
                raise AssertionError(f"pool_parity {name}: K2 launches != layers x ticks")
        same = all((a.tokens == b.tokens).all() for a, b in zip(res["cuda"], res["torch"]))
        diff = max(float(np.abs(a.logprobs - b.logprobs).max()) for a, b in zip(res["cuda"], res["torch"]))
        gen_same = [bool((w.tokens == got.tokens).all()) for w, got in zip(wants, res["cuda"])]
        accepts = {b: d.summary(kw["spec_k"]) for b, d in drafters.items()}
        emit("pool_parity", run=name, layers=cfg.n_layers, dtype=cfg.dtype, requests=len(reqs),
             tokens_equal=same, logprob_max_diff=diff, atol=PARITY_LOGPROB_ATOL,
             equal_to_generate=sum(gen_same), ticks=sched.stats["ticks"],
             prefix_hits=sched.pool_stats().get("prefix_hits"),
             spec_accepted=sched.stats["spec_accepted"], spec_drafted=sched.stats["spec_drafted"],
             accepts=accepts)
        if not same:
            raise AssertionError(f"pool_parity {name}: 'cuda' and 'torch' pools give different tokens")
        if not diff <= PARITY_LOGPROB_ATOL:
            raise AssertionError(f"pool_parity {name}: logprob diff {diff} > {PARITY_LOGPROB_ATOL}")
        if name != "int8" and not all(gen_same):  # quantized KV is not generate's cache
            raise AssertionError(f"pool_parity {name}: pool tokens differ from generate: {gen_same}")
        for b, a in accepts.items():
            if not (a["as_planned"] and a["full"] and a["partial"] and a["zero"]):
                raise AssertionError(f"pool_parity {name} ({b}): verify did not accept as scripted: {a}")
    del params, gen_eng
    torch.cuda.empty_cache()


def phase_pool(device) -> int:
    """The serving path at full width; returns K2's launches over its runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import FedAttnEngine
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    cfg = get_config("qwen2.5-7b")
    params = TransformerLM(cfg).init(torch.Generator(device=device).manual_seed(0))
    reqs = pool_requests(32, 256, 1536, 64, 21, cfg.vocab_size)
    prefix_reqs = pool_requests(32, 768, 1536, 64, 22, cfg.vocab_size, prefix=512)
    base = cfg.fedattn
    runs = [
        ("bf16", reqs, base, {}),
        ("bf16_again", reqs, base, {}),
        ("strided_0.5", reqs, base.replace(kv_exchange_ratio=0.5, kv_selection="strided"), {}),
        ("int8", reqs, base, dict(kv_quant="int8")),
        ("fp8", reqs, base, dict(kv_quant="fp8")),
        ("spec_k4", reqs, base, dict(spec_k=4)),
        ("prefix_cache", prefix_reqs, base, dict(prefix_cache=True)),
        ("attnmass_0.5", reqs, base.replace(kv_exchange_ratio=0.5, kv_selection="attnmass"), {}),
    ]
    # warm-up: builds, CUDA context, cuBLAS handles
    ContinuousBatchingScheduler(FedAttnEngine(cfg, params), max_slots=4, capacity=512).run(
        pool_requests(4, 100, 300, 4, 20, cfg.vocab_size))
    total = 0
    fa.flash_attention_plain.calls = fd.paged_flash_decode_plain.calls = 0
    for name, rq, fed, kw in runs:
        eng = FedAttnEngine(cfg, params, fedattn=fed)
        capacity = ContinuousBatchingScheduler.capacity_for(eng, rq)
        sched = ContinuousBatchingScheduler(
            eng, max_slots=POOL_SLOTS, capacity=capacity, page_size=POOL_PAGE, **kw)
        fa.flash_attention.launches = fd.paged_flash_decode.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sched.run(rq)
        wall = time.perf_counter() - t0
        k1, k2 = fa.flash_attention.launches, fd.paged_flash_decode.launches
        ticks = sched.stats["ticks"]
        if k2 != cfg.n_layers * ticks:
            raise AssertionError(f"pool {name}: {k2} K2 launches, expected {cfg.n_layers} x {ticks}")
        if k1 == 0:
            raise AssertionError(f"pool {name}: admission prefill never launched K1")
        for r, q in zip(res, rq):
            if r.tokens.shape != (1, q.n_new) or not ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
                raise AssertionError(f"pool {name}: bad tokens {r.tokens}")
            if not (np.isfinite(r.logprobs).all() and (r.logprobs <= 0).all()):
                raise AssertionError(f"pool {name}: bad logprobs {r.logprobs}")
        st = sched.pool_stats()
        tokens = sum(r.tokens.shape[1] for r in res)
        emit("pool", run=name, arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, requests=len(rq),
             max_slots=POOL_SLOTS, page_size=POOL_PAGE, capacity=capacity, table_pages=sched._pp,
             kv_exchange_ratio=fed.kv_exchange_ratio, kv_selection=fed.kv_selection, **kw,
             wall_s=wall, tokens=tokens, tok_per_s=tokens / wall, ticks=ticks, ms_per_tick=wall / ticks * 1e3,
             ttft_p50_s=st.get("ttft_p50"), ttft_p95_s=st.get("ttft_p95"),
             tpot_p50_s=st.get("tpot_p50"), tpot_p95_s=st.get("tpot_p95"),
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             k1_launches=k1, k2_launches=k2,
             pool_stats={k: v for k, v in st.items() if k in (
                 "pool_bytes", "num_pages", "peak_resident", "peak_resident_tokens", "full_prefills",
                 "suffix_prefills", "prefill_tokens", "prefix_hits", "prefix_tokens_reused",
                 "spec_acceptance_rate", "verify_ticks", "peak_bytes_per_resident_token")},
             first_tokens=res[0].tokens[0, :8].tolist())
        total += k2
        if name == "bf16":
            bf16 = (eng, rq)
    if fa.flash_attention_plain.calls or fd.paged_flash_decode_plain.calls:
        raise AssertionError(f"pool: plain versions called {fa.flash_attention_plain.calls} (K1) and "
                             f"{fd.paged_flash_decode_plain.calls} (K2) times")
    phase_pool_trace(*bf16)
    del params, bf16, eng, sched
    torch.cuda.empty_cache()
    return total


def phase_pool_trace(eng, reqs) -> None:
    """torch.profiler over one bf16 pool run: the device's busy share and
    its top kernels (tracing slows the host: the share is a floor)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(
        eng, max_slots=POOL_SLOTS, capacity=ContinuousBatchingScheduler.capacity_for(eng, reqs),
        page_size=POOL_PAGE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run(reqs)
        wall = time.perf_counter() - t0
    emit("pool_trace", run="bf16", **kernel_summary(prof, wall))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; one CUDA card is needed",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    smi = smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    ptxas = {n: [ln.strip() for ln in (build.BUILD_DIR / f"{n}.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in ("flash_attention", "paged_flash_decode")}
    emit("build", built=built, seconds=time.perf_counter() - t0, ptxas=ptxas)

    k1_cases_out = phase_k1(device)
    k2_cases_out = phase_k2(device)
    phase_parity(device)
    k1_launches = phase_main(device)
    phase_pool_parity(device)
    k2_launches = phase_pool(device)
    phase_serve()

    k1 = next(c for c in k1_cases_out if c["name"] == "prefill_sync")
    k2 = next(c for c in k2_cases_out if c["name"] == "pool_phase2")
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:140",
        "launches": k1_launches,
        "launches_path": "main: FedAttnEngine.generate, 28 layers x 32 tokens",
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "timed_case": k1["name"], "cases": k1_cases_out,
    }, {
        "name": "paged_flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:153",
        "launches": k2_launches,
        "launches_path": "pool: ContinuousBatchingScheduler, 28 layers x ticks over its 8 runs",
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
        "library": k2["library"], "timed_case": k2["name"], "cases": k2_cases_out,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
