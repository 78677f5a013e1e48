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
  main     the main path: full 28-layer Qwen2.5-7B in bf16, random weights,
           ``FedAttnEngine.generate`` with B=4, L=1000, n_new=32, N=4, H=4,
           full and 0.5-strided KV exchange, twice each, launch counts
           asserted; then one traced call (device busy share, top kernels)
  serve    ``repro_torch.launch.serve.main`` once on the card

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``.
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
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores
F32_TOL = 2e-5  # f32: the kernel and its plain version differ by summation order only
# bf16: both sides compute in f32 and round once, so each element may differ
# by one bf16 ulp of its expected value; the floor covers f32 summation noise
# on outputs near 0, where that ulp is tiny
BF16_ATOL_FLOOR = 2.0**-14
PARITY_LOGPROB_ATOL = 1e-3  # f32 end to end through 4 full-width layers and the head


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


def k1_library(q, k, v, kw):
    """One PyTorch call computing K1's function, timed as a yardstick only:
    SDPA with K1's boolean mask, or, with a logit soft-cap (which SDPA
    lacks), compiled ``flex_attention`` with the cap as its score_mod and
    the mask as its block mask. Returns the call."""
    import torch
    import torch.nn.functional as F

    vis = k1_visibility(kw)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kw.get("soft_cap") is None:
        g = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis[:, None])
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    cap = float(kw["soft_cap"])
    row = (lambda b: b) if vis.shape[0] > 1 else (lambda b: 0)

    def mask_mod(b, h, q_idx, kv_idx):
        return vis[row(b), q_idx, kv_idx]

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap

    block_mask = create_block_mask(mask_mod, vis.shape[0] if vis.shape[0] > 1 else None, None,
                                   q.shape[1], k.shape[1], device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)


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
    for rnd in range(2):  # alternate the two runs twice: the spread shows
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
    emit("trace", run="full", traced_wall_s=wall, device_kernel_s=device_s,
         device_busy_share=device_s / wall,
         top=[dict(name=key[:100], ms=us / 1e3, count=count) for us, count, key in rows[:10]])


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

    t0 = time.perf_counter()
    serve.main(["--arch", "qwen2-7b", "--device", "cuda", "--n-new", "8"])
    emit("serve", arch="qwen2-7b (reduced)", seconds=time.perf_counter() - t0)


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
    ptxas = [ln.strip() for ln in (build.BUILD_DIR / "flash_attention.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", built=built, seconds=time.perf_counter() - t0, ptxas=ptxas)

    cases = phase_k1(device)
    phase_parity(device)
    launches = phase_main(device)
    phase_serve()

    top = next(c for c in cases if c["name"] == "prefill_sync")
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:140",
        "launches": launches,
        "max_abs_err": top["max_abs_err"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "timed_case": top["name"],
        "cases": cases,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
