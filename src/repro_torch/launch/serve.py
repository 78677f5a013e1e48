"""Serving launcher of the port — collaborative FedAttn inference.

N participants hold private token segments of one prompt; the engine runs
the FedAttn prefill (periodic KV exchange per the schedule) and the
publisher decodes the answer. Reduced configs with random weights made
from ``--seed``; runs on CUDA unless ``--device cpu``.

Streaming mode: ``--stream`` feeds a Poisson arrival trace of
mixed-length requests through the continuous-batching pool
(:mod:`repro_torch.serving.scheduler`): a paged KV pool of ``--max-slots``
slots, one pooled decode step per tick for every in-flight request, new
admissions landing mid-flight. It prints aggregate tok/s and the TTFT/TPOT
percentiles.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --participants 4 --sync-interval 2 --kv-ratio 0.5 --n-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --stream \
      --stream-requests 16 --arrival-rate 4 --max-slots 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_reduced_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import FedAttnEngine
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.types import FedAttnConfig


def poisson_trace(
    rng: np.random.Generator,
    n_requests: int,
    *,
    vocab_size: int,
    max_len: int,
    max_new: int,
    rate_per_s: float,
    temperature: float = 0.0,
) -> tuple[list[Request], list[float]]:
    """Mixed-length requests with exponential inter-arrival gaps: prompt
    lengths uniform in [max_len/4, max_len], n_new in [max_new/4, max_new];
    sampled requests get a generator seeded ``1000 + i``."""
    reqs, arrivals, t = [], [], 0.0
    for i in range(n_requests):
        L = int(rng.integers(max(4, max_len // 4), max_len + 1))
        n_new = int(rng.integers(max(2, max_new // 4), max_new + 1))
        toks = rng.integers(3, vocab_size, size=(L,))
        sample = temperature > 0.0
        reqs.append(Request(
            tokens=toks.astype(np.int64), n_new=n_new, temperature=temperature,
            generator=torch.Generator().manual_seed(1000 + i) if sample else None,
        ))
        arrivals.append(t)
        t += float(rng.exponential(1.0 / rate_per_s))
    return reqs, arrivals


def run_stream(engine: FedAttnEngine, config, args) -> dict:
    """Serve a Poisson trace through the pool once to warm up (kernel
    build, CUDA context), then once timed; prints and returns the pool's
    stats with the timed pass's throughput."""
    rng = np.random.default_rng(args.seed)
    reqs, arrivals = poisson_trace(
        rng, args.stream_requests, vocab_size=config.vocab_size, max_len=args.seq_len,
        max_new=args.n_new, rate_per_s=args.arrival_rate,
    )
    capacity = ContinuousBatchingScheduler.capacity_for(engine, reqs)
    steps_per_admit = 1 if args.spec_k > 0 else args.steps_per_admit
    sched = ContinuousBatchingScheduler(
        engine, max_slots=args.max_slots, capacity=capacity,
        steps_per_admit=steps_per_admit, prefix_cache=args.prefix_cache,
        spec_k=args.spec_k,
    )
    sched.run(reqs)
    sched.latency_stats(reset=True)  # the timed pass gets its own percentiles
    t0 = time.perf_counter()
    results = sched.run(reqs, arrival_times=arrivals)
    wall = time.perf_counter() - t0
    total = sum(r.tokens.shape[1] for r in results)
    st = sched.pool_stats()
    print(f"stream: {len(reqs)} requests (Poisson rate {args.arrival_rate}/s), "
          f"pool {args.max_slots} slots x {capacity} positions, "
          f"steps_per_admit={steps_per_admit}"
          + (f", spec_k={args.spec_k}" if args.spec_k else "")
          + (f", kv_quant={args.kv_quant}" if args.kv_quant != "none" else "")
          + f", backend={engine.backend} on {engine.device}")
    prefix = ""
    if args.prefix_cache:
        hits, misses = st["prefix_hits"], st["prefix_misses"]
        prefix = (f", prefix hit-rate {hits / max(1, hits + misses):.0%} "
                  f"({st['prefix_tokens_reused']} prompt tokens reused)")
    print(f"aggregate decode throughput: {total / wall:,.1f} tok/s "
          f"({total} tokens / {wall:.2f}s wall incl. arrivals){prefix}")
    if st.get("tpot_n"):
        print(f"per-request latency: ttft p50 {st['ttft_p50'] * 1e3:.1f} ms / "
              f"p95 {st['ttft_p95'] * 1e3:.1f} ms; tpot p50 "
              f"{st['tpot_p50'] * 1e3:.2f} ms/tok / p95 {st['tpot_p95'] * 1e3:.2f} ms/tok")
    if args.spec_k:
        print(f"speculation: acceptance rate {st['spec_acceptance_rate']:.0%} "
              f"({st['spec_accepted']}/{st['spec_drafted']} draft tokens over "
              f"{st['verify_ticks']} verify ticks)")
    return dict(st, tok_per_s=total / wall, wall_s=wall, tokens=total)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), default="qwen2-7b")
    ap.add_argument("--participants", type=int, default=4)
    ap.add_argument("--sync-interval", type=int, default=2)
    ap.add_argument("--schedule", default="uniform")
    ap.add_argument("--kv-ratio", type=float, default=1.0)
    ap.add_argument("--kv-selection", default="random")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--n-new", type=int, default=8)
    ap.add_argument("--bucket", choices=["pow2", "none"], default="pow2",
                    help="'pow2' pads L and n-new up to power-of-two buckets "
                         "(the cache geometry of the JAX engine); 'none' "
                         "uses the exact shapes")
    ap.add_argument("--kv-quant", choices=["none", "int8", "fp8"], default="none",
                    help="--stream: the paged pool stores int8/fp8 codes with "
                         "per-page-per-head scales; the exchange byte count "
                         "charges compressed rows")
    ap.add_argument("--stream", action="store_true",
                    help="continuous-batching mode: a Poisson trace of "
                         "mixed-length requests through the paged KV pool")
    ap.add_argument("--stream-requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="--stream Poisson arrival rate (requests/s)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="--stream pool slots (concurrent requests)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="--stream: share cached prompt prefixes (copy-on-write pages)")
    ap.add_argument("--steps-per-admit", type=int, default=4,
                    help="--stream decode sub-steps per tick between admissions")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="--stream speculative decoding: draft K tokens per slot "
                         "per tick (n-gram drafter) and verify them in one "
                         "forward (forces steps_per_admit=1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    config = get_reduced_config(args.arch)
    fed = FedAttnConfig(
        n_participants=args.participants,
        sync_interval=args.sync_interval,
        schedule=args.schedule,
        kv_exchange_ratio=args.kv_ratio,
        kv_selection=args.kv_selection,
        kv_quant=args.kv_quant,
    )
    gen = lambda offset: torch.Generator(device=device).manual_seed(args.seed + offset)
    params = TransformerLM(config).init(gen(0))
    engine = FedAttnEngine(config, params, fedattn=fed, bucket=args.bucket, device=device)
    if args.stream:
        run_stream(engine, config, args)
        return
    tokens = torch.randint(
        3, config.vocab_size, (args.batch, args.seq_len), generator=gen(1), device=device,
    )
    # warm-up call: the timed call below measures steady state (kernel
    # build and load, CUDA context and library handles happen here)
    engine.generate(tokens, args.n_new, generator=gen(3))
    t0 = time.perf_counter()
    res = engine.generate(tokens, args.n_new, generator=gen(3))
    dt = time.perf_counter() - t0
    print(f"arch={config.name} N={args.participants} H={args.sync_interval} "
          f"schedule={args.schedule} kv_ratio={args.kv_ratio} "
          f"backend={engine.backend} bucket={args.bucket} device={device}")
    print("generated tokens:\n", res.tokens)
    print("mean token logprob:", float(res.logprobs.mean()))
    print(f"decode throughput: {args.n_new * args.batch / dt:,.1f} tok/s "
          f"(batch x n_new / wall, prefill included, on {device})")
    print(f"prefill KV upload per participant: {res.prefill_comm_bytes:,.0f} bytes")


if __name__ == "__main__":
    main()
