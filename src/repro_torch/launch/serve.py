"""Serving launcher of the port — collaborative FedAttn inference.

N participants hold private token segments of one prompt; the engine runs
the FedAttn prefill (periodic KV exchange per the schedule) and the
publisher decodes the answer. Reduced configs with random weights made
from ``--seed``; runs on CUDA unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --participants 4 --sync-interval 2 --kv-ratio 0.5 --n-new 16
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_reduced_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import FedAttnEngine
from repro_torch.types import FedAttnConfig


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
    )
    gen = lambda offset: torch.Generator(device=device).manual_seed(args.seed + offset)
    params = TransformerLM(config).init(gen(0))
    engine = FedAttnEngine(config, params, fedattn=fed, bucket=args.bucket, device=device)
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
