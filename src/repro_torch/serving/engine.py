"""FedAttn collaborative-inference engine of the port.

Port of ``FedAttnEngine.generate`` from the JAX package's
``serving/engine.py`` (§IV of the paper):

  1. **Prefill**: the participants' segments form one global sequence,
     padded to a power-of-two bucket ``Lp`` with ``PAD_SEGMENT`` tokens.
     It runs through the decode layers with ``cache_len=0`` and
     ``S_new=Lp`` against a ``Lp + Nb``-slot cache (``Nb`` the bucketed
     ``n_new``), seeding every layer's KV under the FedAttn visibility
     schedule; the LM head runs on the last real position only.
  2. **Decode**: the task publisher extends from the final global token;
     each step advances the step-0 decode template's positions.

PyTorch runs eagerly, so there is no compiled decode loop: the bucket only fixes
the cache geometry, exactly as the JAX engine's compiled path lays it out,
and decode runs the ``n_new - 1`` steps that are kept. Sampling draws from
a ``torch.Generator`` (Gumbel-max over ``logits / temperature``); JAX's
threefry keys have no torch counterpart, so sampled tokens are
deterministic per seed but not equal to JAX's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import schedule_from_config
from repro_torch.core.fedattn import FedAttnContext
from repro_torch.core.partition import Partition
from repro_torch.core.schedule import SyncSchedule
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.core import PAD_SEGMENT
from repro_torch.models import layers as LY
from repro_torch.models import transformer as T
from repro_torch.types import FedAttnConfig, ModelConfig


@dataclass
class GenerationResult:
    """Output of one ``generate`` call.

    ``logprobs[b, t]`` is the **untempered** model log-probability of the
    emitted token — ``log_softmax(logits)[token]`` at temperature 1 — even
    when the token was sampled at another temperature. Sampling is active
    only when ``temperature > 0`` AND a generator is passed; otherwise
    decoding is greedy."""

    tokens: np.ndarray  # (B, n_new)
    logprobs: Optional[np.ndarray] = None  # (B, n_new)
    prefill_comm_bytes: float = 0.0  # per-participant KV upload (paper §VII-A3)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class FedAttnEngine:
    """Greedy/sampling generation under the FedAttn protocol.

    ``device`` defaults to CUDA and raises when there is none; pass
    ``device="cpu"`` to run on the CPU. ``backend`` picks the attention
    implementation (:mod:`repro_torch.kernels.ops`): 'cuda' (the Hopper
    kernel; default on CUDA), 'torch' (default on the CPU) or 'ref'.
    ``params`` must already live on ``device``."""

    def __init__(
        self,
        config: ModelConfig,
        params,
        *,
        fedattn: Optional[FedAttnConfig] = None,
        backend: Optional[str] = None,
        bucket: str = "pow2",
        device: torch.device | str | None = None,
    ):
        if bucket not in ("pow2", "none"):
            raise ValueError(f"unknown bucket policy {bucket!r}")
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.fed = fedattn if fedattn is not None else config.fedattn
        if self.fed.kv_quant != "none":
            raise NotImplementedError("quantized KV exchange is not ported yet")
        self.model = T.TransformerLM(config)
        self.backend = backend or ops.default_backend(self.device)
        if self.backend not in ops.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; options: {ops.BACKENDS}")
        self.bucket = bucket
        self._schedule = self._build_schedule()
        # bucketing L pads the prefill with PAD_SEGMENT tokens, which only a
        # causal stack keeps out of every real query's view
        self._bucket_L_ok = self.fed.causal

    # -- protocol setup ---------------------------------------------------------

    def _build_schedule(self) -> SyncSchedule:
        sched = schedule_from_config(self.config)
        if self.fed.schedule != "uniform":
            sched = SyncSchedule.by_name(
                self.fed.schedule, self.config.n_layers, interval=self.fed.sync_interval,
            )
        elif sched.n_syncs == 0:
            # no structural sync flags: 'uniform' means every H-th layer
            sched = SyncSchedule.uniform(self.config.n_layers, self.fed.sync_interval)
        return sched

    def build_context(
        self,
        seq_len: int,
        *,
        partition: Optional[Partition] = None,
        generator: Optional[torch.Generator] = None,
    ) -> FedAttnContext:
        return FedAttnContext.build(
            self.fed, self.config.n_layers, seq_len,
            partition=partition or Partition.contiguous(seq_len, self.fed.n_participants),
            schedule=self._schedule, generator=generator, device=self.device,
        )

    def _bucket_len(self, L: int) -> int:
        if self.bucket == "pow2" and self._bucket_L_ok:
            return _next_pow2(L)
        return L

    def _bucket_new(self, n_new: int) -> int:
        return _next_pow2(n_new) if self.bucket == "pow2" else n_new

    # -- generation ---------------------------------------------------------------

    def generate(
        self,
        tokens,  # (B, L) global input sequence (assembled), tensor or array
        n_new: int,
        *,
        partition: Optional[Partition] = None,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> GenerationResult:
        """Prefill the prompt and decode ``n_new`` tokens. ``generator``
        draws the 'random' sparse-exchange masks and, with
        ``temperature > 0``, the samples."""
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        tokens = torch.as_tensor(tokens, device=self.device)
        B, L = tokens.shape
        ctx = self.build_context(L, partition=partition, generator=generator)
        Lp, Nb = self._bucket_len(L), self._bucket_new(n_new)
        capacity = Lp + Nb
        cache = self.model.init_cache(B, capacity, device=self.device)
        last = self._prefill(tokens, ctx, cache, L, Lp, capacity)
        tok = self._sample(last, temperature, generator)
        toks, lps = [tok], [_token_logprob(last, tok)]
        if n_new > 1:  # a single-token request ends at the prefill
            dctx0 = ctx.decode_template(capacity)
            for step in range(n_new - 1):
                dctx = dataclasses.replace(dctx0, positions=dctx0.positions + step)
                logits = self.model.decode_step(
                    self.params, cache, tok[:, None], L + step, ctx, step=step,
                    backend=self.backend, dctx=dctx,
                )
                last = logits[:, -1]
                tok = self._sample(last, temperature, generator)
                toks.append(tok)
                lps.append(_token_logprob(last, tok))
        comm = ctx.comm_bytes_per_participant(self.config.n_kv_heads, self.config.head_dim)
        return GenerationResult(
            tokens=torch.stack(toks, dim=1).cpu().numpy(),
            logprobs=torch.stack(lps, dim=1).cpu().numpy(),
            prefill_comm_bytes=comm,
        )

    # -- prefill ------------------------------------------------------------------

    def _layer_contrib(self, ctx: FedAttnContext, layer: int, capacity: int):
        """This layer's sparse-exchange row, padded to the cache capacity
        (None at local layers / full exchange)."""
        if ctx.contributed is None or not self._schedule.is_sync(layer):
            return None
        row = ctx.contributed[ctx._round_of_layer(layer) % ctx.contributed.shape[0]]
        return F.pad(row, (0, capacity - row.shape[0]), value=False)

    def _prefill(self, tokens, ctx, cache, L: int, Lp: int, capacity: int) -> torch.Tensor:
        """Bucketed prefill via bulk decode-writes (``cache_len=0``,
        ``S_new=Lp``); returns the last real position's logits (B, V)."""
        pad = Lp - L
        if pad:
            tokens = F.pad(tokens, (0, pad))
        dctx = dataclasses.replace(
            ctx.for_decode_step(capacity, 0),
            positions=torch.arange(Lp, dtype=torch.int32, device=self.device),
            segments=F.pad(ctx.segments, (0, pad), value=PAD_SEGMENT),
            contributed=None,
        )
        cfg = self.config
        x = self.model._embed(self.params, tokens)
        for m, (p, spec) in enumerate(zip(self.params["layers"], cfg.layer_specs())):
            x = T.apply_layer_decode(
                p, cache[m], x, 0, dctx, m, spec, cfg, backend=self.backend,
                contributed=self._layer_contrib(ctx, m, capacity),
            )
        x = LY.apply_norm(self.params["final_norm"], x[:, L - 1:L], cfg)
        return LY.apply_lm_head(self.params["head"], self.params["embed"], x, cfg)[:, 0]

    def _sample(self, logits: torch.Tensor, temperature: float, generator) -> torch.Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=generator, device=generator.device)
        u = u.to(logits.device).clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(logits.to(torch.float32) / temperature - torch.log(-torch.log(u)), dim=-1)


def _token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(B,) log p(tok | prefix) under the model's (untempered) softmax."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, 1, tok[:, None])[:, 0]
