"""FedAttn collaborative-inference engine of the port.

Port of ``FedAttnEngine`` from the JAX package's ``serving/engine.py`` (§IV
of the paper):

  1. **Prefill**: the participants' segments form one global sequence,
     padded to a power-of-two bucket ``Lp`` with ``PAD_SEGMENT`` tokens.
     It runs through the decode layers with ``cache_len=0`` and
     ``S_new=Lp`` against a ``Lp + Nb``-slot cache (``Nb`` the bucketed
     ``n_new``), seeding every layer's KV under the FedAttn visibility
     schedule; the LM head runs on the last real position only.
  2. **Decode**: the task publisher extends from the final global token;
     each step advances the step-0 decode template's positions.

PyTorch runs eagerly, so there is no compiled decode loop: the bucket only
fixes the cache geometry, exactly as the JAX engine's compiled path lays it
out, and decode runs the ``n_new - 1`` steps that are kept. Many requests
at once go through :meth:`FedAttnEngine.generate_many` and the
continuous-batching pool (:mod:`repro_torch.serving.scheduler`), which
reuses this engine's per-row prefill (:meth:`FedAttnEngine._prefill_rows`).

Sampling (:func:`sample`): Gumbel-max over ``logits / temperature`` whose
noise for token ``m`` of batch row ``b`` is a counter-based hash of (the
generator's seed, ``b``, ``m``, vocabulary index) — it depends on nothing
else, so the pool, a speculative verify (a rejected draft costs no draw)
and ``generate`` draw the same token at the same point, on the CPU and on
the card alike. JAX's threefry bits have no torch counterpart, so sampled
tokens are deterministic per seed but not equal to JAX's.
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
from repro_torch.serving import quant
from repro_torch.types import FedAttnConfig, ModelConfig


@dataclass
class GenerationResult:
    """Output of one ``generate`` call.

    ``logprobs[b, t]`` is the **untempered** model log-probability of the
    emitted token — ``log_softmax(logits)[token]`` at temperature 1 — even
    when the token was sampled at another temperature. Sampling is active
    only when ``temperature > 0`` AND a generator is passed; otherwise
    decoding is greedy. The pool (:mod:`repro_torch.serving.scheduler`)
    returns one of these per request, with B = 1."""

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
    ``params`` must already live on ``device``.

    ``kv_quant`` ('int8' / 'fp8') overrides ``fedattn.kv_quant``: the
    pool of :meth:`generate_many` stores int8/fp8 codes with per-page
    scales, and the exchange byte count charges compressed rows."""

    def __init__(
        self,
        config: ModelConfig,
        params,
        *,
        fedattn: Optional[FedAttnConfig] = None,
        backend: Optional[str] = None,
        bucket: str = "pow2",
        device: torch.device | str | None = None,
        kv_quant: Optional[str] = None,
    ):
        if bucket not in ("pow2", "none"):
            raise ValueError(f"unknown bucket policy {bucket!r}")
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.fed = fedattn if fedattn is not None else config.fedattn
        if kv_quant is not None:
            self.fed = self.fed.replace(kv_quant=kv_quant)
        quant.storage_dtype(self.fed.kv_quant)  # validates the mode
        self.kv_quant = None if self.fed.kv_quant == "none" else self.fed.kv_quant
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
        ``temperature > 0``, seeds the sampler."""
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        tokens = torch.as_tensor(tokens, device=self.device)
        B, L = tokens.shape
        ctx = self.build_context(L, partition=partition, generator=generator)
        Lp, Nb = self._bucket_len(L), self._bucket_new(n_new)
        capacity = Lp + Nb
        cache = self.model.init_cache(B, capacity, device=self.device)
        last = self._prefill(tokens, ctx, cache, L, Lp, capacity)
        draw = _Draws.of(B, temperature, generator, self.device)
        tok = draw(last, 0)
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
                tok = draw(last, step + 1)
                toks.append(tok)
                lps.append(_token_logprob(last, tok))
        comm = ctx.comm_bytes_per_participant(self.config.n_kv_heads, self.config.head_dim)
        return GenerationResult(
            tokens=torch.stack(toks, dim=1).cpu().numpy(),
            logprobs=torch.stack(lps, dim=1).cpu().numpy(),
            prefill_comm_bytes=comm,
        )

    def generate_many(
        self,
        requests,  # Sequence[repro_torch.serving.scheduler.Request]
        *,
        max_slots: int = 8,
        capacity: Optional[int] = None,
        steps_per_admit: int = 1,
        arrival_times=None,
        **scheduler_kwargs,
    ) -> list:
        """Serve many single-sequence requests through the continuous-
        batching pool (:class:`repro_torch.serving.scheduler.
        ContinuousBatchingScheduler`). ``capacity=None`` sizes the slots
        for the largest request (``capacity_for``); ``arrival_times`` are
        perf_counter offsets from the call. Returns results in request
        order."""
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler

        if capacity is None:
            capacity = ContinuousBatchingScheduler.capacity_for(self, requests)
        sched = ContinuousBatchingScheduler(
            self, max_slots=max_slots, capacity=capacity,
            steps_per_admit=steps_per_admit, **scheduler_kwargs,
        )
        return sched.run(requests, arrival_times=arrival_times)

    # -- prefill ------------------------------------------------------------------

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
        contrib = None
        if ctx.contributed is not None:
            contrib = F.pad(ctx.contributed, (0, capacity - ctx.contributed.shape[1]), value=False)
        x = self._prefill_layers(cache, tokens, dctx, 0, contrib)
        return self._head(x[:, L - 1:L])

    def _prefill_rows(
        self, cache, tokens, real_len, q_seg, kv_seg, contributed=None, *, write_lo=None,
    ) -> torch.Tensor:
        """Per-row prefill of a coalesced admission batch (the JAX engine's
        ``_prefill_fn(per_row=True)`` and, with ``write_lo``,
        ``_suffix_prefill_fn``): every row is its own request.

        ``tokens`` (B, Lp), ``real_len`` (B,) each row's true length,
        ``q_seg`` (B, Lp) and ``kv_seg`` (B, C) per-row segments,
        ``contributed`` (B, rounds, C) per-row exchange masks or None.
        ``write_lo`` (B,) — the suffix prefill of prefix-cache hits — writes
        and positions each row from its own frontier into a cache already
        holding the prefix. Returns the logits of each row's last real
        position (B, V); ``cache`` is seeded in place."""
        B, Lp = tokens.shape
        C = kv_seg.shape[1]
        dev = self.device
        ar = torch.arange(Lp, dtype=torch.int32, device=dev)
        q_pos = ar if write_lo is None else write_lo[:, None] + ar[None, :]
        dctx = dataclasses.replace(
            self._proto_ctx(C), positions=q_pos, segments=q_seg,
            kv_positions=torch.arange(C, dtype=torch.int32, device=dev), kv_segments=kv_seg,
        )
        rows = None if contributed is None else contributed.transpose(0, 1)  # rounds-first
        x = self._prefill_layers(cache, tokens, dctx, 0 if write_lo is None else write_lo, rows)
        last = torch.gather(x, 1, (real_len.long() - 1)[:, None, None].expand(B, 1, x.shape[2]))
        return self._head(last)

    def _prefill_layers(self, cache, tokens, dctx, cache_len, contrib_rows):
        """Run the decode layers over a whole prompt block; ``contrib_rows``
        are the per-round exchange rows, (rounds, C) or (rounds, B, C)."""
        cfg = self.config
        x = self.model._embed(self.params, tokens)
        for m, (p, spec) in enumerate(zip(self.params["layers"], cfg.layer_specs())):
            row = None
            if contrib_rows is not None and self._schedule.is_sync(m):
                row = contrib_rows[dctx._round_of_layer(m) % contrib_rows.shape[0]]
            x = T.apply_layer_decode(
                p, cache[m], x, cache_len, dctx, m, spec, cfg, backend=self.backend,
                contributed=row,
            )
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and LM head of a (B, 1, D) block → (B, V) logits."""
        x = LY.apply_norm(self.params["final_norm"], x, self.config)
        return LY.apply_lm_head(self.params["head"], self.params["embed"], x, self.config)[:, 0]

    def _proto_ctx(self, capacity: int) -> FedAttnContext:
        """A decode-shaped context carrying the engine's config and
        schedule; callers replace every tensor field."""
        ctx = FedAttnContext.build(
            self.fed.replace(kv_exchange_ratio=1.0), self.config.n_layers, capacity,
            schedule=self._schedule, device=self.device,
        )
        return dataclasses.replace(ctx.decode_template(capacity), config=self.fed)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32), without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (the 'lowbias32' mixer) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniforms(seeds: torch.Tensor, rows: torch.Tensor, steps: torch.Tensor, V: int) -> torch.Tensor:
    """(N, V) f32 uniforms in (0, 1), each a hash of (seed, row, step,
    vocabulary index) alone; ``seeds``/``rows``/``steps`` are (N,) int64."""
    key = _mix32((seeds & _M32) ^ _mix32(((seeds >> 32) & _M32) ^ _mix32(rows & _M32)))
    key = _mix32(key ^ _mix32(steps & _M32))
    col = _mix32(torch.arange(V, dtype=torch.int64, device=seeds.device) + 0x9E3779B9 & _M32)
    h = _mix32(key[:, None] ^ col[None, :])
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample(logits, temps, seeds, rows, steps, sampled) -> torch.Tensor:
    """Next tokens for logits (..., V): rows where ``sampled`` is True draw
    Gumbel-max from ``logits / temps`` with the noise of (seed, row, step);
    the others take the raw-logit argmax. ``temps``, ``seeds``, ``rows``,
    ``steps`` and ``sampled`` have the leading shape of ``logits``."""
    greedy = torch.argmax(logits, dim=-1)
    if not bool(sampled.any()):
        return greedy
    lead, V = logits.shape[:-1], logits.shape[-1]
    flat = lambda t: t.reshape(-1).to(logits.device)
    u = _uniforms(flat(seeds).long(), flat(rows).long(), flat(steps).long(), V)
    gumbel = -torch.log(-torch.log(u))
    z = logits.reshape(-1, V).to(torch.float32) / flat(temps).to(torch.float32)[:, None] + gumbel
    return torch.where(sampled.to(logits.device), torch.argmax(z, dim=-1).reshape(lead), greedy)


@dataclass
class _Draws:
    """The sampling state of one ``generate`` call: every row shares the
    generator's seed and is told apart by its row index."""

    temps: torch.Tensor
    seeds: torch.Tensor
    rows: torch.Tensor
    sampled: torch.Tensor

    @staticmethod
    def of(B: int, temperature: float, generator, device) -> "_Draws":
        on = temperature > 0.0 and generator is not None
        seed = generator.initial_seed() if on else 0
        return _Draws(
            temps=torch.full((B,), max(temperature, 1e-6), device=device),
            seeds=torch.full((B,), _signed64(seed), dtype=torch.int64, device=device),
            rows=torch.arange(B, device=device),
            sampled=torch.full((B,), on, device=device),
        )

    def __call__(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        steps = torch.full_like(self.rows, step)
        return sample(logits, self.temps, self.seeds, self.rows, steps, self.sampled)


def _signed64(seed: int) -> int:
    """A 64-bit seed as the int64 torch stores (two's complement)."""
    seed &= (1 << 64) - 1
    return seed - (1 << 64) if seed >= 1 << 63 else seed


def verify_candidates(logits, draft, temps, seeds, fold, sampled):
    """Candidate tokens and accept lengths of a speculative verify tick.

    ``logits`` (S, k+1, V) from one multi-token forward over the block
    ``[last_tok, d_1 .. d_k]``; row ``i`` scores the token that follows the
    prefix extended by ``d_1..d_i``. ``cand[s, i]`` is the token the
    non-speculative schedule would emit there: greedy rows the argmax,
    sampled rows the draw of step ``fold[s] + i`` — the same per-token noise
    as the pool's step and ``generate``, which makes token-exact acceptance
    lossless for sampled streams too. ``accept[s]`` counts the leading draft
    tokens equal to their candidate; ``lps`` are the untempered logprobs of
    every candidate."""
    S, k1, _ = logits.shape
    dev = logits.device
    steps = fold[:, None] + torch.arange(k1, device=dev)[None, :]
    ex = lambda t: t[:, None].expand(S, k1)
    cand = sample(logits, ex(temps), ex(seeds), torch.zeros_like(steps), steps, ex(sampled))
    match = (draft == cand[:, :-1]).to(torch.int32)
    accept = torch.cumprod(match, dim=1).sum(dim=1)
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    lps = torch.gather(lp, -1, cand[..., None])[..., 0]
    return cand, lps, accept


def _token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(B,) log p(tok | prefix) under the model's (untempered) softmax."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, 1, tok[:, None])[:, 0]
